"""Port parity: the plain versions of the two packed kernels
(``repro_torch.kernels.rbd_step``) and the public packed projector
against the reference's jnp oracles and, on a tiny layout, its
interpret-mode Pallas kernels.

Tolerances.  Basis samples are bit-exact except ``normal`` (ulp-level,
see test_torch_rng.py), but every sum runs in another order than XLA's:
* u: |du_k| <= 1e-5 * ||g_seg|| * sqrt(sq_k / Q_seg), the typical size of
  u_k for a random basis (float32 sums of up to ~2000 terms);
* sq: rtol 1e-6 -- and bit-exact for rademacher/bernoulli, whose squares
  are exactly 1 and sum exactly;
* theta: |dtheta| <= 1e-5 * max|update| + 2 ulp of max|theta|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.core import rng as ref_rng
from repro.kernels import rbd_step as ref_kernels
from repro_torch.core import compartments, projector, rng
from repro_torch.kernels import rbd_step

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

DISTS = ["normal", "uniform", "bernoulli", "rademacher", "sparse"]
NORMS = ["rsqrt_dim", "exact", "none"]
PB, DB = 128, 8
EPS32 = 2.0 ** -23


def _shapes():
    # ragged: 73 and 700 do not divide PB; "layers/k" is stacked; "s" is a
    # 1-element compartment; 200 directions give several dir-blocks
    return {"w": (64, 32), "layers/k": (3, 40, 10), "s": (), "odd": (7, 73),
            "long": (700,)}


def _plans(dist="normal", norm="rsqrt_dim", shapes=None, dim=200):
    shapes = shapes or _shapes()
    stacked = lambda n: n.startswith("layers")  # noqa: E731
    ref_tree = {}
    for name, shape in shapes.items():
        node = ref_tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    kw = dict(is_stacked=stacked, distribution=dist, normalization=norm)
    return (ref_comp.make_plan(ref_tree, dim, **kw),
            compartments.make_plan(shapes, dim, **kw))


def _packed_inputs(layout, seed=0):
    rs = np.random.default_rng(seed)
    valid = np.zeros(layout.q_packed, bool)
    for off, size in zip(layout.seg_param_off, layout.seg_size):
        valid[off: off + size] = True
    g = np.where(valid, rs.standard_normal(layout.q_packed), 0).astype(
        np.float32)
    theta = np.where(valid, rs.standard_normal(layout.q_packed), 0).astype(
        np.float32)
    scale = (rs.standard_normal(layout.d_packed) * 1e-2
             * layout.coord_valid).astype(np.float32)
    return g, theta, scale, valid


def _assert_u_close(u, want_u, sq, g, layout):
    scale = np.zeros(layout.d_packed, np.float64)
    for s in range(layout.n_segments):
        o, q = layout.seg_param_off[s], layout.seg_size[s]
        c, n = layout.seg_coord_off[s], layout.seg_pdim[s]
        scale[c: c + n] = np.linalg.norm(g[o: o + q]) * np.sqrt(
            sq[c: c + n] / q)
    assert (np.abs(u - want_u) <= 1e-5 * scale).all(), np.max(
        np.abs(u - want_u) / np.maximum(scale, 1e-30))


def _assert_theta_close(got, want, theta):
    upd = np.abs(want - theta).max()
    tol = 1e-5 * upd + 2 * EPS32 * np.abs(theta).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dist", DISTS)
def test_plain_kernels_vs_reference_oracles(dist):
    ref_plan, plan = _plans(dist)
    rl, layout = ref_plan.packed(PB, DB), plan.packed(PB, DB)
    g, theta, scale, valid = _packed_inputs(layout)
    seeds = projector.segment_seeds(plan, rng.fold_seed(3))
    ref_seeds = ref_proj.segment_seeds(ref_plan, ref_rng.fold_seed(3))

    want_u, want_sq = map(np.asarray, ref_proj._project_packed_jnp(
        ref_seeds, jnp.asarray(g), rl, dist))
    u, sq = rbd_step.project_packed_plain(seeds, torch.from_numpy(g),
                                          layout, dist)
    _assert_u_close(u.numpy(), want_u, want_sq, g, layout)
    if dist in ("rademacher", "bernoulli"):
        np.testing.assert_array_equal(sq.numpy(), want_sq)
    else:
        np.testing.assert_allclose(sq.numpy(), want_sq, rtol=1e-6)

    want = np.asarray(ref_proj._reconstruct_apply_packed_jnp(
        ref_seeds, jnp.asarray(scale), jnp.asarray(theta), rl, dist))
    got = rbd_step.reconstruct_apply_packed_plain(
        seeds, torch.from_numpy(scale), torch.from_numpy(theta), layout,
        dist).numpy()
    _assert_theta_close(got, want, theta)
    # the zero padding of a resident theta stays exactly zero
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("dist", ["normal", "sparse"])
def test_public_packed_api_vs_reference(dist, norm):
    ref_plan, plan = _plans(dist, norm)
    rl, layout = ref_plan.packed(PB, DB), plan.packed(PB, DB)
    g, theta, _, valid = _packed_inputs(layout, seed=1)
    c_ref, sq_ref = map(np.array, ref_proj.project_packed(
        jnp.asarray(g), ref_plan, ref_rng.fold_seed(9), layout=rl,
        return_norms=True, prepacked=True))
    c, sq = projector.project_packed(
        torch.from_numpy(g), plan, rng.fold_seed(9), layout=layout,
        return_norms=True, prepacked=True)
    factor = np.asarray(ref_proj.packed_norm_factor(ref_plan, rl, sq_ref))
    np.testing.assert_allclose(
        projector.packed_norm_factor(plan, layout, sq).numpy(), factor,
        rtol=1e-6)
    scale = np.zeros(layout.d_packed)
    for s in range(layout.n_segments):
        o, q = layout.seg_param_off[s], layout.seg_size[s]
        cs, n = layout.seg_coord_off[s], layout.seg_pdim[s]
        scale[cs: cs + n] = np.linalg.norm(g[o: o + q]) * np.sqrt(
            sq_ref[cs: cs + n] / q) * np.abs(factor[cs: cs + n])
    assert (np.abs(c.numpy() - c_ref) <= 1e-5 * scale + 1e-7).all()

    # apply the reference's coordinates through both packages
    new_ref = np.asarray(ref_proj.reconstruct_apply_packed(
        jnp.asarray(c_ref), ref_plan, ref_rng.fold_seed(9),
        jnp.asarray(theta), 0.25, row_sq=jnp.asarray(sq_ref), layout=rl,
        prepacked=True))
    new = projector.reconstruct_apply_packed(
        torch.from_numpy(c_ref), plan, rng.fold_seed(9),
        torch.from_numpy(theta), 0.25, row_sq=torch.from_numpy(sq_ref),
        layout=layout, prepacked=True).numpy()
    _assert_theta_close(new, new_ref, theta)
    assert (new[~valid] == 0).all()


def test_tree_api_regenerates_exact_norms():
    """'exact' without row_sq regenerates the norms with a zero-gradient
    projection; the parameter-map path packs and unpacks."""
    ref_plan, plan = _plans("normal", "exact")
    rs = np.random.default_rng(2)
    named = {k: rs.standard_normal(s).astype(np.float32)
             for k, s in _shapes().items()}
    coords = (rs.standard_normal(plan.packed().d_packed)
              * plan.packed().coord_valid).astype(np.float32)
    tree = {"w": named["w"], "layers": {"k": named["layers/k"]},
            "s": named["s"], "odd": named["odd"], "long": named["long"]}
    want = ref_proj.reconstruct_apply_packed(
        jnp.asarray(coords), ref_plan, ref_rng.fold_seed(1),
        jax.tree_util.tree_map(jnp.asarray, tree), 0.5)
    got = projector.reconstruct_apply_packed(
        torch.from_numpy(coords), plan, rng.fold_seed(1),
        {k: torch.from_numpy(v) for k, v in named.items()}, 0.5)
    for name, ref_leaf in [("w", want["w"]), ("layers/k", want["layers"]["k"]),
                           ("s", want["s"]), ("odd", want["odd"]),
                           ("long", want["long"])]:
        assert got[name].shape == tuple(ref_leaf.shape)
        _assert_theta_close(got[name].numpy(), np.asarray(ref_leaf),
                            named[name])


@pytest.mark.parametrize("dist", ["normal", "rademacher"])
def test_plain_vs_interpret_mode_pallas(dist):
    """A handful of tiles through the reference's Pallas kernels in
    interpret mode."""
    shapes = {"a": (2, 50), "b": (130,)}
    ref_plan, plan = _plans(dist, shapes=shapes, dim=12)
    rl, layout = ref_plan.packed(PB, DB), plan.packed(PB, DB)
    assert layout.n_proj_tiles <= 4
    g, theta, scale, _ = _packed_inputs(layout, seed=3)
    ref_seeds = ref_proj.segment_seeds(ref_plan, ref_rng.fold_seed(4))
    seeds = projector.segment_seeds(plan, rng.fold_seed(4))
    want_u, want_sq = map(np.asarray, ref_kernels.project_packed(
        ref_seeds, jnp.asarray(g), rl, dist, interpret=True))
    u, sq = rbd_step.project_packed_plain(seeds, torch.from_numpy(g),
                                          layout, dist)
    _assert_u_close(u.numpy(), want_u, want_sq, g, layout)
    np.testing.assert_allclose(sq.numpy(), want_sq, rtol=1e-6)
    want = np.asarray(ref_kernels.reconstruct_apply_packed(
        ref_seeds, jnp.asarray(scale), jnp.asarray(theta), rl, dist,
        interpret=True))
    got = rbd_step.reconstruct_apply_packed_plain(
        seeds, torch.from_numpy(scale), torch.from_numpy(theta), layout,
        dist).numpy()
    _assert_theta_close(got, want, theta)


def test_wrappers_take_plain_version_on_cpu_only():
    _, plan = _plans("uniform")
    layout = plan.packed(PB, DB)
    g, theta, scale, _ = _packed_inputs(layout, seed=4)
    seeds = projector.segment_seeds(plan, rng.fold_seed(0))
    rbd_step.reset_counts()
    u, sq = rbd_step.project_packed(seeds, torch.from_numpy(g), layout,
                                    "uniform")
    up, sqp = rbd_step.project_packed_plain(seeds, torch.from_numpy(g),
                                            layout, "uniform")
    assert torch.equal(u, up) and torch.equal(sq, sqp)
    th = torch.from_numpy(theta.copy())
    out = rbd_step.reconstruct_apply_packed(seeds, torch.from_numpy(scale),
                                            th, layout, "uniform", out=th)
    want = rbd_step.reconstruct_apply_packed_plain(
        seeds, torch.from_numpy(scale), torch.from_numpy(theta), layout,
        "uniform")
    assert out is th and torch.equal(th, want)
    # on the CPU no kernel launches: the counters of launches stay 0
    assert rbd_step.CALLS["project_packed"] == 1
    assert rbd_step.CALLS["reconstruct_apply_packed"] == 1
    assert rbd_step.LAUNCHES == dict.fromkeys(rbd_step.KERNELS, 0)
    b0, b1, x = rbd_step.generate_tile(7, 16, 1024, (8, 512), "sparse",
                                       device="cpu")
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(ref_rng.generate_block(7, 16, 1024, (8, 512),

                                                     "sparse")))
