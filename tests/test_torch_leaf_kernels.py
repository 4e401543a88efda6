"""Port parity: the plain versions of the three per-leaf kernels
(``repro_torch.kernels.rbd_project.project_flat``,
``rbd_reconstruct.reconstruct_flat`` and ``reconstruct_apply_flat``)
against the reference's Pallas kernels in interpret mode
(``repro.kernels.ops``) and its jnp oracles (``repro.core.projector.
_project_flat`` and ``_reconstruct_flat``), on the same seeds and inputs.

Tolerances (the sums run in another order than XLA's):
* u: |du_k| <= 2e-5 * ||g|| * sqrt(sq_k / Q);
* sq: 2e-5 relative;
* delta (reconstruct_flat): 2e-5 of max|delta|;
* theta: 1e-4 of max|update| + 2 ulp of max|theta| in theta's dtype.
The bf16 apply rounds exactly once: bit-exact against float32 arithmetic
cast once at the end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projector as ref_proj
from repro.core import rng as ref_rng
from repro.kernels import ops as ref_ops
from repro.kernels import rbd_project as ref_project
from repro_torch.core import rng
from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

U_RTOL, SQ_RTOL, DELTA_RTOL, THETA_RTOL = 2e-5, 2e-5, 2e-5, 1e-4
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
# (distribution, q, dim): every distribution, q of 300, 1500 and 2000,
# dims 24 and 30 (30 is not a multiple of 8: a padded dir-block)
CASES = [("normal", 2000, 30), ("uniform", 300, 24),
         ("rademacher", 1500, 30), ("sparse", 2000, 24)]


def _seed(i=0):
    return int(rng.to_uint32(rng.fold_seed(42, i)))


def _assert_u_sq(u, sq, want_u, want_sq, g):
    q = g.shape[-1]
    scale = np.linalg.norm(g, axis=-1, keepdims=True) * np.sqrt(want_sq / q)
    assert (np.abs(u - want_u) <= U_RTOL * scale).all(), np.max(
        np.abs(u - want_u) / scale)
    np.testing.assert_allclose(sq, want_sq, rtol=SQ_RTOL)


def _assert_theta(got: torch.Tensor, want, theta: torch.Tensor):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    th = theta.float().numpy()
    tol = (THETA_RTOL * np.abs(want - th).max()
           + 2 * ULP[theta.dtype] * np.abs(th).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dist,q,dim", CASES)
def test_plain_versions_vs_interpret_kernels_and_oracles(dist, q, dim):
    rs = np.random.default_rng(q + dim)
    g = rs.standard_normal(q).astype(np.float32)
    seed = _seed(1)
    seeds = torch.tensor([seed], dtype=torch.int64)

    u, sq = rbd_project.project_flat_plain(seeds, torch.from_numpy(g)[None],
                                           dim, dist)
    for ref in (ref_ops.project_flat(np.uint32(seed), jnp.asarray(g), dim,
                                     dist),
                ref_proj._project_flat(np.uint32(seed), jnp.asarray(g), dim,
                                       dist)):
        _assert_u_sq(u.numpy()[0], sq.numpy()[0], np.asarray(ref[0]),
                     np.asarray(ref[1]), g)

    s = (rs.standard_normal(dim) * 0.1).astype(np.float32)
    delta = rbd_reconstruct.reconstruct_flat_plain(
        seeds, torch.from_numpy(s)[None], q, dist).numpy()[0]
    for want in (ref_ops.reconstruct_flat(np.uint32(seed), jnp.asarray(s),
                                          (q,), dist),
                 ref_proj._reconstruct_flat(np.uint32(seed), jnp.asarray(s),
                                            q, dist, jnp.float32)):
        want = np.asarray(want)
        np.testing.assert_allclose(delta, want, rtol=0,
                                   atol=DELTA_RTOL * np.abs(want).max())

    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        theta = torch.from_numpy(rs.standard_normal(q).astype(
            np.float32)).to(dtype)
        want = ref_ops.reconstruct_apply_flat(
            np.uint32(seed), jnp.asarray(s),
            jnp.asarray(theta.float().numpy()).astype(jdt), 0.05, dist)
        got = rbd_reconstruct.reconstruct_apply_flat_plain(
            seeds, torch.from_numpy(s)[None], theta[None], 0.05, dist)[0]
        assert got.dtype == dtype and want.dtype == jdt
        _assert_theta(got, np.asarray(want, np.float32), theta)


def test_stacked_leaf_one_call():
    """n = 5 stacked compartments, each on its own layer seed
    fold_seed(leaf_seed, i): one call of each wrapper against the
    reference kernels vmapped over the stack (interpret mode)."""
    import jax

    n, q, dim = 5, 300, 24
    rs = np.random.default_rng(5)
    leaf_seed = rng.fold_seed(7, 3)
    seeds = rng.fold_seed(leaf_seed, torch.arange(n, dtype=torch.int32))
    ref_seeds = jax.vmap(lambda i: ref_rng.fold_seed(
        np.uint32(rng.to_uint32(leaf_seed)), i))(jnp.arange(n,
                                                            dtype=jnp.uint32))
    np.testing.assert_array_equal(rng.to_uint32(seeds), np.asarray(ref_seeds))
    g = rs.standard_normal((n, q)).astype(np.float32)
    rbd_step.reset_counts()
    u, sq = rbd_project.project_flat(seeds, torch.from_numpy(g), dim)
    want_u, want_sq = jax.vmap(lambda s, x: ref_ops.project_flat(s, x, dim))(
        ref_seeds, jnp.asarray(g))
    _assert_u_sq(u.numpy(), sq.numpy(), np.asarray(want_u),
                 np.asarray(want_sq), g)

    s = (rs.standard_normal((n, dim)) * 0.1).astype(np.float32)
    delta = rbd_reconstruct.reconstruct_flat(seeds, torch.from_numpy(s), q)
    want = np.asarray(jax.vmap(lambda sd, sc: ref_ops.reconstruct_flat(
        sd, sc, (q,)))(ref_seeds, jnp.asarray(s)))
    np.testing.assert_allclose(delta.numpy(), want, rtol=0,
                               atol=DELTA_RTOL * np.abs(want).max())

    theta = torch.from_numpy(rs.standard_normal((n, q)).astype(np.float32))
    out = theta.clone()
    got = rbd_reconstruct.reconstruct_apply_flat(seeds, torch.from_numpy(s),
                                                 out, 0.1, out=out)
    assert got is out
    want = jax.vmap(lambda sd, sc, th: ref_ops.reconstruct_apply_flat(
        sd, sc, th, 0.1))(ref_seeds, jnp.asarray(s), jnp.asarray(theta))
    _assert_theta(out, np.asarray(want), theta)
    # one wrapper call each for the whole stack; no launch on the CPU
    assert rbd_step.CALLS["project_flat"] == 1
    assert rbd_step.CALLS["reconstruct_flat"] == 1
    assert rbd_step.CALLS["reconstruct_apply_flat"] == 1
    assert sum(rbd_step.LAUNCHES.values()) == 0


def test_bf16_apply_rounds_exactly_once():
    """q = one pos-block, d = one dir-block: the bf16 result is the
    float32 computation rounded ONCE -- bit for bit -- and matches the
    reference kernel's bf16 output."""
    q, d = 512, 8
    rs = np.random.default_rng(9)
    seed = _seed(2)
    seeds = torch.tensor([seed])
    theta16 = torch.from_numpy(rs.standard_normal(q).astype(
        np.float32)).to(torch.bfloat16)[None]
    s = torch.from_numpy(rs.standard_normal(d).astype(np.float32))[None]
    out16 = rbd_reconstruct.reconstruct_apply_flat_plain(seeds, s, theta16,
                                                         0.1, "uniform")
    assert out16.dtype == torch.bfloat16
    part = rbd_reconstruct.reconstruct_flat_plain(seeds, s, q, "uniform")
    eta = torch.tensor(0.1, dtype=torch.float32)
    expect = (theta16.float() - eta * part).to(torch.bfloat16)
    assert torch.equal(out16, expect)
    # a float32 theta holding the same values, rounded once afterwards
    out32 = rbd_reconstruct.reconstruct_apply_flat_plain(
        seeds, s, theta16.float(), 0.1, "uniform")
    assert torch.equal(out32.to(torch.bfloat16), out16)
    want = ref_ops.reconstruct_apply_flat(
        np.uint32(seed), jnp.asarray(s.numpy()[0]),
        jnp.asarray(theta16.float().numpy()[0]).astype(jnp.bfloat16), 0.1,
        "uniform")
    np.testing.assert_array_equal(out16.float().numpy()[0],
                                  np.asarray(want, np.float32))


def test_tiling_invariance(monkeypatch):
    """Generation is position-keyed: the plain versions' results do not
    depend on how positions are cut into blocks beyond the sum-order
    tolerance, and agree with the reference kernel at other (dir_block,
    pos_block) tilings."""
    q, dim = 2000, 30
    rs = np.random.default_rng(7)
    seeds = torch.tensor([_seed(3)])
    g = torch.from_numpy(rs.standard_normal((1, q)).astype(np.float32))
    s = torch.from_numpy((rs.standard_normal((1, dim)) * 0.1).astype(
        np.float32))
    theta = torch.from_numpy(rs.standard_normal((1, q)).astype(np.float32))
    base = (rbd_project.project_flat_plain(seeds, g, dim),
            rbd_reconstruct.reconstruct_flat_plain(seeds, s, q),
            rbd_reconstruct.reconstruct_apply_flat_plain(seeds, s, theta,
                                                         0.2))
    for budget in (1 << 10, 3 * 640, 1 << 20):
        monkeypatch.setitem(rbd_step._PLAIN_BUDGET, "cpu", budget)
        u, sq = rbd_project.project_flat_plain(seeds, g, dim)
        _assert_u_sq(u.numpy(), sq.numpy(), base[0][0].numpy(),
                     base[0][1].numpy(), g.numpy())
        delta = rbd_reconstruct.reconstruct_flat_plain(seeds, s, q)
        np.testing.assert_allclose(
            delta.numpy(), base[1].numpy(), rtol=0,
            atol=DELTA_RTOL * float(base[1].abs().max()))
        _assert_theta(rbd_reconstruct.reconstruct_apply_flat_plain(
            seeds, s, theta, 0.2), base[2].numpy(), theta)
    for db, pb in ((8, 256), (16, 1024)):
        want_u, want_sq = ref_project.project_flat(
            np.uint32(int(seeds[0])), jnp.asarray(g.numpy()[0]), dim,
            interpret=True, dir_block=db, pos_block=pb)
        _assert_u_sq(base[0][0].numpy()[0], base[0][1].numpy()[0],
                     np.asarray(want_u), np.asarray(want_sq), g.numpy()[0])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On the CPU the wrappers take the plain versions; the shape and
    dtype checks of the CUDA route are shared helpers that raise."""
    seeds = torch.tensor([_seed(4)])
    x = torch.zeros((1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        rbd_project.check_flat("g", x, 1, 64)
    with pytest.raises(ValueError, match="shape"):
        rbd_reconstruct._padded_scale(torch.zeros((2, 3)), 1, 3)
    assert rbd_project.padded_dim(30) == 32
    u, sq = rbd_project.project_flat(seeds, x, 3)
    assert u.shape == sq.shape == (1, 3) and float(u.abs().max()) == 0.0
