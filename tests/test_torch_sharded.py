"""Port parity: the model-sharded slabs (``ShardedPackedLayout``, the
three sharded entry points of ``core.projector`` and their plain kernel
versions, ``SubspaceOptimizer.step_shards_in_turn``) against the
reference's ``repro.core.compartments.sharded_packed_layout`` and its jnp
oracles of the sharded kernels, one shard at a time, in-process.

Tolerances (as in test_torch_projector.py): u within 1e-5 of
||g_seg|| sqrt(sq/Q); sq rtol 1e-6; theta 1e-5 of the largest update plus
2 ulp of theta.  Exact: the layout and its tables, the slabs of the
port's own plain applies against the unsharded plain apply, zero padding,
a shard that is all padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.core import rng as ref_rng
from repro.core.rbd import RandomBasesTransform as RefTransform
from repro.optim import subspace as ref_subspace
from repro_torch.core import compartments, distributed, projector, rng
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.kernels import rbd_step
from repro_torch.models import registry
from repro_torch.optim import subspace

torch.set_num_threads(1)

SHAPES = {"w": (64, 32), "layers/k": (3, 40, 10), "s": (), "odd": (7, 73),
          "long": (700,)}
EPS32 = 2.0 ** -23
DISTS = ["normal", "uniform", "rademacher", "sparse"]


def _plans(norm="rsqrt_dim", dist="normal", dim=96):
    ref_tree = {"w": jax.ShapeDtypeStruct((64, 32), jnp.float32),
                "layers": {"k": jax.ShapeDtypeStruct((3, 40, 10),
                                                     jnp.float32)},
                "s": jax.ShapeDtypeStruct((), jnp.float32),
                "odd": jax.ShapeDtypeStruct((7, 73), jnp.float32),
                "long": jax.ShapeDtypeStruct((700,), jnp.float32)}
    kw = dict(is_stacked=lambda n: n.startswith("layers"),
              normalization=norm, distribution=dist)
    return (ref_comp.make_plan(ref_tree, dim, **kw),
            compartments.make_plan(SHAPES, dim, **kw))


def _padded_inputs(layout, q_padded, seed=0):
    """g, theta (zero on padding and past q_packed), a scale and a (2,
    d_packed) worker scale, as float32 numpy."""
    rs = np.random.default_rng(seed)
    valid = np.concatenate([layout.param_valid.astype(bool),
                            np.zeros(q_padded - layout.q_packed, bool)])
    g = np.where(valid, rs.standard_normal(q_padded), 0).astype(np.float32)
    theta = np.where(valid, rs.standard_normal(q_padded), 0).astype(
        np.float32)
    scale = (rs.standard_normal((2, layout.d_packed)) * 1e-2
             * layout.coord_valid).astype(np.float32)
    return g, theta, scale, valid


def _u_scale(g, sq, layout):
    out = np.zeros(layout.d_packed)
    for s in range(layout.n_segments):
        o, q = layout.seg_param_off[s], layout.seg_size[s]
        c, n = layout.seg_coord_off[s], layout.seg_pdim[s]
        out[c: c + n] = np.linalg.norm(g[o: o + q]) * np.sqrt(
            np.abs(sq[c: c + n]) / q)
    return out


def _assert_theta_close(got, want, theta):
    upd = np.abs(want - theta).max()
    tol = 1e-5 * upd + 2 * EPS32 * np.abs(theta).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("pos_block", [128, 512])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 7])
def test_slab_geometry_matches_reference(m, pos_block):
    ref_plan, plan = _plans()
    rs = ref_comp.sharded_packed_layout(ref_plan.packed(pos_block, 8), m)
    ps = compartments.sharded_packed_layout(plan.packed(pos_block, 8), m)
    for f in ("n_shards", "q_slab", "q_padded", "blocks_per_shard"):
        assert getattr(ps, f) == getattr(rs, f), f
    np.testing.assert_array_equal(ps.param_valid, np.asarray(rs.param_valid))
    # the reference's stacked per-shard tile tables, built on request
    for f in ("pt_seg", "pt_row0", "pt_col0", "pt_gblk", "pt_ublk",
              "pt_init", "pt_q", "rt_seg", "rt_row0", "rt_col0", "rt_gblk",
              "rt_sblk", "rt_init", "rt_q"):
        want = np.asarray(getattr(rs, f))
        assert getattr(ps, f).dtype == want.dtype, f
        np.testing.assert_array_equal(getattr(ps, f), want, err_msg=f)
    for k in (1, 3):
        want, got = rs.worker_tables(k), ps.worker_tables(k)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"K={k} {f}")


@pytest.mark.parametrize("m", [1, 2, 3, 7])
def test_kernel_windows_cover_each_slab_once(m):
    """The sharded kernels' grids, worked out in numpy from the tables
    they read: the projection's clipped chunks cover each segment's slab
    columns exactly once for every dir-block (one empty chunk where there
    are none), and the apply's pos-blocks are the slab's."""
    _, plan = _plans()
    layout = plan.packed(128, 8)
    sl = compartments.sharded_packed_layout(layout, m)
    pb, pc = layout.pos_block, 2          # a small chunk: several a slab
    seen = np.zeros(sl.q_padded, np.int64)
    for shard in range(m):
        t = compartments.sharded_segment_tables(sl, shard, pc)
        lo, hi = sl.seg_windows(shard)
        n_di = layout.seg_pdim // layout.dir_block
        assert t["proj_blocks"][-1] == (n_di * t["n_chunk"]).sum()
        for s in range(layout.n_segments):
            cols = np.zeros(layout.seg_size[s], np.int64)
            assert t["n_chunk"][s] >= 1
            for chunk in range(t["n_chunk"][s]):
                start = (t["chunk_lo"][s] + chunk) * pc * pb
                c0 = max(start, t["col_lo"][s])
                c1 = min(start + pc * pb, t["col_hi"][s])
                cols[c0:max(c0, c1)] += 1
            want = np.zeros_like(cols)
            want[lo[s]:hi[s]] = 1
            np.testing.assert_array_equal(cols, want)
            off = layout.seg_param_off[s]
            seen[off: off + layout.seg_size[s]] += cols
        # the apply: pos-block b of the slab is global block lo_blk + b
        a, b = sl.slab_range(shard)
        assert (b - a) == sl.blocks_per_shard * pb
    np.testing.assert_array_equal(
        seen[: layout.q_packed], layout.param_valid.astype(np.int64))


@pytest.mark.parametrize("norm", ["rsqrt_dim", "none", "exact"])
@pytest.mark.parametrize("m", [2, 4, 7])
def test_partials_match_reference_and_complete(norm, m):
    ref_plan, plan = _plans(norm)
    rl, layout = ref_plan.packed(), plan.packed()
    rsl = ref_comp.sharded_packed_layout(rl, m)
    sl = compartments.sharded_packed_layout(layout, m)
    g, _, _, _ = _padded_inputs(layout, sl.q_padded)
    ref_seed = RefTransform(ref_plan, base_seed=3).step_seed(jnp.uint32(0))
    seed = RandomBasesTransform(plan, base_seed=3).step_seed(0)
    _, full_sq = rbd_step.project_packed_plain(
        projector.segment_seeds(plan, seed),
        torch.from_numpy(g[:layout.q_packed]), layout)
    tol = 1e-5 * _u_scale(g, full_sq.numpy(), layout)
    u_sum = sq_sum = None
    for shard in range(m):
        a, b = sl.slab_range(shard)
        want_u, want_sq = map(np.asarray, ref_proj.project_packed_sharded(
            jnp.asarray(g[a:b]), ref_plan, ref_seed, jnp.int32(shard),
            slayout=rsl, backend="jnp"))
        u, sq = projector.project_packed_sharded(
            torch.from_numpy(g[a:b]), plan, seed, shard, slayout=sl,
            backend="cuda")
        assert (np.abs(u.numpy() - want_u) <= tol).all(), shard
        np.testing.assert_allclose(sq.numpy(), want_sq, rtol=1e-6)
        u_sum = u if u_sum is None else u_sum + u
        sq_sum = sq if sq_sum is None else sq_sum + sq
    # completed and normalized: the reference's unsharded coordinates
    want_c, want_sq = map(np.asarray, ref_proj.project_packed(
        jnp.asarray(g[:layout.q_packed]), ref_plan, ref_seed, layout=rl,
        return_norms=True, prepacked=True))
    np.testing.assert_allclose(sq_sum.numpy(), want_sq, rtol=1e-6)
    factor = projector.packed_norm_factor(plan, layout, sq_sum)
    coords = (u_sum * factor).numpy()
    np.testing.assert_allclose(
        coords, want_c, rtol=0,
        atol=1e-5 * np.max(np.abs(want_c)) + 1e-7)


@pytest.mark.parametrize("dist", ["normal", "rademacher"])
@pytest.mark.parametrize("m", [2, 3, 7])
def test_slab_applies_match_reference_oracles(m, dist):
    ref_plan, plan = _plans(dist=dist)
    rl, layout = ref_plan.packed(), plan.packed()
    rsl = ref_comp.sharded_packed_layout(rl, m)
    sl = compartments.sharded_packed_layout(layout, m)
    _, theta, scale, valid = _padded_inputs(layout, sl.q_padded, seed=1)
    coords = scale * 30.0
    seeds = (ref_rng.fold_seed(11), rng.fold_seed(11))
    for shard in range(m):
        a, b = sl.slab_range(shard)
        want = np.asarray(ref_proj.reconstruct_apply_packed_sharded(
            jnp.asarray(coords[0]), ref_plan, seeds[0],
            jnp.asarray(theta[a:b]), 0.25, jnp.int32(shard), slayout=rsl,
            backend="jnp"))
        got = projector.reconstruct_apply_packed_sharded(
            torch.from_numpy(coords[0]), plan, seeds[1],
            torch.from_numpy(theta[a:b]), 0.25, shard, slayout=sl,
            backend="cuda").numpy()
        _assert_theta_close(got, want, theta[a:b])
        assert (got[~valid[a:b]] == 0).all()
        want = np.asarray(ref_proj.reconstruct_apply_packed_workers_sharded(
            jnp.asarray(coords), ref_plan, seeds[0],
            jnp.asarray(theta[a:b]), 0.125, jnp.int32(shard), slayout=rsl,
            backend="jnp"))
        got = projector.reconstruct_apply_packed_workers_sharded(
            torch.from_numpy(coords), plan, seeds[1],
            torch.from_numpy(theta[a:b]), 0.125, shard, slayout=sl,
            backend="cuda").numpy()
        _assert_theta_close(got, want, theta[a:b])
        assert (got[~valid[a:b]] == 0).all()


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("m", [2, 3, 4, 7])
def test_slabs_concatenate_to_unsharded_plain_apply(m, dist):
    """Bit for bit: each slab of both plain applies is the matching slice
    of the unsharded plain apply (the same blocks, the same association),
    the padding tail stays exactly zero, and the in-place form agrees."""
    _, plan = _plans(dist=dist)
    layout = plan.packed(128, 8)
    sl = compartments.sharded_packed_layout(layout, m)
    _, theta, scale, _ = _padded_inputs(layout, sl.q_padded, seed=2)
    th, sc = torch.from_numpy(theta), torch.from_numpy(scale)
    seeds = projector.segment_seeds(plan, rng.fold_seed(5))
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(5), 2)
    q = layout.q_packed
    full = rbd_step.reconstruct_apply_packed_plain(seeds, sc[0], th[:q],
                                                   layout, dist)
    wfull = rbd_step.reconstruct_apply_packed_workers_plain(
        wseeds, sc, th[:q], layout, dist)
    slabs, wslabs = [], []
    for shard in range(m):
        a, b = sl.slab_range(shard)
        slabs.append(rbd_step.reconstruct_apply_packed_sharded(
            seeds, sc[0], th[a:b], sl, shard, dist))
        inplace = th[a:b].clone()
        rbd_step.reconstruct_apply_packed_workers_sharded(
            wseeds, sc, inplace, sl, shard, dist, out=inplace)
        wslabs.append(inplace)
    for got, want in ((torch.cat(slabs), full), (torch.cat(wslabs), wfull)):
        assert torch.equal(got[:q], want)
        assert bool((got[q:] == 0).all())


def test_entirely_padding_shard_is_inert():
    """m = 7 leaves the last shard with no live position: its partial is
    exactly zero and its apply returns the slab unchanged (the
    reference's test of the same name)."""
    _, plan = _plans()
    layout = plan.packed()
    m = 7
    sl = compartments.sharded_packed_layout(layout, m)
    assert sl.q_padded - layout.q_packed > sl.q_slab
    assert sl.live_values(m - 1) == 0
    seed = RandomBasesTransform(plan, base_seed=3).step_seed(0)
    zero = torch.zeros(sl.q_slab)
    u, sq = projector.project_packed_sharded(zero + 3.0, plan, seed, m - 1,
                                             slayout=sl, backend="cuda")
    assert bool((u == 0).all()) and bool((sq == 0).all())
    out = projector.reconstruct_apply_packed_sharded(
        torch.ones(layout.d_packed), plan, seed, zero, 0.5, m - 1,
        slayout=sl, backend="cuda")
    assert bool((out == 0).all())


def test_exact_needs_completed_norms_and_completion_without_group():
    _, plan = _plans("exact")
    sl = compartments.sharded_packed_layout(plan.packed(), 2)
    with pytest.raises(ValueError, match="completed row norms"):
        projector.reconstruct_apply_packed_sharded(
            torch.zeros(sl.d_packed), plan, rng.fold_seed(0),
            torch.zeros(sl.q_slab), 0.1, 0, slayout=sl)
    with pytest.raises(ValueError, match="completed row norms"):
        projector.reconstruct_apply_packed_workers_sharded(
            torch.zeros((2, sl.d_packed)), plan, rng.fold_seed(0),
            torch.zeros(sl.q_slab), 0.1, 0, slayout=sl)
    u, sq = torch.ones(4), torch.full((4,), 2.0)
    got = distributed.complete_model_partials(u, sq, None)
    assert got[0] is u and got[1] is sq
    with pytest.raises(ValueError, match="outside"):
        rbd_step.project_packed_sharded(
            rng.fold_seed(0, 0).expand(sl.n_segments), torch.zeros(sl.q_slab),
            sl, 2)


@pytest.mark.parametrize("m", [2, 3])
def test_reference_padded_buffer_cuts_into_the_ports_slabs(m):
    """registry.slabs_from_reference: the reference's padded (q_padded,)
    buffer (its ``prepare_params`` under a declared model axis) cut into
    slabs equals the port's own slabs of the same parameters."""
    ref_plan, plan = _plans()
    rs = np.random.default_rng(4)
    named = {k: rs.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
    tree = {"w": named["w"], "layers": {"k": named["layers/k"]},
            "s": named["s"], "odd": named["odd"], "long": named["long"]}
    rsub = ref_subspace.SubspaceOptimizer(
        transform=RefTransform(ref_plan, base_seed=3, backend="pallas"),
        use_packed=True, model_sharded=True, model_axis="model",
        model_shards=m)
    padded = np.asarray(rsub.prepare_params(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    sub = _sub(plan, "sgd", m)
    slabs = registry.slabs_from_reference(padded, sub.sharded_layout(),
                                          device="cpu")
    mine = sub.padded_params({k: torch.from_numpy(v)
                              for k, v in named.items()})
    assert len(slabs) == m
    for shard, slab in enumerate(slabs):
        assert torch.equal(slab, sub.slab_of(mine, shard))


def _sub(plan, optimizer, m, **kw):
    return subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=3, backend="cuda"),
        optimizer=optimizer, learning_rate=0.2, use_packed=True,
        model_sharded=m > 1, model_axis="model" if m > 1 else None,
        model_shards=m, **kw)


@pytest.mark.parametrize("optimizer,norm", [("sgd", "rsqrt_dim"),
                                            ("momentum", "exact"),
                                            ("adam", "none")])
@pytest.mark.parametrize("m", [2, 3])
def test_shards_in_turn_match_the_unsharded_step(m, optimizer, norm):
    """Two steps of a model group run shard by shard in one process
    against the port's unsharded fused_packed step: rtol 1e-4, atol
    1e-5 of the largest |theta| + 1 (the reference's sharded-vs-plain
    tolerance); 2 launches per shard per step."""
    _, plan = _plans(norm)
    layout = plan.packed()
    sharded, single = _sub(plan, optimizer, m), _sub(plan, optimizer, 1)
    assert sharded.plan_execution().strategy == "fused_packed"
    sl = sharded.sharded_layout()
    _, theta, _, _ = _padded_inputs(layout, sl.q_padded, seed=5)
    rs = np.random.default_rng(6)
    params = torch.from_numpy(theta[: layout.q_packed])
    slabs = [torch.from_numpy(theta[a:b]) for a, b in
             map(sl.slab_range, range(m))]
    st_r, st_o = single.init_rbd_state(), single.init_opt_state(params)
    sh_r, sh_o = sharded.init_rbd_state(), sharded.init_opt_state(params)
    for _ in range(2):
        g = np.where(sl.param_valid.reshape(-1) > 0,
                     rs.standard_normal(sl.q_padded), 0).astype(np.float32)
        gt = torch.from_numpy(g)
        params, st_r, st_o, _ = single.step(params, gt[: layout.q_packed],
                                            st_r, st_o)
        rbd_step.reset_counts()
        slabs, sh_r, sh_o, aux = sharded.step_shards_in_turn(
            slabs, [sharded.slab_of(gt, s) for s in range(m)], sh_r, sh_o)
        assert rbd_step.CALLS["project_packed_sharded"] == m
        assert rbd_step.CALLS["reconstruct_apply_packed_sharded"] == m
        assert np.isfinite(float(aux.update_norm))
    got = torch.cat(slabs).numpy()
    want = params.numpy()
    scale = float(np.abs(want).max()) + 1.0
    np.testing.assert_allclose(got[: layout.q_packed], want, rtol=1e-4,
                               atol=1e-5 * scale)
    assert (got[layout.q_packed:] == 0).all()
