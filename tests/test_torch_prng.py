"""Port parity of the tile-keyed PRNG impls (``--prng-impl hw |
hw_emulated``) and the two-slot schedule's auto rule.

``hw_emulated`` is ported bit for bit: tile keys, uint32 bits and the
uniform / rademacher / bernoulli / sparse samples equal
``repro.core.rng``'s; normal samples go through log/cos/sqrt, which XLA
and PyTorch round differently in the last place (``NORMAL_ATOL``, as in
tests/test_torch_rng.py).  The packed plain versions (rows 1-7 of
PERF.md's kernel table, sharded at m = 2) and the per-leaf ones (rows
8-10) under ``hw_emulated`` are held to the reference's jnp oracles, or
to its interpret-mode kernels for the per-leaf rows, with the tolerances
of tests/test_torch_projector.py and tests/test_torch_leaf_kernels.py.

The port's ``hw`` is a tile-keyed Philox4x32-10 (Hopper has no hardware
PRNG), so it is held to Random123's known answers and to the reference's
distribution, determinism and coherence checks
(tests/test_prng_backends.py) with the reference's thresholds, not to
bits.  The launcher's three-step ``hw_emulated`` run tracks the
reference's jnp step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.core import rng as ref_rng
from repro.kernels import ops as ref_ops
from repro.kernels import rbd_step as ref_kernels
from repro.optim import subspace as ref_subspace
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import compartments, projector, rng
from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step
from repro_torch.launch import train as launcher
from repro_torch.optim import subspace

from test_torch_train import run_three_steps_against_reference

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

PB, DB = 128, 8
DISTS = ["normal", "uniform", "bernoulli", "rademacher", "sparse"]
NORMAL_ATOL = 1e-6
EPS32 = 2.0 ** -23
# per-leaf tolerances of tests/test_torch_leaf_kernels.py
U_RTOL, SQ_RTOL, DELTA_RTOL, THETA_RTOL = 2e-5, 2e-5, 2e-5, 1e-4
TILE_KEYED = ["hw_emulated", "hw"]


def _u32(rs, n):
    return rs.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _assert_samples(got, want, dist):
    if dist == "normal":
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# hw_emulated: the generator, bit for bit
# ---------------------------------------------------------------------------


def test_hw_tile_key_bit_exact():
    rs = np.random.default_rng(0)
    seeds, rows, cols = _u32(rs, 64), _u32(rs, 64), _u32(rs, 64)
    rows[:4] = [0, 8, 2**32 - 8, 2**31]
    cols[:4] = [0, 2**32 - 512, 512, 2**31]
    want = np.asarray(ref_rng.hw_tile_key(seeds, rows, cols))
    got = rng.hw_tile_key(rng.as_u32(seeds), rng.as_u32(rows),
                          rng.as_u32(cols))
    np.testing.assert_array_equal(rng.to_uint32(got), want)


@pytest.mark.parametrize("draw", [0, 1])
def test_emulated_random_bits_bit_exact(draw):
    key = ref_rng.hw_tile_key(ref_rng.fold_seed(4), np.uint32(16),
                              np.uint32(1024))
    want = np.asarray(ref_rng.emulated_random_bits(key, np.uint32(draw),
                                                   (8, 512)))
    idx = torch.arange(8 * 512, dtype=torch.int32).reshape(8, 512)
    got = rng.emulated_random_bits(rng.as_u32(np.asarray(key)), draw, idx)
    np.testing.assert_array_equal(rng.to_uint32(got), want)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("row0,col0", [(0, 0), (16, 1024),
                                       (2**32 - 8, 2**32 - 512)])
def test_hw_emulated_tile_matches_reference(dist, row0, col0):
    want = np.asarray(ref_rng.get_prng_spec("hw_emulated").generate_tile(
        ref_rng.fold_seed(5), np.uint32(row0), np.uint32(col0), (8, 256),
        dist))
    got = rng.get_prng_spec("hw_emulated").generate_tile(
        rng.fold_seed(5), row0, col0, (8, 256), dist).numpy()
    assert got.dtype == np.float32
    _assert_samples(got, want, dist)


@pytest.mark.parametrize("dist", ["normal", "sparse"])
def test_tiled_block_is_the_reference_tile_assembly(dist):
    """A segment's (rows, cols) block of (8, PB) tiles, the last one
    ragged: each tile is the reference's ``generate_tile`` at its own
    (row0, col0), cut at the segment's end."""
    spec = ref_rng.get_prng_spec("hw_emulated")
    seed, rows, col0, cols = 0xDEADBEEF, 24, 2 * PB, 2 * PB + 37
    want = np.zeros((rows, cols), np.float32)
    for r0 in range(0, rows, DB):
        for c0 in range(0, cols, PB):
            tile = np.asarray(spec.generate_tile(
                np.uint32(seed), np.uint32(r0), np.uint32(col0 + c0),
                (DB, PB), dist))
            want[r0: r0 + DB, c0: c0 + PB] = tile[:, : cols - c0]
    got = rng.generate_tiled_block("hw_emulated", seed, col0, (rows, cols),
                                   dist, dir_block=DB, pos_block=PB).numpy()
    _assert_samples(got, want, dist)


def test_generate_tile_debug_entry_on_the_cpu():
    """The debug wrapper's CPU bits are the tile's two emulated draws."""
    key = ref_rng.hw_tile_key(np.uint32(7), np.uint32(8), np.uint32(128))
    b0, b1, s = rbd_step.generate_tile(7, 8, 128, (8, 64), "sparse",
                                       device="cpu", prng="hw_emulated")
    for draw, b in ((0, b0), (1, b1)):
        np.testing.assert_array_equal(rng.to_uint32(b), np.asarray(
            ref_rng.emulated_random_bits(key, np.uint32(draw), (8, 64))))
    np.testing.assert_array_equal(s.numpy(), np.asarray(
        ref_rng.get_prng_spec("hw_emulated").generate_tile(
            np.uint32(7), np.uint32(8), np.uint32(128), (8, 64), "sparse")))


# ---------------------------------------------------------------------------
# hw: Philox4x32-10
# ---------------------------------------------------------------------------

# Random123's known-answer vectors: (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = rng.philox4x32(ctr, key)
    assert tuple(int(rng.to_uint32(w)) for w in got) == want
    # the same through tensors of uint32 bits
    got = rng.philox4x32([rng.as_u32(np.uint32(c)) for c in ctr],
                         [rng.as_u32(np.uint32(k)) for k in key])
    assert tuple(int(rng.to_uint32(w).reshape(-1)[0]) for w in got) == want


def _philox_ints(ctr, key):
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
        k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
        k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return c


def test_philox_vectorized_matches_big_integer_arithmetic():
    """The wrapped int64 mulhilo against Python's exact integers, words
    near 2**32 included."""
    rs = np.random.default_rng(1)
    words = _u32(rs, 6 * 64).reshape(6, 64)
    words[:, 0] = 0xFFFFFFFF
    words[:, 1] = 0x80000000
    got = rng.philox4x32([rng.as_u32(w) for w in words[:4]],
                         [rng.as_u32(w) for w in words[4:]])
    got = np.stack([rng.to_uint32(w) for w in got])
    for j in range(64):
        want = _philox_ints([int(w) for w in words[:4, j]],
                            (int(words[4, j]), int(words[5, j])))
        assert [int(x) for x in got[:, j]] == want


@pytest.mark.parametrize("rows,col0,cols",
                         [(8, 0, 64), (24, 2 * PB, 2 * PB + 37)])
def test_hw_tiled_block_is_the_tile_assembly(rows, col0, cols):
    """The hw block (keys broadcast over their tiles, the ragged last tile
    generated whole and cut) is each (8, PB) tile of ``generate_tile`` at
    its own (row0, col0), bit for bit."""
    spec = rng.get_prng_spec("hw")
    seed = 0xDEADBEEF
    want = np.zeros((rows, cols), np.float32)
    for r0 in range(0, rows, DB):
        for c0 in range(0, cols, PB):
            tile = spec.generate_tile(seed, r0, col0 + c0, (DB, PB),
                                      "uniform").numpy()
            want[r0: r0 + DB, c0: c0 + PB] = tile[:, : cols - c0]
    got = rng.generate_tiled_block("hw", seed, col0, (rows, cols),
                                   "uniform", dir_block=DB,
                                   pos_block=PB).numpy()
    np.testing.assert_array_equal(got, want)


def test_hw_rows_pair_on_one_philox_call():
    """Words 0-1 are the even row's (b0, b1), words 2-3 the odd row's, on
    the counter (column, row // 2, 0, 0) under the tile's key."""
    key = int(rng.to_uint32(rng.hw_tile_key(9, 16, 512)))
    b0, b1, _ = rbd_step.generate_tile(9, 16, 512, (8, 32), "normal",
                                       device="cpu", prng="hw")
    b0, b1 = rng.to_uint32(b0), rng.to_uint32(b1)
    for r in (0, 1, 6, 7):
        for c in (0, 5, 31):
            w = _philox_ints([c, r // 2, 0, 0],
                             (key, key ^ rng.KEY_SALT))
            assert (int(b0[r, c]), int(b1[r, c])) == (
                (w[0], w[1]) if r % 2 == 0 else (w[2], w[3]))


# ---------------------------------------------------------------------------
# distribution moments / sign balance (the reference's thresholds)
# ---------------------------------------------------------------------------


def _big_tile(spec_name, dist, seed_val=5, shape=(8, 1 << 15)):
    return rng.get_prng_spec(spec_name).generate_tile(
        rng.fold_seed(seed_val), 0, 0, shape, dist).numpy().ravel()


@pytest.mark.parametrize("spec_name", TILE_KEYED)
def test_moments_normal(spec_name):
    x = _big_tile(spec_name, "normal")
    assert abs(x.mean()) < 0.01
    assert abs(x.std() - 1.0) < 0.01
    assert (np.abs(x) > 4).mean() < 1e-3


@pytest.mark.parametrize("spec_name", TILE_KEYED)
def test_moments_uniform(spec_name):
    x = _big_tile(spec_name, "uniform")
    assert x.min() >= -1.0 and x.max() < 1.0
    assert abs(x.mean()) < 0.02


@pytest.mark.parametrize("spec_name", TILE_KEYED)
@pytest.mark.parametrize("dist", ["bernoulli", "rademacher"])
def test_sign_balance_rademacher(spec_name, dist):
    x = _big_tile(spec_name, dist)
    assert set(np.unique(x)) == {-1.0, 1.0}
    assert abs(x.mean()) < 0.02


@pytest.mark.parametrize("spec_name", TILE_KEYED)
def test_moments_sparse(spec_name):
    x = _big_tile(spec_name, "sparse")
    assert abs((x == 0).mean() - 2.0 / 3.0) < 0.02
    nz = x[x != 0]
    np.testing.assert_allclose(np.abs(nz), np.sqrt(3.0), rtol=1e-6)
    assert abs((nz > 0).mean() - 0.5) < 0.02
    assert abs(x.var() - 1.0) < 0.02


@pytest.mark.parametrize("spec_name", TILE_KEYED)
def test_seed_determinism_and_decorrelation(spec_name):
    spec = rng.get_prng_spec(spec_name)
    s1, s2 = rng.fold_seed(1), rng.fold_seed(2)
    a = spec.generate_tile(s1, 8, 128, (8, 4096), "normal").numpy()
    b = spec.generate_tile(s1, 8, 128, (8, 4096), "normal").numpy()
    np.testing.assert_array_equal(a, b)
    c = spec.generate_tile(s2, 8, 128, (8, 4096), "normal").numpy()
    assert abs(np.corrcoef(a.ravel(), c.ravel())[0, 1]) < 0.02
    d = spec.generate_tile(s1, 16, 128, (8, 4096), "normal").numpy()
    assert abs(np.corrcoef(a.ravel(), d.ravel())[0, 1]) < 0.02


def test_tile_keyed_impls_depend_on_the_tiling():
    s = rng.fold_seed(3)
    tf = rng.get_prng_spec("threefry")
    assert not tf.tile_keyed and not tf.in_kernel_only
    big = tf.generate_tile(s, 0, 0, (16, 256), "normal").numpy()
    sub = tf.generate_tile(s, 8, 128, (8, 128), "normal").numpy()
    np.testing.assert_array_equal(big[8:, 128:], sub)
    for name in TILE_KEYED:
        spec = rng.get_prng_spec(name)
        assert spec.tile_keyed
        assert spec.in_kernel_only == ref_rng.get_prng_spec(
            name).in_kernel_only
        big = spec.generate_tile(s, 0, 0, (16, 256), "normal").numpy()
        sub = spec.generate_tile(s, 8, 128, (8, 128), "normal").numpy()
        assert not np.allclose(big[8:, 128:], sub)


# ---------------------------------------------------------------------------
# coherence of the tile set across launches (the reference's checks)
# ---------------------------------------------------------------------------


def _small_plan(dim=24):
    return compartments.make_plan({"a": (5, 11), "b": (37,)}, dim,
                                  granularity="leaf")


@pytest.mark.parametrize("spec_name", TILE_KEYED)
def test_projection_reconstruction_tile_coherence(spec_name):
    """The basis implied by the projection (one-hot gradients) and the
    one the apply regenerates (one-hot coordinates) are the same matrix,
    bit for bit."""
    plan = _small_plan()
    layout = plan.packed(PB, DB)
    seeds = projector.segment_seeds(plan, rng.fold_seed(11))
    eye_q = torch.eye(layout.q_packed)
    p_proj = torch.stack([rbd_step.project_packed_plain(
        seeds, eye_q[j], layout, "normal", prng=spec_name)[0]
        for j in range(layout.q_packed)]).T
    zeros = torch.zeros(layout.q_packed)
    eye_d = torch.eye(layout.d_packed)
    p_recon = torch.stack([rbd_step.reconstruct_apply_packed_plain(
        seeds, -eye_d[i], zeros, layout, "normal", prng=spec_name)
        for i in range(layout.d_packed)])
    assert torch.equal(p_proj, p_recon)


@pytest.mark.parametrize("spec_name", TILE_KEYED)
def test_worker_fold_coherence(spec_name):
    plan = _small_plan()
    layout = plan.packed(PB, DB)
    seed, k_workers = rng.fold_seed(13), 3
    rs = np.random.default_rng(1)
    sc = torch.from_numpy((rs.standard_normal(layout.d_packed)
                           * layout.coord_valid).astype(np.float32))
    theta = torch.from_numpy(rs.standard_normal(layout.q_packed).astype(
        np.float32)) * torch.from_numpy(layout.param_valid)
    wbase = projector.worker_base_seeds(seed, k_workers)
    for k in range(k_workers):
        gathered = torch.zeros((k_workers, layout.d_packed))
        gathered[k] = sc
        joint = projector.reconstruct_apply_packed_workers(
            gathered, plan, seed, theta, 1.0, layout=layout, prepacked=True,
            prng=spec_name)
        single = projector.reconstruct_apply_packed(
            sc, plan, wbase[k], theta, 1.0, layout=layout, prepacked=True,
            prng=spec_name)
        assert torch.equal(joint, single)


# ---------------------------------------------------------------------------
# the plain versions under hw_emulated against the reference
# ---------------------------------------------------------------------------

SHAPES = {"w": (64, 32), "layers/k": (3, 40, 10), "s": (), "odd": (7, 73),
          "long": (700,)}


def _plans(dist="normal", norm="rsqrt_dim", dim=96):
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


def _inputs(layout, q=None, seed=0):
    q = q or layout.q_packed
    rs = np.random.default_rng(seed)
    valid = np.concatenate([layout.param_valid.astype(bool),
                            np.zeros(q - layout.q_packed, bool)])
    g = np.where(valid, rs.standard_normal(q), 0).astype(np.float32)
    theta = np.where(valid, rs.standard_normal(q), 0).astype(np.float32)
    scale = (rs.standard_normal((2, layout.d_packed)) * 1e-2
             * layout.coord_valid).astype(np.float32)
    return g, theta, scale, valid


def _assert_u_close(u, want_u, sq, g, layout, rtol=1e-5):
    scale = np.zeros(layout.d_packed)
    for s in range(layout.n_segments):
        o, q = layout.seg_param_off[s], layout.seg_size[s]
        c, n = layout.seg_coord_off[s], layout.seg_pdim[s]
        scale[c: c + n] = np.linalg.norm(g[o: o + q]) * np.sqrt(
            np.abs(sq[c: c + n]) / q)
    assert (np.abs(u - want_u) <= rtol * scale).all(), np.max(
        np.abs(u - want_u) / np.maximum(scale, 1e-30))


def _assert_theta_close(got, want, theta):
    upd = np.abs(want - theta).max()
    tol = 1e-5 * upd + 2 * EPS32 * np.abs(theta).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dist", ["normal", "uniform", "rademacher",
                                  "sparse"])
def test_packed_plain_versions_vs_reference_oracles(dist):
    """Rows 1-4: projection, apply, K-worker apply and B-adapter apply
    under hw_emulated against the reference's tile-table jnp oracles."""
    ref_plan, plan = _plans(dist)
    rl, layout = ref_plan.packed(PB, DB), plan.packed(PB, DB)
    g, theta, scale, valid = _inputs(layout)
    seeds = projector.segment_seeds(plan, rng.fold_seed(3))
    ref_seeds = ref_proj.segment_seeds(ref_plan, ref_rng.fold_seed(3))
    prng = "hw_emulated"

    want_u, want_sq = map(np.asarray, ref_proj._project_packed_jnp(
        ref_seeds, jnp.asarray(g), rl, dist, prng))
    u, sq = rbd_step.project_packed(seeds, torch.from_numpy(g), layout,
                                    dist, prng=prng)
    _assert_u_close(u.numpy(), want_u, want_sq, g, layout)
    if dist == "rademacher":
        np.testing.assert_array_equal(sq.numpy(), want_sq)
    else:
        np.testing.assert_allclose(sq.numpy(), want_sq, rtol=1e-6)

    want = np.asarray(ref_proj._reconstruct_apply_packed_jnp(
        ref_seeds, jnp.asarray(scale[0]), jnp.asarray(theta), rl, dist,
        prng))
    got = rbd_step.reconstruct_apply_packed(
        seeds, torch.from_numpy(scale[0]), torch.from_numpy(theta), layout,
        dist, prng=prng).numpy()
    _assert_theta_close(got, want, theta)
    assert (got[~valid] == 0).all()

    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(3), 2)
    ref_wseeds = jnp.concatenate([ref_proj.segment_seeds(ref_plan, s)
                                  for s in ref_proj.worker_base_seeds(
                                      ref_rng.fold_seed(3), 2)])
    np.testing.assert_array_equal(rng.to_uint32(wseeds),
                                  np.asarray(ref_wseeds))
    want = np.asarray(ref_proj._reconstruct_apply_packed_workers_jnp(
        ref_wseeds, jnp.asarray(scale), jnp.asarray(theta), rl, 2, dist,
        prng))
    got = rbd_step.reconstruct_apply_packed_workers(
        wseeds, torch.from_numpy(scale), torch.from_numpy(theta), layout,
        dist, prng=prng).numpy()
    _assert_theta_close(got, want, theta)

    want = np.asarray(ref_proj._reconstruct_apply_packed_adapters_jnp(
        ref_wseeds, jnp.asarray(scale), jnp.asarray(theta), rl, 2, dist,
        prng))
    got = rbd_step.reconstruct_apply_packed_adapters(
        wseeds, torch.from_numpy(scale), torch.from_numpy(theta), layout,
        dist, prng=prng).numpy()
    for a in range(2):
        _assert_theta_close(got[a], want[a], theta)


@pytest.mark.parametrize("dist", ["normal", "sparse"])
def test_sharded_plain_versions_vs_reference_oracles(dist):
    """Rows 5-7 at m = 2 under hw_emulated: partial projections, slab
    applies and K = 2 worker slab applies against the reference's
    per-shard oracles; tiles stay keyed within their segment."""
    m = 2
    ref_plan, plan = _plans(dist)
    rl, layout = ref_plan.packed(), plan.packed()
    rsl = ref_comp.sharded_packed_layout(rl, m)
    sl = compartments.sharded_packed_layout(layout, m)
    g, theta, scale, valid = _inputs(layout, sl.q_padded, seed=1)
    seeds = projector.segment_seeds(plan, rng.fold_seed(11))
    ref_seeds = ref_proj.segment_seeds(ref_plan, ref_rng.fold_seed(11))
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(11), 2)
    ref_wseeds = jnp.concatenate([ref_proj.segment_seeds(ref_plan, s)
                                  for s in ref_proj.worker_base_seeds(
                                      ref_rng.fold_seed(11), 2)])
    prng = "hw_emulated"
    # the partials' tolerance: tests/test_torch_sharded.py's, 1e-5 of the
    # completed coordinate's typical size
    _, full_sq = rbd_step.project_packed_plain(
        seeds, torch.from_numpy(g[:layout.q_packed]), layout, dist,
        prng=prng)
    u_sum = 0
    for shard in range(m):
        a, b = sl.slab_range(shard)
        want_u, want_sq = map(np.asarray,
                              ref_proj._project_packed_sharded_jnp(
                                  ref_seeds, jnp.asarray(g[a:b]), rsl,
                                  jnp.int32(shard), dist, prng))
        u, sq = rbd_step.project_packed_sharded(
            seeds, torch.from_numpy(g[a:b]), sl, shard, dist, prng=prng)
        _assert_u_close(u.numpy(), want_u, full_sq.numpy(), g, layout)
        np.testing.assert_allclose(sq.numpy(), want_sq, rtol=1e-6)
        u_sum = u_sum + u
        want = np.asarray(ref_proj._reconstruct_apply_packed_sharded_jnp(
            ref_seeds, jnp.asarray(scale[0]), jnp.asarray(theta[a:b]), rsl,
            jnp.int32(shard), dist, prng))
        got = rbd_step.reconstruct_apply_packed_sharded(
            seeds, torch.from_numpy(scale[0]), torch.from_numpy(theta[a:b]),
            sl, shard, dist, prng=prng).numpy()
        _assert_theta_close(got, want, theta[a:b])
        assert (got[~valid[a:b]] == 0).all()
        want = np.asarray(
            ref_proj._reconstruct_apply_packed_workers_sharded_jnp(
                ref_wseeds, jnp.asarray(scale), jnp.asarray(theta[a:b]),
                rsl, jnp.int32(shard), 2, dist, prng))
        got = rbd_step.reconstruct_apply_packed_workers_sharded(
            wseeds, torch.from_numpy(scale), torch.from_numpy(theta[a:b]),
            sl, shard, dist, prng=prng).numpy()
        _assert_theta_close(got, want, theta[a:b])
    want_u, _ = map(np.asarray, ref_proj._project_packed_jnp(
        ref_seeds, jnp.asarray(g[:layout.q_packed]), rl, dist, prng))
    _assert_u_close(u_sum.numpy(), want_u, full_sq.numpy(), g, layout)


def test_flat_plain_versions_vs_reference():
    """Rows 8-10 under hw_emulated (the kernel flag; no route takes it):
    project_flat and reconstruct_apply_flat against the reference's
    interpret-mode kernels, reconstruct_flat against the reference's
    tiles assembled by hand."""
    q, dim, dist = 700, 20, "normal"
    rs = np.random.default_rng(5)
    g = rs.standard_normal(q).astype(np.float32)
    seed = int(rng.to_uint32(rng.fold_seed(42, 1)))
    seeds = torch.tensor([seed], dtype=torch.int64)
    want_u, want_sq = map(np.asarray, ref_ops.project_flat(
        np.uint32(seed), jnp.asarray(g), dim, dist, prng="hw_emulated"))
    u, sq = rbd_project.project_flat(seeds, torch.from_numpy(g)[None], dim,
                                     dist, prng="hw_emulated")
    scale_u = np.linalg.norm(g) * np.sqrt(want_sq / q)
    assert (np.abs(u.numpy()[0] - want_u) <= U_RTOL * scale_u).all()
    np.testing.assert_allclose(sq.numpy()[0], want_sq, rtol=SQ_RTOL)

    s = (rs.standard_normal(dim) * 0.1).astype(np.float32)
    spec = ref_rng.get_prng_spec("hw_emulated")
    d_pad, q_pad = -(-dim // DB) * DB, -(-q // 512) * 512
    p = np.zeros((d_pad, q_pad), np.float32)
    for r0 in range(0, d_pad, DB):
        for c0 in range(0, q_pad, 512):
            p[r0: r0 + DB, c0: c0 + 512] = np.asarray(spec.generate_tile(
                np.uint32(seed), np.uint32(r0), np.uint32(c0), (DB, 512),
                dist))
    want = s @ p[:dim, :q]
    delta = rbd_reconstruct.reconstruct_flat(
        seeds, torch.from_numpy(s)[None], q, dist,
        prng="hw_emulated").numpy()[0]
    np.testing.assert_allclose(delta, want, rtol=0,
                               atol=DELTA_RTOL * np.abs(want).max())

    theta = rs.standard_normal(q).astype(np.float32)
    want = np.asarray(ref_ops.reconstruct_apply_flat(
        np.uint32(seed), jnp.asarray(s), jnp.asarray(theta), 0.05, dist,
        prng="hw_emulated"))
    got = rbd_reconstruct.reconstruct_apply_flat(
        seeds, torch.from_numpy(s)[None], torch.from_numpy(theta)[None],
        0.05, dist, prng="hw_emulated").numpy()[0]
    tol = (THETA_RTOL * np.abs(want - theta).max()
           + 2 * EPS32 * np.abs(theta).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("prng", ["threefry", "hw_emulated", "hw"])
def test_double_buffer_flag_keeps_the_bits(prng):
    """On the CPU the wrappers take their plain versions whatever the
    flag; both settings give the same bits (the kernels' property,
    checked on the card in tests/test_torch_gpu.py)."""
    _, plan = _plans("uniform")
    layout = plan.packed(PB, DB)
    g, theta, scale, _ = _inputs(layout, seed=2)
    seeds = projector.segment_seeds(plan, rng.fold_seed(6))
    outs = [rbd_step.project_packed(seeds, torch.from_numpy(g), layout,
                                    "uniform", prng=prng, double_buffer=d)
            for d in (None, False, True)]
    for u, sq in outs[1:]:
        assert torch.equal(u, outs[0][0]) and torch.equal(sq, outs[0][1])
    outs = [rbd_step.reconstruct_apply_packed(
        seeds, torch.from_numpy(scale[0]), torch.from_numpy(theta), layout,
        "uniform", prng=prng, double_buffer=d) for d in (False, True)]
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# resolution: reason codes, hw availability, the double-buffer auto rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("double_buffer", [None, False, True])
@pytest.mark.parametrize("prng", ["threefry", "hw", "hw_emulated"])
def test_double_buffer_auto_rule_is_the_references(double_buffer, prng):
    assert rbd_step.resolve_double_buffer(double_buffer, prng) == \
        ref_kernels._resolve_double_buffer(double_buffer,
                                           ref_rng.get_prng_spec(prng))


@pytest.mark.parametrize("prng", ["threefry", "hw", "hw_emulated"])
def test_double_buffer_auto_rule_by_device(prng):
    """``None`` resolves by the reference's rule off a card and to the
    faster, unbuffered instance on a CUDA device; an explicit setting is
    kept on both."""
    for dev in (None, "cpu", torch.device("cpu")):
        assert rbd_step.resolve_double_buffer(None, prng, dev) is (
            prng == "hw")
    for dev in ("cuda", torch.device("cuda", 0)):
        assert rbd_step.resolve_double_buffer(None, prng, dev) is False
    for dev in ("cpu", "cuda"):
        assert rbd_step.resolve_double_buffer(True, prng, dev) is True
        assert rbd_step.resolve_double_buffer(False, prng, dev) is False


REASON_CASES = [
    dict(use_packed=True, prng_impl="threefry"),
    dict(use_packed=True, prng_impl="hw"),
    dict(use_packed=True, prng_impl="hw_emulated"),
    dict(prng_impl="hw_emulated"),
    dict(prng_impl="hw"),
    dict(rbd_enabled=False, prng_impl="hw"),
]


@pytest.mark.parametrize("flags", REASON_CASES,
                         ids=[str(i) for i in range(len(REASON_CASES))])
@pytest.mark.parametrize("backend", ["kernels", "plain"])
def test_reason_codes_are_the_references(flags, backend):
    port = subspace.plan_from_flags(
        backend={"kernels": "cuda", "plain": "torch"}[backend], **flags)
    ref = ref_subspace.plan_from_flags(
        backend={"kernels": "pallas", "plain": "jnp"}[backend], **flags)
    assert (port.prng_impl, port.prng_reason) == (ref.prng_impl,
                                                  ref.prng_reason)


@pytest.mark.parametrize("backend,device,impl,marker", [
    ("cuda", "cuda", "hw", "hardware PRNG"),
    ("cuda", "cpu", "hw_emulated", "without a TPU"),
    ("cuda", None, "hw_emulated", "without a TPU"),
    ("torch", "cuda", "hw_emulated", "jnp backend"),
])
def test_optimizer_takes_hw_only_on_the_card(backend, device, impl, marker):
    """hw_prng_available is "kernel backend and tensors on a CUDA
    device" (deciding needs no card); elsewhere hw resolves as the
    reference's does off a TPU."""
    from repro_torch.core.rbd import RandomBasesTransform

    plan = _plans()[1]
    sub = subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, backend=backend, prng="hw"),
        use_packed=True, device=device)
    eplan = sub.plan_execution()
    assert eplan.strategy == "fused_packed"
    assert eplan.prng_impl == impl and marker in eplan.prng_reason
    if impl == "hw":
        assert eplan.prng_reason == rng.HW_REASON


def test_launcher_takes_prng_impl(capsys):
    res = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--data", "1",
                         "--rbd-backend", "cuda", "--rbd-dim", "64",
                         "--batch", "2", "--seq", "8", "--steps", "1",
                         "--device", "cpu", "--prng-impl", "hw"])
    out = capsys.readouterr().out.splitlines()
    ref = ref_subspace.plan_from_flags(
        use_packed=True, backend="pallas", prng_impl="hw", axis_name="data")
    assert f"prng impl: {ref.prng_impl} -- {ref.prng_reason}" in out
    assert res.sub_opt.plan_execution().prng_impl == "hw_emulated"
    assert np.isfinite(res.losses).all()
    tcfg = TrainConfig(model=None, rbd=RBDConfig(prng_impl="hw"))
    assert tcfg.rbd.prng_impl == "hw"


def test_three_hw_emulated_steps_match_reference():
    """The slice as a whole: three sharedseed packed steps of the reduced
    qwen2-0.5b under hw_emulated against the reference's jnp step, on the
    reference's parameters and batches."""
    run_three_steps_against_reference("sgd", 0.5, prng="hw_emulated")
