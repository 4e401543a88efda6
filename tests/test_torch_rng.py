"""Port parity: the counter PRNG of ``repro_torch.core.rng`` against
``repro.core.rng`` on the same inputs.

Threefry bits are bit-exact, and so are the uniform, rademacher, bernoulli
and sparse samples (they use only exact float32 steps, comparisons and
selects).  Normal samples go through log/cos/sqrt, which XLA and PyTorch
round differently in the last place: they are held to ``atol=1e-6``
(measured max 2.4e-7, about one ulp at magnitude 2-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as ref
from repro_torch.core import rng

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

DISTS = ["normal", "uniform", "bernoulli", "rademacher", "sparse"]
NORMAL_ATOL = 1e-6


def _u32(rs, n):
    return rs.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def test_threefry2x32_bit_exact():
    rs = np.random.default_rng(0)
    k0, k1 = _u32(rs, 1)[0], _u32(rs, 1)[0]
    c0, c1 = _u32(rs, 512), _u32(rs, 512)
    # counters near 2**32 and zero
    c0[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    c1[:6] = [2**32 - 1, 0, 2**31, 2**31 - 1, 1, 2**32 - 1]
    a, b = ref.threefry2x32(k0, k1, c0, c1)
    ta, tb = rng.threefry2x32(rng.as_u32(k0), rng.as_u32(k1),
                              rng.as_u32(c0), rng.as_u32(c1))
    np.testing.assert_array_equal(np.asarray(a), rng.to_uint32(ta))
    np.testing.assert_array_equal(np.asarray(b), rng.to_uint32(tb))


@pytest.mark.parametrize("parts", [(0,), (7,), (3, 12345), (2**32 - 1, 5, 9),
                                   (0xDEADBEEF, 2**31)])
def test_fold_seed_bit_exact(parts):
    assert int(np.asarray(ref.fold_seed(*parts))) == int(
        rng.to_uint32(rng.fold_seed(*parts)))


def test_fold_seed_vectorized_matches_scalar():
    base = rng.fold_seed(11)
    tags = torch.arange(5, dtype=torch.int32)
    vec = rng.to_uint32(rng.fold_seed(base, tags))
    want = [int(np.asarray(ref.fold_seed(ref.fold_seed(11), i)))
            for i in range(5)]
    np.testing.assert_array_equal(vec, np.asarray(want, np.uint32))


def test_bits_for_counters_wraparound_bit_exact():
    """row ^ ~col and counters near 2**32 (the (col, row ^ ~col) counter
    of every basis element)."""
    seed = np.uint32(0x9E3779B9)
    cols = np.array([0, 1, 2**31, 2**32 - 1, 2**32 - 512, 77],
                    np.uint32)
    rows = np.array([2**32 - 1, 0, 2**31 - 1, 2**32 - 1, 8, 2**31],
                    np.uint32)
    b0, b1 = ref._bits_for_counters(seed, cols, rows)
    t0, t1 = rng._bits_for_counters(rng.as_u32(seed), rng.as_u32(cols),
                                    rng.as_u32(rows))
    np.testing.assert_array_equal(np.asarray(b0), rng.to_uint32(t0))
    np.testing.assert_array_equal(np.asarray(b1), rng.to_uint32(t1))


@pytest.mark.parametrize("dist", DISTS)
def test_bits_to_sample(dist):
    rs = np.random.default_rng(1)
    b0, b1 = _u32(rs, 4096), _u32(rs, 4096)
    want = np.asarray(ref.bits_to_sample(dist, jnp.asarray(b0),
                                         jnp.asarray(b1)))
    got = rng.bits_to_sample(dist, rng.as_u32(b0), rng.as_u32(b1)).numpy()
    assert got.dtype == np.float32
    if dist == "normal":
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("row0,col0", [(16, 1024), (2**32 - 4, 2**32 - 300)])
def test_generate_block(dist, row0, col0):
    seed = ref.fold_seed(5)
    want = np.asarray(ref.generate_block(seed, row0, col0, (8, 512), dist))
    got = rng.generate_block(rng.fold_seed(5), row0, col0, (8, 512),
                             dist).numpy()
    if dist == "normal":
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("requested", ["threefry", "hw", "hw_emulated"])
@pytest.mark.parametrize("strategy", ["fused_packed", "coord_unfused",
                                      "materialized_packed"])
@pytest.mark.parametrize("backend,hw", [("kernels", False),
                                        ("kernels", True), ("plain", False)])
def test_resolve_prng_impl_same_reasons(requested, strategy, backend, hw):
    """The reference's impl and reason in every case but one: ``hw`` on
    the kernels with the card there runs the port's own generator and
    says so (the reference's reason names the TPU's hardware PRNG)."""
    port_backend = {"kernels": "cuda", "plain": "torch"}[backend]
    ref_backend = {"kernels": "pallas", "plain": "jnp"}[backend]
    got = rng.resolve_prng_impl(
        requested, strategy=strategy, backend=port_backend, hw_available=hw)
    want = ref.resolve_prng_impl(
        requested, strategy=strategy, backend=ref_backend, hw_available=hw)
    if (requested, strategy, backend, hw) == ("hw", "fused_packed",
                                              "kernels", True):
        assert want[0] == "hw" and got == ("hw", rng.HW_REASON)
        assert "Philox4x32-10" in got[1] and "hardware PRNG" in got[1]
    else:
        assert got == want


def test_tile_keyed_impls_not_ported():
    """The tile-keyed impls are ported: ``hw_emulated`` generates the
    reference's tile."""
    want = np.asarray(ref.get_prng_spec("hw_emulated").generate_tile(
        ref.fold_seed(3), np.uint32(8), np.uint32(512), (8, 8), "uniform"))
    got = rng.PrngSpec("hw_emulated").generate_tile(
        rng.fold_seed(3), 8, 512, (8, 8), "uniform")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", rng.PRNG_IMPLS)
@pytest.mark.parametrize("dist", rng.DISTRIBUTIONS)
def test_fast_form_is_the_stepwise_form(impl, dist):
    """The plain generator's faster form (five passes a Threefry round,
    in-place sample mapping) against its stepwise form, bit for bit, on a
    grid of seeds, columns and shapes: the bits of every distribution and
    impl, the packed blocks, the tensor-shaped rows and the folds."""
    for seed in (0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF):
        for col0, shape in ((0, (8, 700)), (1536, (16, 1029)),
                            (2 ** 31 - 512, (8, 1024))):
            got = rng.generate_tiled_block(impl, seed, col0, shape, dist)
            with rng.stepwise_form():
                want = rng.generate_tiled_block(impl, seed, col0, shape,
                                                dist)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (seed, col0, shape)
    got = rng.generate_rows_nd(7, 3, 9, (5, 11), dist)
    with rng.stepwise_form():
        want = rng.generate_rows_nd(7, 3, 9, (5, 11), dist)
        folded = rng.fold_seed(3, torch.arange(40, dtype=torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(rng.fold_seed(3, torch.arange(40, dtype=torch.int32)),
                       folded)
