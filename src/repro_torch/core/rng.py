"""Counter-based PRNG for on-demand random-basis generation (port of
``repro.core.rng``).

Every element of the virtual basis matrix is a pure function of
``(seed, row, col)``: Threefry-2x32 (20 rounds) keyed by
``(seed, seed ^ 0x85EBCA6B)`` on the counter ``(col, row ^ ~col)``, then
mapped to a sample by :func:`bits_to_sample`.  The reference's
tile-keyed impls (``--prng-impl hw | hw_emulated``) are here too: the
``hw_emulated`` stub bit for bit, and ``hw`` as a tile-keyed
Philox4x32-10 (:func:`philox4x32`; Hopper has no hardware PRNG).  The
same generators run in the CUDA kernels (``kernels/csrc/threefry.cuh``,
``philox.cuh``); this module is their plain PyTorch version, used by the
CPU tests and held against the kernels on the card.

uint32 words are carried as ``torch.int32`` tensors holding the same bit
patterns.  PyTorch has no uint32 ``+``/``<<``/``>>`` on the CPU, and
int32 two's-complement addition, xor and left shift give exactly the
uint32 bits; the one place where the two differ, the right shift, is made
logical with a mask.  Use :func:`to_uint32` to view results as numpy
uint32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

Distribution = Literal["normal", "uniform", "bernoulli", "rademacher",
                       "sparse"]
DISTRIBUTIONS = ("normal", "uniform", "bernoulli", "rademacher", "sparse")

# Threefry constants (Salmon et al. 2011), 32-bit variant.
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_FOLD_INIT = 0x243F6A88      # pi fractional bits
_FOLD_SALT = 0x9E3779B9
KEY_SALT = 0x85EBCA6B

# float32 constants of the sample mapping, rounded as the reference rounds
# its Python floats into float32 arithmetic
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
SQRT3_F32 = float(np.float32(np.sqrt(3.0)))
THIRD_F32 = float(np.float32(1.0 / 3.0))


def _i32(v: int) -> int:
    """Python int -> the int32 value with the same low 32 bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def as_u32(x, device=None) -> torch.Tensor:
    """Python int, numpy array or tensor -> int32 tensor of uint32 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            return x if device is None else x.to(device)
        return _i32_tensor(x.to(torch.int64), device)
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        if a.dtype in (np.uint32, np.int32):
            return torch.from_numpy(
                np.ascontiguousarray(a).view(np.int32).copy()).to(
                    device or "cpu")
        return _i32_tensor(torch.from_numpy(a.astype(np.int64)), device)
    return torch.tensor(_i32(int(x)), dtype=torch.int32, device=device)


def _i32_tensor(x64: torch.Tensor, device) -> torch.Tensor:
    x64 = x64 & 0xFFFFFFFF
    out = torch.where(x64 >= (1 << 31), x64 - (1 << 32), x64).to(torch.int32)
    return out if device is None else out.to(device)


def to_uint32(x: torch.Tensor) -> np.ndarray:
    """int32 tensor of uint32 bits -> numpy uint32 array."""
    return x.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of uint32 bits held in int32."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 32 - r)


def threefry2x32(key0, key1, ctr0, ctr1):
    """Threefry-2x32, 20 rounds: 2x32-bit key, 2x32-bit counter -> 2x32
    bits.  Arguments are int32 tensors of uint32 bits or Python ints and
    broadcast against each other; returns two fresh tensors.

    The rounds run in place on two buffers and one scratch buffer, five
    elementwise passes a round: a rotation's two halves occupy disjoint
    bits, so ``rotl(x, r) = lshr(x, 32 - r) + x * 2**r`` (int32 wraps as
    uint32 does), the product riding the add's ``alpha``; a key injection
    is one add, and a full-size counter sum is not copied again.
    :func:`threefry2x32_stepwise` is the plain form this one is held
    against, bit for bit."""
    k0, k1 = _operand(key0), _operand(key1)
    k2 = k0 ^ k1 ^ _i32(_KS_PARITY)
    c0 = ctr0 if isinstance(ctr0, torch.Tensor) else as_u32(ctr0)
    c1 = ctr1 if isinstance(ctr1, torch.Tensor) else as_u32(ctr1)
    x0, x1 = c0 + k0, c1 + k1
    shape = torch.broadcast_shapes(x0.shape, x1.shape)
    # each sum is a fresh tensor; only a broadcast one is widened
    x0 = x0 if x0.shape == shape else x0.expand(shape).contiguous()
    x1 = x1 if x1.shape == shape else x1.expand(shape).contiguous()
    tmp = torch.empty_like(x1)
    ks = (k0, k1, k2)
    for group in range(5):
        for i in range(4):
            r = _ROTATIONS[(4 * group + i) % 8]
            x0.add_(x1)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            tmp.bitwise_and_((1 << r) - 1).add_(x1, alpha=1 << r)
            x1, tmp = tmp.bitwise_xor_(x0), x1
        # key injection every 4 rounds
        inj = group + 1
        x0.add_(ks[inj % 3])
        k = ks[(inj + 1) % 3]
        x1.add_(_i32(k + inj) if isinstance(k, int) else k + inj)
    return x0, x1


def threefry2x32_stepwise(key0, key1, ctr0, ctr1):
    """The plain form of :func:`threefry2x32`: every rotation as shifts
    and a mask, each injection as two adds, the broadcast counters
    copied.  Kept as the form the faster one is held against (the CPU
    tests and ``chip_smoke.py`` phase 2 on the card)."""
    k0, k1 = _operand(key0), _operand(key1)
    k2 = k0 ^ k1 ^ _i32(_KS_PARITY)
    c0 = ctr0 if isinstance(ctr0, torch.Tensor) else as_u32(ctr0)
    c1 = ctr1 if isinstance(ctr1, torch.Tensor) else as_u32(ctr1)
    x0, x1 = torch.broadcast_tensors(c0 + k0, c1 + k1)
    x0, x1 = x0.clone(), x1.clone()
    tmp = torch.empty_like(x1)
    ks = (k0, k1, k2)
    for group in range(5):
        for i in range(4):
            r = _ROTATIONS[(4 * group + i) % 8]
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x1.bitwise_or_(tmp).bitwise_xor_(x0)
        inj = group + 1
        x0.add_(ks[inj % 3])
        x1.add_(ks[(inj + 1) % 3]).add_(inj)
    return x0, x1


def _operand(x):
    """Tensor -> int32 tensor of uint32 bits; anything else -> the int32
    Python int with the same low 32 bits."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int32 else as_u32(x)
    return _i32(int(x))


def fold_seed(*parts) -> torch.Tensor:
    """Fold integer components (step, leaf tag, layer, ...) into one
    uint32 seed via iterated Threefry.  Parts may be Python ints or int32
    tensors of uint32 bits; tensor parts vectorize the fold."""
    seed = as_u32(_FOLD_INIT)
    for p in parts:
        p32 = _operand(p)
        a, b = threefry2x32(seed, p32, p32 ^ _i32(_FOLD_SALT), seed)
        seed = a ^ _rotl32(b, 16)
    return seed


def _bits_for_counters(seed, ctr0, ctr1=0):
    """Two uint32 bit streams for the 2-word counter grid: ctr0 = column
    (parameter position), ctr1 = row (direction index)."""
    s = _operand(seed)
    c0 = ctr0 if isinstance(ctr0, torch.Tensor) else as_u32(ctr0)
    c1 = ctr1 if isinstance(ctr1, torch.Tensor) else as_u32(ctr1)
    return threefry2x32(s, s ^ _i32(KEY_SALT), c0, c1 ^ ~c0)


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniform in (0, 1): top 24 bits, offset by
    half an ulp so 0 is excluded (safe for log() in Box-Muller)."""
    return (_shr(bits, 8).to(torch.float32) * (1.0 / (1 << 24))
            + (0.5 / (1 << 24)))


# How many independent uint32 bit streams each distribution consumes
# (the reference's contract shared by every PRNG impl).
N_BIT_STREAMS = {
    "normal": 2,      # Box-Muller: two uniforms per sample
    "uniform": 1,
    "bernoulli": 1,
    "rademacher": 1,
    "sparse": 2,      # magnitude stream + sign stream
}


def bits_to_sample(distribution: Distribution, b0, b1=None):
    """The one uint32-bits -> float32-sample mapping (see the reference's
    ``bits_to_sample``)."""
    if distribution == "normal":
        u1 = _uniform01(b0)
        u2 = _uniform01(b1)
        r = torch.sqrt(-2.0 * torch.log(u1))
        return r * torch.cos(TWO_PI_F32 * u2)
    if distribution == "uniform":
        return _uniform01(b0) * 2.0 - 1.0
    if distribution in ("bernoulli", "rademacher"):
        return torch.where((b0 & 1) != 0, 1.0, -1.0).to(torch.float32)
    if distribution == "sparse":
        u = _uniform01(b0)
        sign = torch.where((b1 & 1) != 0, SQRT3_F32, -SQRT3_F32).to(
            torch.float32)
        return torch.where(u < THIRD_F32, sign, 0.0).to(torch.float32)
    raise ValueError(f"unknown distribution {distribution!r}")


def _uniform01_(bits: torch.Tensor) -> torch.Tensor:
    """:func:`_uniform01` of a fresh bit buffer, which it consumes: the
    same float32 operations, in place where torch allows."""
    f = bits.bitwise_right_shift_(8).bitwise_and_(0xFFFFFF).to(
        torch.float32)
    return f.mul_(1.0 / (1 << 24)).add_(0.5 / (1 << 24))


def _bits_to_sample_(distribution: Distribution, b0, b1=None):
    """:func:`bits_to_sample` of fresh bit buffers, which it consumes:
    the same float32 operations in the same order, in place, so the
    samples are the same bits with fewer temporaries."""
    if distribution == "normal":
        r = _uniform01_(b0).log_().mul_(-2.0).sqrt_()
        return r.mul_(_uniform01_(b1).mul_(TWO_PI_F32).cos_())
    if distribution == "uniform":
        return _uniform01_(b0).mul_(2.0).sub_(1.0)
    return bits_to_sample(distribution, b0, b1)


def sample_from_counter(seed, ctr0, ctr1=0,
                        distribution: Distribution = "normal"):
    b0, b1 = _bits_for_counters(seed, ctr0, ctr1)
    return _bits_to_sample_(distribution, b0,
                            b1 if N_BIT_STREAMS[distribution] == 2 else None)


@contextlib.contextmanager
def stepwise_form():
    """Inside the block the plain generator runs the plain form that its
    faster one is held against: :func:`threefry2x32_stepwise`,
    :func:`philox4x32_stepwise`, the out-of-place :func:`bits_to_sample`,
    whole blocks on a CUDA device
    (no chunks, no CUDA graphs).  The bits must not change (the CPU
    tests; ``chip_smoke.py`` phase 2 on the card)."""
    g = globals()
    saved = ({k: g[k] for k in ("threefry2x32", "philox4x32",
                                "_bits_to_sample_")}, dict(GEN_CHUNK))
    g.update(threefry2x32=threefry2x32_stepwise,
             philox4x32=philox4x32_stepwise, _bits_to_sample_=bits_to_sample)
    GEN_CHUNK.update(dict.fromkeys(GEN_CHUNK))
    try:
        yield
    finally:
        g.update(saved[0])
        GEN_CHUNK.update(saved[1])


def tile_counters(row_offset, col_offset, shape, device=None):
    """(rows, 1) and (1, cols) int32 counters of a tile at (row, col)."""
    rows, cols = shape
    r = (torch.arange(rows, dtype=torch.int32, device=device)
         + _operand(row_offset)).reshape(rows, 1)
    c = (torch.arange(cols, dtype=torch.int32, device=device)
         + _operand(col_offset)).reshape(1, cols)
    return r, c


def generate_block(seed, row_offset, col_offset, shape: tuple[int, int],
                   distribution: Distribution = "normal", *,
                   device=None) -> torch.Tensor:
    """A (rows, cols) float32 tile of the virtual random basis matrix.

    Element (i, j) is keyed by the counter (col_offset + j,
    row_offset + i): rows are basis directions, columns are parameter
    positions.  Offsets may be Python ints (taken mod 2**32) or int32
    tensors of uint32 bits."""
    if isinstance(seed, torch.Tensor) and device is None:
        device = seed.device
    r, c = tile_counters(row_offset, col_offset, shape, device)
    return sample_from_counter(seed, c, r, distribution)


def linear_positions(tail_shape: tuple[int, ...], device=None
                     ) -> torch.Tensor:
    """Row-major linear position counters of a tensor-shaped compartment
    (int32 tensor of uint32 bits, shaped ``tail_shape``)."""
    shape = tuple(int(s) for s in tail_shape)
    q = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if q >= 2**32:
        raise ValueError(f"compartment too large for uint32 counters: "
                         f"{shape}")
    pos = torch.arange(q, dtype=torch.int64, device=device)
    return _i32_tensor(pos, None).reshape(shape)


def generate_rows_nd(seed, row_offset, n_rows: int,
                     tail_shape: tuple[int, ...],
                     distribution: Distribution = "normal", *,
                     device=None) -> torch.Tensor:
    """(n_rows, *tail_shape) float32 tile of the virtual basis, tensor
    shaped: row i at linear position j is ``generate_block`` element
    (i, j) of the flattened tensor."""
    if isinstance(seed, torch.Tensor) and device is None:
        device = seed.device
    shape = (n_rows,) + tuple(int(s) for s in tail_shape)
    r = (torch.arange(n_rows, dtype=torch.int32, device=device)
         + _operand(row_offset)).reshape((n_rows,) + (1,) * (len(shape) - 1))
    c = linear_positions(tail_shape, device)[None]
    return sample_from_counter(seed, c, r, distribution)


def generate_vector(seed, offset, n: int,
                    distribution: Distribution = "normal",
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """``n`` consecutive row-0 samples of the virtual basis starting at
    column ``offset`` (taken mod 2**32, so the counters wrap as uint32)."""
    if isinstance(seed, torch.Tensor) and device is None:
        device = seed.device
    ctr = torch.arange(n, dtype=torch.int32, device=device) + _operand(offset)
    return sample_from_counter(seed, ctr, 0, distribution).to(dtype)


# ---------------------------------------------------------------------------
# tile-keyed generators (hw_emulated, hw) and PRNG impls (PrngSpec)
# ---------------------------------------------------------------------------
#
# The reference's ``hw`` impl re-seeds the TPU's hardware PRNG per
# (DB, PB) basis tile with (seed, row0, col0) and draws
# ``N_BIT_STREAMS[dist]`` whole-tile bit blocks; ``hw_emulated`` is its
# Threefry stub with the same tile-seeding discipline.  Both key every
# value by its TILE's identity, so the same tile regenerates the same bits
# in the projection and in the apply, but values depend on the tiling.
#
# ``hw_emulated`` is ported bit for bit.  Hopper has no hardware PRNG, so
# the port's ``hw`` is a tile-keyed Philox4x32-10 (Salmon et al. 2011):
# key (k, k ^ 0x85EBCA6B) with k = hw_tile_key(seed, row0, col0), counter
# (c, r // 2, 0, 0) for within-tile row r and column c; words 0-1 are the
# (b0, b1) streams of the even row of the pair and words 2-3 those of the
# odd row, so one call serves two rows at one column.  Its bits are not
# the TPU's.

PRNG_IMPLS = ("threefry", "hw", "hw_emulated")
_TILE_SALT_ROW = 0xA511E9B3
# Philox4x32 multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10
HW_REASON = ("tile-coordinate keyed Philox4x32-10 in the CUDA kernels "
             "(Hopper has no hardware PRNG); no Threefry per basis element")


def hw_tile_key(seed, row0, col0):
    """Fold a tile's (seed, row0, col0) identity into one uint32 key (the
    reference's emulated analogue of ``pltpu.prng_seed(seed, row0,
    col0)``).  Arguments broadcast; int32 tensors of uint32 bits or ints."""
    s = _operand(seed)
    r0 = row0 if isinstance(row0, torch.Tensor) else as_u32(row0)
    c0 = col0 if isinstance(col0, torch.Tensor) else as_u32(col0)
    a, b = threefry2x32(s, r0 ^ _i32(_TILE_SALT_ROW), c0,
                        s ^ _i32(_FOLD_SALT))
    return a ^ _rotl32(b, 16)


def emulated_random_bits(key, draw: int, idx: torch.Tensor) -> torch.Tensor:
    """uint32 bits of one emulated ``prng_random_bits`` draw: Threefry
    keyed by the tile key on the counter (within-tile index, draw); only
    the first output word is used."""
    k = _operand(key)
    b0, _ = threefry2x32(k, k ^ _i32(KEY_SALT), idx, draw)
    return b0


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding the uint32 value."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _mulhilo(m: int, x64):
    """(hi, lo) words of the 64-bit product m * x of two uint32 values:
    one int64 product, which wraps modulo 2^64 as torch's integer
    arithmetic does (the int32 adds of :func:`threefry2x32` wrap the same
    way), then masked shifts, so the sign of the wrapped product never
    shows.  Random123's known answers and the kernels' bits hold it."""
    p = x64 * m
    return (p >> 32) & 0xFFFFFFFF, p & 0xFFFFFFFF


def philox4x32(ctr, key, rounds: int = PHILOX_ROUNDS):
    """Philox4x32 (Random123): four uint32 counter words and two key words
    -> four uint32 words.  Arguments are int32 tensors of uint32 bits or
    ints and broadcast; results are int32 tensors of uint32 bits.

    The words ride int64 with their high halves left dirty between rounds:
    a round reads a word's low half only (an XOR, or the operand of a
    product, which is masked first), so only the multipliers' operands and
    the results are masked -- two passes a round fewer than
    :func:`philox4x32_stepwise`, the same bits."""
    c = [_word(x) for x in ctr]
    k0, k1 = (_word(x) for x in key)
    for _ in range(rounds):
        p0, p1 = _low_product(PHILOX_M[0], c[0]), _low_product(PHILOX_M[1],
                                                               c[2])
        c = [(p1 >> 32) ^ c[1] ^ k0, p1, (p0 >> 32) ^ c[3] ^ k1, p0]
        k0 = (k0 + PHILOX_W[0]) & 0xFFFFFFFF
        k1 = (k1 + PHILOX_W[1]) & 0xFFFFFFFF
    c = [w if isinstance(w, torch.Tensor) else torch.tensor(w & 0xFFFFFFFF)
         for w in c]
    return tuple(_i32_tensor(w, None) for w in torch.broadcast_tensors(*c))


def _low_product(m: int, x):
    """The 64-bit product of ``m`` and the low 32 bits of ``x`` (wrapping
    modulo 2^64 in int64, in place on the masked copy)."""
    if isinstance(x, torch.Tensor):
        return (x & 0xFFFFFFFF).mul_(m)
    return (x & 0xFFFFFFFF) * m


def philox4x32_stepwise(ctr, key, rounds: int = PHILOX_ROUNDS):
    """The plain form of :func:`philox4x32`: every word masked to 32 bits
    after every round (see :func:`stepwise_form`)."""
    c = [_word(x) for x in ctr]
    k0, k1 = (_word(x) for x in key)
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + PHILOX_W[0]) & 0xFFFFFFFF
        k1 = (k1 + PHILOX_W[1]) & 0xFFFFFFFF
    c = [w if isinstance(w, torch.Tensor) else torch.tensor(w) for w in c]
    return tuple(_i32_tensor(w, None) for w in torch.broadcast_tensors(*c))


def _word(x):
    """A Philox word: a tensor as int64 holding its uint32 value, anything
    else as a Python int (so constant words take no device)."""
    if isinstance(x, torch.Tensor):
        return _u64(x if x.dtype == torch.int32 else as_u32(x))
    return int(x) & 0xFFFFFFFF


def tile_keyed_bits(impl: str, keys, r, c, width: int, n_streams: int = 2):
    """Bit streams (b0, b1) of the values at within-tile row ``r`` and
    column ``c`` of tiles keyed ``keys`` (all broadcast; ``width`` is the
    full tile width, which keys the emulated stream's index even past a
    segment's ragged end).  ``b1`` is None when ``n_streams`` is 1."""
    k = _operand(keys)
    r = r if isinstance(r, torch.Tensor) else as_u32(r)
    c = c if isinstance(c, torch.Tensor) else as_u32(c)
    if impl == "hw_emulated":
        idx = r * width + c
        b0 = emulated_random_bits(k, 0, idx)
        b1 = emulated_random_bits(k, 1, idx) if n_streams == 2 else None
        return b0, b1
    if impl == "hw":
        w = philox4x32((c, _shr(r, 1), 0, 0), (k, k ^ _i32(KEY_SALT)))
        even = (r & 1) == 0
        return torch.where(even, w[0], w[2]), torch.where(even, w[1], w[3])
    raise ValueError(f"{impl!r} is not a tile-keyed prng impl")


def _tile_samples(impl, seed, row0, col0, shape, distribution, device):
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int32, device=device).reshape(rows, 1)
    c = torch.arange(cols, dtype=torch.int32, device=device).reshape(1, cols)
    key = hw_tile_key(seed, row0, col0)
    if isinstance(key, torch.Tensor):
        key = key.to(device)
    b0, b1 = tile_keyed_bits(impl, key, r, c, cols,
                             N_BIT_STREAMS[distribution])
    return bits_to_sample(distribution, b0, b1)


def generate_tiled_block(impl: str, seed, col0: int, shape,
                         distribution: Distribution = "normal", *,
                         dir_block: int = 8, pos_block: int = 512,
                         device=None) -> torch.Tensor:
    """Rows ``[0, rows)`` and columns ``[col0, col0 + cols)`` of a
    segment's virtual basis, float32, as the packed kernels see it: for a
    tile-keyed ``impl`` each (dir_block, pos_block) tile at (row0, col0)
    is keyed by its own identity (``col0`` must be a multiple of
    ``pos_block``; a ragged last tile is generated as far as ``cols``
    reaches, keyed by the full tile width); for ``threefry`` this is
    :func:`generate_block`.

    On a CUDA device a block wider than ``GEN_CHUNK[impl]`` values is
    made in column chunks of that many values (whole tiles for a
    tile-keyed ``impl``), each chunk one replay of a CUDA graph of its
    elementwise passes (:func:`_chunk_graph`) written into the block: the
    passes run in the card's L2 cache, and the host's cost per operation
    does not pace them.  Every value is a pure function of its key and
    counters, and an elementwise CUDA kernel computes each element alike
    wherever it lies, so the bits are those of the whole block."""
    if isinstance(seed, torch.Tensor) and device is None:
        device = seed.device
    rows, cols = shape
    dev = torch.device(device) if device is not None else torch.device("cpu")
    chunk = GEN_CHUNK.get(impl) if dev.type == "cuda" else None
    if chunk is None or rows * cols <= chunk:
        return _generate_tiled_block(impl, seed, col0, shape, distribution,
                                     dir_block=dir_block,
                                     pos_block=pos_block, device=device)
    sub = max(1, chunk // rows)
    if impl != "threefry":
        sub = max(pos_block, sub // pos_block * pos_block)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    for c in range(0, cols, sub):
        n = min(sub, cols - c)
        if n == sub:
            out[:, c: c + n] = _graphed_chunk(
                impl, seed, col0 + c, (rows, n), distribution, dir_block,
                pos_block, dev)
        else:
            out[:, c: c + n] = _generate_tiled_block(
                impl, seed, col0 + c, (rows, n), distribution,
                dir_block=dir_block, pos_block=pos_block, device=dev)
    return out


# values a chunk of generate_tiled_block holds on a CUDA device, by PRNG
# impl (None: the whole block at once); a dict so that a measurement can
# compare sizes -- the bits do not depend on them
GEN_CHUNK = {"threefry": 1 << 21, "hw_emulated": 1 << 21, "hw": None}


def _graphed_chunk(impl, seed, col0: int, shape, distribution, dir_block,
                   pos_block, device) -> torch.Tensor:
    """One chunk of :func:`generate_tiled_block` through its CUDA graph:
    the seed and first column are written into the graph's device
    scalars, then it replays.  Returns the graph's output buffer, which
    the next replay overwrites."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    graph, gseed, gcol, gout = _chunk_graph(
        impl, int(shape[0]), int(shape[1]), distribution, dir_block,
        pos_block, index)
    if isinstance(seed, torch.Tensor):
        gseed.copy_(as_u32(seed).reshape(()))
    else:
        gseed.fill_(_i32(int(seed)))
    gcol.fill_(_i32(int(col0)))
    graph.replay()
    return gout


@functools.lru_cache(maxsize=8)
def _chunk_graph(impl: str, rows: int, cols: int, distribution: str,
                 dir_block: int, pos_block: int, index: int):
    """A CUDA graph of :func:`_generate_tiled_block` at ``(rows, cols)``,
    its seed and first column read from two int32 device scalars.
    Returns ``(graph, seed, col0, out)``."""
    device = torch.device("cuda", index)
    seed = torch.zeros((), dtype=torch.int32, device=device)
    col0 = torch.zeros((), dtype=torch.int32, device=device)

    def gen():
        return _generate_tiled_block(impl, seed, col0, (rows, cols),
                                     distribution, dir_block=dir_block,
                                     pos_block=pos_block, device=device)

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm-up outside the capture
        gen()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gen()
    return graph, seed, col0, out


def _generate_tiled_block(impl: str, seed, col0: int, shape,
                          distribution: Distribution = "normal", *,
                          dir_block: int = 8, pos_block: int = 512,
                          device=None) -> torch.Tensor:
    """One chunk of :func:`generate_tiled_block`."""
    if isinstance(seed, torch.Tensor) and device is None:
        device = seed.device
    rows, cols = shape
    if impl == "threefry":
        return generate_block(seed, 0, col0, shape, distribution,
                              device=device)
    misaligned = (not isinstance(col0, torch.Tensor)) and col0 % pos_block
    if misaligned or rows % dir_block:
        raise ValueError(f"tile-keyed block at column {col0} with {rows} "
                         f"rows is not aligned to ({dir_block}, "
                         f"{pos_block}) tiles")
    n_tr, n_tc = rows // dir_block, -(-cols // pos_block)
    tr = torch.arange(n_tr, dtype=torch.int32, device=device) * dir_block
    tc = (torch.arange(n_tc, dtype=torch.int64, device=device) * pos_block
          + col0)
    keys = hw_tile_key(_operand(seed), tr.reshape(n_tr, 1),
                       _i32_tensor(tc, None).reshape(1, n_tc))
    if impl == "hw":
        # one Philox call per row pair: words 0-1 the even row's streams,
        # words 2-3 the odd row's; laid out (tile row, row pair, tile
        # column, column in tile) so each key broadcasts over its tile,
        # the ragged last tile generated whole and cut
        half = dir_block // 2
        k = keys.reshape(n_tr, 1, n_tc, 1)
        j = torch.arange(half, dtype=torch.int32,
                         device=device).reshape(1, half, 1, 1)
        cin = torch.arange(pos_block, dtype=torch.int32, device=device)
        w = philox4x32((cin, j, 0, 0), (k, k ^ _i32(KEY_SALT)))
        b0, b1 = (torch.stack([w[a], w[a + 2]], 2)
                  .reshape(rows, n_tc * pos_block)[:, :cols]
                  for a in (0, 1))
        return _bits_to_sample_(distribution, b0, b1)
    c = torch.arange(cols, dtype=torch.int32, device=device)
    r = torch.arange(rows, dtype=torch.int32, device=device)
    ek = keys[(r // dir_block).reshape(rows, 1),
              (c // pos_block).reshape(1, cols)]
    b0, b1 = tile_keyed_bits(impl, ek, (r % dir_block).reshape(rows, 1),
                             (c % pos_block).reshape(1, cols), pos_block,
                             N_BIT_STREAMS[distribution])
    return _bits_to_sample_(distribution, b0, b1)


@dataclasses.dataclass(frozen=True)
class PrngSpec:
    """One PRNG backend (the reference's ``PrngSpec``)."""

    impl: str = "threefry"

    def __post_init__(self):
        if self.impl not in PRNG_IMPLS:
            raise ValueError(
                f"unknown prng impl {self.impl!r}; expected one of "
                f"{PRNG_IMPLS}")

    @property
    def in_kernel_only(self) -> bool:
        """True for ``hw``: the reference runs it only inside real TPU
        kernels, and :func:`resolve_prng_impl` gives it only to the CUDA
        kernels on a card.  The port's plain version of it exists all the
        same (the kernels are held against it)."""
        return self.impl == "hw"

    @property
    def tile_keyed(self) -> bool:
        """True when bits are keyed by tile coordinates rather than by
        per-element counters: values then depend on the tiling."""
        return self.impl != "threefry"

    def generate_tile(self, seed, row0, col0, shape: tuple[int, int],
                      distribution: Distribution = "normal", *,
                      device=None) -> torch.Tensor:
        """A (rows, cols) float32 basis tile at (row0, col0) of its
        segment: position-keyed :func:`generate_block` for ``threefry``;
        for the tile-keyed impls the tile's identity keys the stream and
        the whole shape is one tile."""
        if self.impl == "threefry":
            return generate_block(seed, row0, col0, shape, distribution,
                                  device=device)
        if isinstance(seed, torch.Tensor) and device is None:
            device = seed.device
        return _tile_samples(self.impl, seed, row0, col0, shape,
                             distribution, device)


@functools.cache
def get_prng_spec(impl) -> PrngSpec:
    if isinstance(impl, PrngSpec):
        return impl
    return PrngSpec(impl)


def resolve_prng_impl(requested: str, *, strategy: str, backend: str,
                      hw_available: bool,
                      rbd_enabled: bool = True) -> tuple[str, str]:
    """Reason-coded selection of the effective PRNG impl for an execution
    strategy; the reason strings are the reference's, except that of the
    port's own ``hw`` (:data:`HW_REASON`).  The port's kernel backend
    ``"cuda"`` takes the place of the reference's ``"pallas"``, and
    ``hw_available`` means that backend with the tensors on a card."""
    if requested not in PRNG_IMPLS:
        raise ValueError(
            f"unknown prng impl {requested!r}; expected one of {PRNG_IMPLS}")
    if not rbd_enabled:
        return "threefry", ("rbd disabled -> no basis generation, prng "
                            "unused")
    if strategy == "materialized_packed":
        return "threefry", (
            "materialized basis (trajectory_pca/gradient_informed) is "
            "stored and refreshed, not regenerated per step -> counter-"
            "keyed Threefry used only for the initial basis draw")
    if requested == "threefry":
        return "threefry", "counter-keyed Threefry (bit-stable default)"
    if strategy != "fused_packed":
        return "threefry", (
            f"{requested} requested but the {strategy} strategy takes "
            "per-leaf position-keyed paths -> threefry (tile-keyed PRNG "
            "needs the packed tile tables)")
    if requested == "hw":
        if backend != "cuda":
            return "hw_emulated", (
                "hw PRNG requested on the jnp backend -> emulated "
                "counter stub (same tile-seeding discipline, no TPU "
                "kernel to run the real PRNG in)")
        if not hw_available:
            return "hw_emulated", (
                "hw PRNG requested without a TPU (interpret-mode "
                "kernels) -> emulated counter stub")
        return "hw", HW_REASON
    return "hw_emulated", ("emulated hw-PRNG counter stub (CPU-testable "
                           "tile-seeding discipline)")
