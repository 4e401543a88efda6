"""Counter-based PRNG for on-demand random-basis generation (port of
``repro.core.rng``).

Every element of the virtual basis matrix is a pure function of
``(seed, row, col)``: Threefry-2x32 (20 rounds) keyed by
``(seed, seed ^ 0x85EBCA6B)`` on the counter ``(col, row ^ ~col)``, then
mapped to a sample by :func:`bits_to_sample`.  The same generator runs in
the CUDA kernels (``kernels/csrc/threefry.cuh``); this module is its
plain PyTorch version, used by the CPU tests and held against the kernels
on the card.

uint32 words are carried as ``torch.int32`` tensors holding the same bit
patterns.  PyTorch has no uint32 ``+``/``<<``/``>>`` on the CPU, and
int32 two's-complement addition, xor and left shift give exactly the
uint32 bits; the one place where the two differ, the right shift, is made
logical with a mask.  Use :func:`to_uint32` to view results as numpy
uint32.
"""

from __future__ import annotations

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
    broadcast against each other; the rounds run in place on two fresh
    buffers."""
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
        # key injection every 4 rounds
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


def sample_from_counter(seed, ctr0, ctr1=0,
                        distribution: Distribution = "normal"):
    b0, b1 = _bits_for_counters(seed, ctr0, ctr1)
    return bits_to_sample(distribution, b0,
                          b1 if N_BIT_STREAMS[distribution] == 2 else None)


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


# ---------------------------------------------------------------------------
# PRNG impls (PrngSpec) and their reason-coded resolution
# ---------------------------------------------------------------------------

PRNG_IMPLS = ("threefry", "hw", "hw_emulated")
_TILE_KEYED_TODO = ("the tile-keyed PRNG impls (hw, hw_emulated) are not "
                    "ported yet (ROADMAP.md Queue B 12)")


@dataclasses.dataclass(frozen=True)
class PrngSpec:
    """One PRNG backend.  The port generates with ``threefry`` only."""

    impl: str = "threefry"

    def __post_init__(self):
        if self.impl not in PRNG_IMPLS:
            raise ValueError(
                f"unknown prng impl {self.impl!r}; expected one of "
                f"{PRNG_IMPLS}")

    def generate_tile(self, seed, row0, col0, shape: tuple[int, int],
                      distribution: Distribution = "normal", *,
                      device=None) -> torch.Tensor:
        if self.impl != "threefry":
            raise NotImplementedError(_TILE_KEYED_TODO)
        return generate_block(seed, row0, col0, shape, distribution,
                              device=device)


@functools.cache
def get_prng_spec(impl) -> PrngSpec:
    if isinstance(impl, PrngSpec):
        return impl
    return PrngSpec(impl)


def check_threefry(impl) -> None:
    """Raise unless ``impl`` is the counter-keyed Threefry generator."""
    if get_prng_spec(impl).impl != "threefry":
        raise NotImplementedError(_TILE_KEYED_TODO)


def resolve_prng_impl(requested: str, *, strategy: str, backend: str,
                      hw_available: bool,
                      rbd_enabled: bool = True) -> tuple[str, str]:
    """Reason-coded selection of the effective PRNG impl for an execution
    strategy; the reason strings are the reference's.  The port's kernel
    backend ``"cuda"`` takes the place of the reference's ``"pallas"``."""
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
        return "hw", ("TPU hardware PRNG, tile-coordinate keyed; zero "
                      "Threefry ALU cost per basis element")
    return "hw_emulated", ("emulated hw-PRNG counter stub (CPU-testable "
                           "tile-seeding discipline)")
