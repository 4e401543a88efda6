"""The packed RBD step's kernels, each beside its plain PyTorch version.

* :func:`project_packed` -- one launch: raw projections ``u`` and squared
  row norms ``sq`` for every segment (replaces the reference's
  ``repro/kernels/rbd_step.py: project_packed -> _project_kernel``).
* :func:`reconstruct_apply_packed` -- one launch:
  ``theta' = theta - scale @ P`` for every segment (replaces
  ``reconstruct_apply_packed -> _recon_apply_kernel``).
* :func:`reconstruct_apply_packed_workers` -- one launch for K workers'
  bases: ``theta' = theta - sum_k scale_k @ P_k`` (replaces
  ``reconstruct_apply_packed_workers``, the same ``_recon_apply_kernel``
  over the worker-expanded tile tables).
* :func:`reconstruct_apply_packed_adapters` -- one launch for B serving
  adapters: row a of the (B, q_packed) output is
  ``theta - scale_a @ P_a`` (replaces ``reconstruct_apply_packed_adapters
  -> _adapter_recon_kernel``).
* :func:`project_packed_sharded`, :func:`reconstruct_apply_packed_sharded`
  and :func:`reconstruct_apply_packed_workers_sharded` -- one launch each
  on one rank's (q_slab,) slab of the model-sharded buffer
  (``core.compartments.ShardedPackedLayout``): the partial ``(u, sq)``
  that one sum over the model group completes, and the two applies on
  the slab, each slab bit-identical to the matching slice of the
  unsharded apply (replace ``project_packed_sharded``,
  ``reconstruct_apply_packed_sharded`` and
  ``reconstruct_apply_packed_workers_sharded``).
* :func:`generate_tile` -- debug entry: the bits and samples of one tile,
  to hold the device generator against :mod:`repro_torch.core.rng`.

Every wrapper and plain version takes the reference's ``prng`` (a
:class:`repro_torch.core.rng.PrngSpec` impl name or instance): the
counter-keyed ``threefry``, or the tile-keyed ``hw_emulated`` and ``hw``,
whose values are keyed by their (8, pos_block) tile; the six wrappers the
reference gives ``double_buffer`` take it too (``None``: the faster
instance on a CUDA device, the reference's rule elsewhere,
:func:`resolve_double_buffer`), and either setting gives the same bits.
The kernels take the impl as a template argument, chosen at launch.

Each wrapper takes its plain version for a tensor on the CPU, and only
then.  For a CUDA tensor it calls the kernel's op,
``torch.ops.repro_torch.<name>``, whose CUDA implementation launches the
hand-written kernel of ``csrc/rbd_step.cu`` (built by
:mod:`repro_torch.kernels.build` at first use) or raises; nothing falls
back.  An op's signature is the kernel's own: tensors (the input, the
seeds, the segment tables) and ints; its fake implementation gives the
outputs' shapes, dtypes and device and mutates nothing, so a ``meta``
tensor (the dry run's, :mod:`repro_torch.launch.dryrun`) takes the same
wrapper code and reaches the op as one node, with no kernel and no data.
``LAUNCHES[name]`` counts kernel launches and is incremented right after
a launch succeeds and nowhere else; ``CALLS[name]`` counts wrapper calls
on any device.

This module also keeps the counts, the timing and the built libraries of
the per-leaf kernels of :mod:`repro_torch.kernels.rbd_project` and
:mod:`repro_torch.kernels.rbd_reconstruct` (``csrc/rbd_flat.cu``) and of
the prefill's :mod:`repro_torch.kernels.flash_attention`
(``csrc/flash_attention.cu``): every kernel of the port is counted in the
one ``LAUNCHES``/``CALLS`` pair, and the three sources are built by one
``nvcc`` each, started together.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch import Tensor

from repro_torch.core import rng
from repro_torch.core.compartments import (PackedLayout, ShardedPackedLayout,
                                           segment_tables,
                                           sharded_segment_tables)

KERNELS = ("project_packed", "reconstruct_apply_packed",
           "reconstruct_apply_packed_workers",
           "reconstruct_apply_packed_adapters", "generate_tile",
           "project_flat", "reconstruct_flat", "reconstruct_apply_flat",
           "project_packed_sharded", "reconstruct_apply_packed_sharded",
           "reconstruct_apply_packed_workers_sharded", "flash_attention",
           "project_flat_shard", "reconstruct_flat_shard",
           "reconstruct_apply_flat_shard")
LAUNCHES = dict.fromkeys(KERNELS, 0)
CALLS = dict.fromkeys(KERNELS, 0)
# launches by variant name (:func:`variant_name`), counted with LAUNCHES
VARIANT_LAUNCHES: dict[str, int] = {}
SOURCE = "rbd_step.cu"
FLAT_SOURCE = "rbd_flat.cu"
FLASH_SOURCE = "flash_attention.cu"
# pos-blocks swept by one CUDA block of the projection kernel
PROJECT_POS_CHUNK = 64
_DIST_CODE = {"normal": 0, "uniform": 1, "bernoulli": 2, "rademacher": 2,
              "sparse": 3}
# live basis elements per chunk of the plain versions (on the CPU a chunk
# and its temporaries stay in the L2 cache)
_PLAIN_BUDGET = {"cpu": 1 << 16, "cuda": 1 << 24}
# the CPU projection's blocks kept for the apply of the same step, oldest
# dropped first
_PLAIN_KEEP_BYTES = 256 << 20
_KEPT: dict = {}
_KEPT_BYTES = [0]
_TIMING = {"on": False, "events": {k: [] for k in KERNELS}}


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        CALLS[k] = 0
    VARIANT_LAUNCHES.clear()


def variant_name(name: str, prng="threefry", double_buffer=False) -> str:
    """``name`` for the Threefry kernel, else ``name[impl]`` or
    ``name[impl,db]``."""
    impl = rng.get_prng_spec(prng).impl
    if impl == "threefry" and not double_buffer:
        return name
    return f"{name}[{impl}{',db' if double_buffer else ''}]"


def set_timing(on: bool) -> None:
    """Record a CUDA event pair around every launch while ``on``."""
    _TIMING["on"] = bool(on)
    for k in KERNELS:
        _TIMING["events"][k] = []


def kernel_times_ms() -> dict[str, list[float]]:
    """Milliseconds of every launch recorded since :func:`set_timing`."""
    if any(_TIMING["events"].values()):
        torch.cuda.synchronize()
    return {k: [a.elapsed_time(b) for a, b in v]
            for k, v in _TIMING["events"].items()}


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_P, _I, _I64, _U32, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_uint32, ctypes.c_float)
_SIGNATURES = {
    "rbd_project_packed": [_P, _P, _P, _P, _P, _P, _P, _I, _I64, _I, _I, _I,
                           _I, _I, _P, _P, _P, _P, _P],
    "rbd_reconstruct_apply_packed": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                     _I64, _I, _I, _I, _I, _I, _P],
    "rbd_reconstruct_apply_packed_workers": [_P, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _I, _I64, _I, _I, _I64, _I,
                                             _I, _I, _I, _P],
    "rbd_reconstruct_apply_packed_adapters": [_P, _P, _P, _P, _P, _P, _P, _P,
                                              _P, _I, _I64, _I, _I, _I64,
                                              _I64, _I, _I, _I, _P],
    "rbd_project_packed_sharded": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I64, _I64, _I, _I, _I, _I, _I, _P, _P,
                                   _P, _P, _P],
    "rbd_reconstruct_apply_packed_sharded": [_P, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _I, _I64, _I64, _I, _I, _I,
                                             _I, _I, _P],
    "rbd_reconstruct_apply_packed_workers_sharded": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I64, _I64, _I, _I, _I64,
        _I, _I, _I, _I, _P],
    "rbd_generate_tile": [_U32, _U32, _U32, _I, _I, _I, _I, _P, _P, _P, _P],
    "rbd_hw_transform_mismatches": [_P, _P],
    "rbd_error_string": [_I],
}
_FLAT_SIGNATURES = {
    "rbd_project_flat": [_P, _P, _I, _I64, _I, _I, _I64, _I, _I, _P, _P, _P,
                         _P, _P],
    "rbd_reconstruct_flat": [_P, _P, _I, _I64, _I, _I, _I, _P, _P],
    "rbd_reconstruct_apply_flat": [_P, _P, _P, _F32, _P, _I, _I64, _I, _I,
                                   _I, _I, _P],
    "rbd_project_flat_shard": [_P, _P, _I, _I64, _I, _I, _I64, _I, _U32,
                               _U32, _U32, _P, _P, _P, _P, _P],
    "rbd_reconstruct_flat_shard": [_P, _P, _I, _I64, _I, _I, _U32, _U32,
                                   _U32, _P, _P],
    "rbd_reconstruct_apply_flat_shard": [_P, _P, _P, _F32, _P, _I, _I64, _I,
                                         _I, _I, _U32, _U32, _U32, _P],
}
_FLASH_SIGNATURES = {
    "flash_attention_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F32, _P],
    "flash_attention_forward_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _F32, _P],
}
# csrc/rbd_common.cuh's Impl codes, passed beside the distribution's
_IMPL_CODE = {"threefry": 0, "hw_emulated": 1, "hw": 2}
_IMPL_NAME = {v: k for k, v in _IMPL_CODE.items()}
# devices whose tensors a wrapper hands to its op: CUDA (the kernel) and
# meta (the op's fake implementation: shapes only, the dry run)
KERNEL_DEVICES = ("cuda", "meta")
# the namespace of the kernels' ops, torch.ops.repro_torch
OP_NAMESPACE = "repro_torch"


@functools.cache
def libraries(csrc=None):
    """Every kernel library, built at first call (one nvcc per source,
    started together): ``{source: BuiltLibrary}``.  ``csrc``: another
    tree's kernel source directory (default this package's); an entry
    point its sources lack is left unbound."""
    from repro_torch.kernels import build

    built = build.build_all([SOURCE, FLAT_SOURCE, FLASH_SOURCE],
                            *([csrc] if csrc is not None else []))
    for src, sigs in ((SOURCE, _SIGNATURES), (FLAT_SOURCE, _FLAT_SIGNATURES),
                      (FLASH_SOURCE, _FLASH_SIGNATURES)):
        for name, argtypes in sigs.items():
            fn = getattr(built[src].lib, name, None)
            if fn is None and csrc is None:
                raise AttributeError(f"{src} has no entry {name}")
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_char_p
                              if name.endswith("error_string")
                              else ctypes.c_int)
    return built


# the kernel sources library() serves (None: this package's); set only
# inside kernels_from
_CSRC = [None]


@contextlib.contextmanager
def kernels_from(csrc):
    """Inside the block every wrapper launches the kernels built from
    ``csrc``, another tree's kernel source directory with the same C
    interface: an A/B of two trees' kernels on the same inputs through
    one set of wrappers (``chip_smoke.py --base``)."""
    prev = _CSRC[0]
    _CSRC[0] = str(csrc)
    try:
        yield libraries(_CSRC[0])
    finally:
        _CSRC[0] = prev


def library(source: str = SOURCE):
    """The built library of one source (all are built at first call)."""
    return (libraries() if _CSRC[0] is None
            else libraries(_CSRC[0]))[source]


def impl_code(prng) -> int:
    """The kernels' code of a PRNG impl name or :class:`rng.PrngSpec`."""
    return _IMPL_CODE[rng.get_prng_spec(prng).impl]


def resolve_double_buffer(double_buffer, prng, device=None) -> bool:
    """``double_buffer`` as the kernels take it; either setting gives the
    same bits.  ``None`` = auto: the reference's ``_resolve_double_buffer``
    (on for the ``hw`` impl only: its per-tile key set-up is the latency
    the pipeline hides) unless ``device`` is a CUDA device, where it is
    off for every impl -- the unbuffered instance is the faster on an
    H100 (PERF.md, PR 19: the buffer's second register set costs more
    than it hides)."""
    if double_buffer is None:
        if device is not None and torch.device(device).type == "cuda":
            return False
        return rng.get_prng_spec(prng).impl == "hw"
    return bool(double_buffer)


def hw_transform_mismatches() -> dict[str, int]:
    """Debug check on the card: the hw normal transform's fast paths
    (``csrc/threefry.cuh``: ``hw_logf``, ``hw_sqrtf``, ``hw_cosf``)
    against the CUDA math library's ``logf`` / ``sqrtf`` and ``cosf`` on
    every input the transform can give them (the 2**24 uniforms): the
    count of inputs whose radius or cosine differs in any bit, and the
    first such input of each (-1 if none)."""
    mism = torch.tensor([0, 0, -1, -1], dtype=torch.int32, device="cuda")
    rc = library().lib.rbd_hw_transform_mismatches(
        mism.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = library().lib.rbd_error_string(rc).decode()
        raise RuntimeError(f"hw transform check launch failed: {msg} ({rc})")
    r, c, r0, c0 = mism.tolist()
    return {"radius": r, "cosine": c, "first_radius": r0, "first_cosine": c0}


def _launch(name: str, fn, *args, variant=("threefry", False),
            key=None) -> None:
    """Launch, raise on a refused launch, count (``variant``: the PRNG
    impl and double-buffer flag the kernel was launched with; ``key``, if
    given, the ``VARIANT_LAUNCHES`` name instead)."""
    timed = _TIMING["on"]
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = library().lib.rbd_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    if timed:
        end.record()
        _TIMING["events"][name].append((start, end))
    LAUNCHES[name] += 1
    key = key or variant_name(name, *variant)
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


# op name -> its CUDA implementation as a plain function (the launch
# without the dispatcher: the op's host cost is the difference)
LAUNCH_FNS: dict = {}


def kernel_op(name: str, mutates=()):
    """Declare ``torch.ops.repro_torch.<name>`` with the decorated function
    as its CUDA implementation (the kernel's launch); the caller registers
    the fake implementation with ``.register_fake``.  ``mutates``: the
    arguments the kernel writes in place."""
    def register(fn):
        LAUNCH_FNS[name] = fn
        return torch.library.custom_op(f"{OP_NAMESPACE}::{name}",
                                       mutates_args=tuple(mutates),
                                       device_types="cuda")(fn)

    return register


def _check(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    if t.device.type not in KERNEL_DEVICES:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layout(layout: PackedLayout, distribution: str) -> None:
    if layout.dir_block != 8:
        raise ValueError("the CUDA kernels take dir_block == 8, got "
                         f"{layout.dir_block}")
    if distribution not in _DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")


@functools.lru_cache(maxsize=16)
def _device_tables(layout: PackedLayout, device: torch.device):
    host = segment_tables(layout, PROJECT_POS_CHUNK)
    dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    dev["n_proj_blocks"] = int(host["proj_blocks"][-1])
    dev["n_recon_blocks"] = int(host["recon_blocks"][-1])
    # dir-blocks of the largest segment: the tile keys an apply block
    # holds per seed
    dev["max_ndb"] = int(host["pdim"].max()) // layout.dir_block
    return dev


def _seeds_on(seg_seeds: torch.Tensor, n: int, device):
    seeds = rng.as_u32(seg_seeds).to(device).contiguous()
    if tuple(seeds.shape) != (n,):
        raise ValueError(f"segment seeds must have shape ({n},), got "
                         f"{tuple(seeds.shape)}")
    return seeds


# ---------------------------------------------------------------------------
# kernel 1: projection
# ---------------------------------------------------------------------------


def project_packed(seg_seeds, g_packed: torch.Tensor, layout: PackedLayout,
                   distribution: str = "normal", *, prng="threefry",
                   double_buffer=None):
    """Raw projections and squared row norms for ALL segments: returns
    ``(u, sq)``, each ``(d_packed,)`` float32.  ``seg_seeds`` holds the
    ``(n_segments,)`` uint32 segment seeds as int32 bits."""
    CALLS["project_packed"] += 1
    if g_packed.device.type == "cpu":
        return project_packed_plain(seg_seeds, g_packed, layout,
                                    distribution, prng=prng)
    _check(g_packed, "g_packed", (layout.q_packed,))
    _check_layout(layout, distribution)
    dev = g_packed.device
    t = _device_tables(layout, dev)
    seeds = _seeds_on(seg_seeds, layout.n_segments, dev)
    db = resolve_double_buffer(double_buffer, prng, dev)
    return _project_packed_op(
        g_packed, seeds, t["size"], t["param_off"], t["coord_off"],
        t["n_chunk"], t["proj_blocks"], layout.n_segments,
        t["n_proj_blocks"], layout.pos_block, layout.d_packed,
        _DIST_CODE[distribution], impl_code(prng), int(db))


@kernel_op("project_packed")
def _project_packed_op(g: Tensor, seeds: Tensor, size: Tensor,
                       param_off: Tensor, coord_off: Tensor, n_chunk: Tensor,
                       proj_blocks: Tensor, n_segments: int, n_blocks: int,
                       pos_block: int, d_packed: int, dist: int, impl: int,
                       db: int) -> tuple[Tensor, Tensor]:
    dev = g.device
    partial = torch.empty((n_blocks * 16,), dtype=torch.float32, device=dev)
    arrived = torch.zeros((d_packed // 8,), dtype=torch.int32, device=dev)
    u = torch.empty((d_packed,), dtype=torch.float32, device=dev)
    sq = torch.empty_like(u)
    _launch("project_packed", library().lib.rbd_project_packed,
            g.data_ptr(), seeds.data_ptr(), size.data_ptr(),
            param_off.data_ptr(), coord_off.data_ptr(), n_chunk.data_ptr(),
            proj_blocks.data_ptr(), n_segments, n_blocks, pos_block,
            PROJECT_POS_CHUNK, dist, impl, db, partial.data_ptr(),
            arrived.data_ptr(), u.data_ptr(), sq.data_ptr(),
            variant=(_IMPL_NAME[impl], bool(db)))
    return u, sq


@_project_packed_op.register_fake
def _(g, seeds, size, param_off, coord_off, n_chunk, proj_blocks, n_segments,
      n_blocks, pos_block, d_packed, dist, impl, db):
    u = g.new_empty((d_packed,), dtype=torch.float32)
    return u, torch.empty_like(u)


def _plain_blocks(seg_seeds, sizes, pdims, distribution: str,
                  device: torch.device, *, keep: bool, windows=None,
                  prng="threefry", pos_block: int = 512,
                  dir_block: int = 8):
    """Yield ``(segment, first column, block)`` over every segment's
    (padded dim, columns) basis blocks, in segment and column order;
    segment s has ``sizes[s]`` positions and ``pdims[s]`` rows.
    ``windows`` (a pair of per-segment arrays ``lo``, ``hi``) yields
    only the blocks that meet the columns ``[lo[s], hi[s])`` of each
    segment -- one slab's -- still whole, exactly as without a window:
    the caller cuts them after its own arithmetic, so that a column's
    result does not depend on where the window falls (torch's vectorized
    and scalar paths of a transcendental or a sum may differ by an ulp).
    For a tile-keyed ``prng`` the blocks are whole (dir_block,
    pos_block) tiles wide (``rng.generate_tiled_block``).

    On the CPU a projection (``keep=True``) keeps its blocks, the oldest
    dropped past ``_PLAIN_KEEP_BYTES``, and an apply with the same seeds
    takes them instead of generating them again: a training step then
    generates each block once (each worker's, in the K-worker step).
    Blocks are a pure function of their key, so this changes no
    result."""
    impl = rng.get_prng_spec(prng).impl
    budget = _PLAIN_BUDGET["cuda" if device.type == "cuda" else "cpu"]
    seeds = rng.as_u32(seg_seeds).cpu().reshape(-1).tolist()
    keeping = keep and device.type == "cpu"
    for s in range(len(seeds)):
        q = int(sizes[s])
        pdim = int(pdims[s])
        lo, hi = (0, q) if windows is None else (int(windows[0][s]),
                                                 int(windows[1][s]))
        cols = min(q, max(1, budget // pdim))
        if impl != "threefry":
            cols = max(pos_block, cols // pos_block * pos_block)
        for c0 in range((lo // cols) * cols, hi, cols):
            nc = min(cols, q - c0)
            key = (seeds[s], c0, nc, pdim, distribution, device.type, impl,
                   pos_block)
            blk = None if keep else _KEPT.pop(key, None)
            if blk is None:
                blk = rng.generate_tiled_block(
                    impl, seeds[s], c0, (pdim, nc), distribution,
                    dir_block=dir_block, pos_block=pos_block, device=device)
            else:
                _KEPT_BYTES[0] -= 4 * blk.numel()
            if keeping:
                _keep(key, blk)
            yield s, c0, blk


def _keep(key, blk: torch.Tensor) -> None:
    if _KEPT.pop(key, None) is not None:
        _KEPT_BYTES[0] -= 4 * blk.numel()
    _KEPT[key] = blk
    _KEPT_BYTES[0] += 4 * blk.numel()
    while _KEPT_BYTES[0] > _PLAIN_KEEP_BYTES:
        old = _KEPT.pop(next(iter(_KEPT)))
        _KEPT_BYTES[0] -= 4 * old.numel()


def _layout_blocks(seg_seeds, layout, distribution, device, prng, *, keep,
                   windows=None):
    return _plain_blocks(seg_seeds, layout.seg_size, layout.seg_pdim,
                         distribution, device, keep=keep, windows=windows,
                         prng=prng, pos_block=layout.pos_block,
                         dir_block=layout.dir_block)


def project_packed_plain(seg_seeds, g_packed: torch.Tensor,
                         layout: PackedLayout, distribution: str = "normal",
                         *, prng="threefry"):
    """Plain PyTorch version of :func:`project_packed`: per segment and
    chunk of positions, on ``g_packed``'s device."""
    dev = g_packed.device
    g_packed = g_packed.to(torch.float32)
    u = torch.zeros((layout.d_packed,), dtype=torch.float32, device=dev)
    sq = torch.zeros_like(u)
    for s, c0, blk in _layout_blocks(seg_seeds, layout, distribution, dev,
                                     prng, keep=True):
        poff = int(layout.seg_param_off[s]) + c0
        coff = int(layout.seg_coord_off[s])
        rows = slice(coff, coff + blk.shape[0])
        u[rows] += torch.mv(blk, g_packed[poff: poff + blk.shape[1]])
        sq[rows] += (blk * blk).sum(1)
    return u, sq


# ---------------------------------------------------------------------------
# kernel 2: fused reconstruct-apply
# ---------------------------------------------------------------------------


def reconstruct_apply_packed(seg_seeds, scale_packed: torch.Tensor,
                             theta_packed: torch.Tensor,
                             layout: PackedLayout,
                             distribution: str = "normal", *, out=None,
                             prng="threefry", double_buffer=None):
    """``theta - scale @ P`` for ALL segments, fused; returns ``out``.

    ``scale_packed`` ((d_packed,) float32) folds in learning rate and
    normalization and is zero on padding slots.  Positions past each
    segment's size keep their input value.  ``out=None`` allocates the
    result; ``out=theta_packed`` updates theta in place."""
    CALLS["reconstruct_apply_packed"] += 1
    if theta_packed.device.type == "cpu":
        return reconstruct_apply_packed_plain(
            seg_seeds, scale_packed, theta_packed, layout, distribution,
            out=out, prng=prng)
    _check(theta_packed, "theta_packed", (layout.q_packed,))
    _check(scale_packed, "scale_packed", (layout.d_packed,))
    _check_layout(layout, distribution)
    dev = theta_packed.device
    if out is None:
        out = torch.empty_like(theta_packed)
    _check(out, "out", (layout.q_packed,))
    t = _device_tables(layout, dev)
    seeds = _seeds_on(seg_seeds, layout.n_segments, dev)
    db = resolve_double_buffer(double_buffer, prng, dev)
    _reconstruct_apply_packed_op(
        scale_packed, theta_packed, out, seeds, t["size"], t["pdim"],
        t["param_off"], t["coord_off"], t["recon_blocks"], layout.n_segments,
        t["n_recon_blocks"], layout.pos_block, t["max_ndb"],
        _DIST_CODE[distribution], impl_code(prng), int(db))
    return out


@kernel_op("reconstruct_apply_packed", mutates=("out",))
def _reconstruct_apply_packed_op(
        scale: Tensor, theta: Tensor, out: Tensor, seeds: Tensor,
        size: Tensor, pdim: Tensor, param_off: Tensor, coord_off: Tensor,
        recon_blocks: Tensor, n_segments: int, n_blocks: int, pos_block: int,
        max_ndb: int, dist: int, impl: int, db: int) -> None:
    _launch("reconstruct_apply_packed",
            library().lib.rbd_reconstruct_apply_packed,
            scale.data_ptr(), theta.data_ptr(), out.data_ptr(),
            seeds.data_ptr(), size.data_ptr(), pdim.data_ptr(),
            param_off.data_ptr(), coord_off.data_ptr(),
            recon_blocks.data_ptr(), n_segments, n_blocks, pos_block,
            max_ndb, dist, impl, db, variant=(_IMPL_NAME[impl], bool(db)))


@_reconstruct_apply_packed_op.register_fake
def _(scale, theta, out, seeds, size, pdim, param_off, coord_off,
      recon_blocks, n_segments, n_blocks, pos_block, max_ndb, dist, impl,
      db):
    return None


def reconstruct_apply_packed_plain(seg_seeds, scale_packed: torch.Tensor,
                                   theta_packed: torch.Tensor,
                                   layout: PackedLayout,
                                   distribution: str = "normal", *,
                                   out=None, prng="threefry"):
    """Plain PyTorch version of :func:`reconstruct_apply_packed`.  Per
    segment and chunk of positions it forms each dir-block's part
    ``sum_i s_i P_ij`` and subtracts the parts in dir-block order, the
    kernel's (and the reference's) association."""
    dev = theta_packed.device
    db = layout.dir_block
    if out is None:
        out = theta_packed.to(torch.float32).clone()
    elif out is not theta_packed:
        out.copy_(theta_packed)
    scale = scale_packed.to(torch.float32)
    for s, c0, blk in _layout_blocks(seg_seeds, layout, distribution, dev,
                                     prng, keep=False):
        pdim, nc = blk.shape
        coff = int(layout.seg_coord_off[s])
        sc = scale[coff: coff + pdim].reshape(pdim, 1)
        parts = (sc * blk).reshape(pdim // db, db, nc).sum(1)
        poff = int(layout.seg_param_off[s]) + c0
        th = out[poff: poff + nc]
        for b in range(pdim // db):
            th -= parts[b]
    return out


# ---------------------------------------------------------------------------
# kernel 3: K-worker fused reconstruct-apply
# ---------------------------------------------------------------------------


def reconstruct_apply_packed_workers(wseg_seeds, scale_gathered: torch.Tensor,
                                     theta_packed: torch.Tensor,
                                     layout: PackedLayout,
                                     distribution: str = "normal", *,
                                     out=None, prng="threefry",
                                     double_buffer=None):
    """``theta - sum_k scale_k @ P_k`` for ALL segments of ALL K workers'
    bases, fused in one launch; returns ``out``.

    ``wseg_seeds``: (K * n_segments,) worker-major segment seeds (int32
    bits).  ``scale_gathered``: (K, d_packed) float32, row k worker k's
    scale (learning rate, the 1/K mean and normalization folded in, zero
    on padding slots).  Per parameter the workers' parts are subtracted
    worker-major, dir-blocks innermost -- the reference oracle's order.
    ``out`` as in :func:`reconstruct_apply_packed`."""
    CALLS["reconstruct_apply_packed_workers"] += 1
    if theta_packed.device.type == "cpu":
        return reconstruct_apply_packed_workers_plain(
            wseg_seeds, scale_gathered, theta_packed, layout, distribution,
            out=out, prng=prng)
    k_workers = int(scale_gathered.shape[0])
    _check(theta_packed, "theta_packed", (layout.q_packed,))
    _check(scale_gathered, "scale_gathered", (k_workers, layout.d_packed))
    _check_layout(layout, distribution)
    dev = theta_packed.device
    if out is None:
        out = torch.empty_like(theta_packed)
    _check(out, "out", (layout.q_packed,))
    t = _device_tables(layout, dev)
    seeds = _seeds_on(wseg_seeds, k_workers * layout.n_segments, dev)
    db = resolve_double_buffer(double_buffer, prng, dev)
    _reconstruct_apply_packed_workers_op(
        scale_gathered, theta_packed, out, seeds, t["size"], t["pdim"],
        t["param_off"], t["coord_off"], t["recon_blocks"], layout.n_segments,
        t["n_recon_blocks"], layout.pos_block, k_workers, layout.d_packed,
        t["max_ndb"], _DIST_CODE[distribution], impl_code(prng), int(db))
    return out


@kernel_op("reconstruct_apply_packed_workers", mutates=("out",))
def _reconstruct_apply_packed_workers_op(
        scale: Tensor, theta: Tensor, out: Tensor, seeds: Tensor,
        size: Tensor, pdim: Tensor, param_off: Tensor, coord_off: Tensor,
        recon_blocks: Tensor, n_segments: int, n_blocks: int, pos_block: int,
        k_workers: int, d_packed: int, max_ndb: int, dist: int, impl: int,
        db: int) -> None:
    _launch("reconstruct_apply_packed_workers",
            library().lib.rbd_reconstruct_apply_packed_workers,
            scale.data_ptr(), theta.data_ptr(), out.data_ptr(),
            seeds.data_ptr(), size.data_ptr(), pdim.data_ptr(),
            param_off.data_ptr(), coord_off.data_ptr(),
            recon_blocks.data_ptr(), n_segments, n_blocks, pos_block,
            k_workers, d_packed, max_ndb, dist, impl, db,
            variant=(_IMPL_NAME[impl], bool(db)))


@_reconstruct_apply_packed_workers_op.register_fake
def _(scale, theta, out, seeds, size, pdim, param_off, coord_off,
      recon_blocks, n_segments, n_blocks, pos_block, k_workers, d_packed,
      max_ndb, dist, impl, db):
    return None


def reconstruct_apply_packed_workers_plain(wseg_seeds,
                                           scale_gathered: torch.Tensor,
                                           theta_packed: torch.Tensor,
                                           layout: PackedLayout,
                                           distribution: str = "normal", *,
                                           out=None, prng="threefry"):
    """Plain PyTorch version of :func:`reconstruct_apply_packed_workers`:
    the single-worker plain apply once per worker, in worker order, on
    one buffer -- per parameter the kernel's worker-major order."""
    k_workers = int(scale_gathered.shape[0])
    seeds = rng.as_u32(wseg_seeds).reshape(k_workers, layout.n_segments)
    out = reconstruct_apply_packed_plain(seeds[0], scale_gathered[0],
                                         theta_packed, layout, distribution,
                                         out=out, prng=prng)
    for k in range(1, k_workers):
        reconstruct_apply_packed_plain(seeds[k], scale_gathered[k], out,
                                       layout, distribution, out=out,
                                       prng=prng)
    return out


# ---------------------------------------------------------------------------
# kernel 4: multi-adapter fused reconstruct-apply (serving)
# ---------------------------------------------------------------------------


def reconstruct_apply_packed_adapters(aseg_seeds, scale_batch: torch.Tensor,
                                      theta_packed: torch.Tensor,
                                      layout: PackedLayout,
                                      distribution: str = "normal", *,
                                      prng="threefry"):
    """B personalized buffers from one shared base in one launch: returns
    the (B, q_packed) float32 ``out`` with row a ``theta - scale_a @ P_a``.

    ``aseg_seeds``: (B * n_segments,) adapter-major segment seeds (int32
    bits), adapter a's folded from its own base seed.  ``scale_batch``:
    (B, d_packed) float32, row a adapter a's scale (normalization folded
    in, zero on padding slots).  Row a runs the single-tenant apply's
    instruction sequence, so it is bit-identical to
    :func:`reconstruct_apply_packed` on adapter a's seeds and scale.
    Padding columns copy theta.  ``out`` is always a new tensor (it
    never aliases theta).  As in the reference, no ``double_buffer``."""
    CALLS["reconstruct_apply_packed_adapters"] += 1
    if theta_packed.device.type == "cpu":
        return reconstruct_apply_packed_adapters_plain(
            aseg_seeds, scale_batch, theta_packed, layout, distribution,
            prng=prng)
    n_adapters = int(scale_batch.shape[0])
    _check(theta_packed, "theta_packed", (layout.q_packed,))
    _check(scale_batch, "scale_batch", (n_adapters, layout.d_packed))
    _check_layout(layout, distribution)
    if n_adapters < 1:
        raise ValueError("reconstruct_apply_packed_adapters needs at least "
                         "one adapter")
    dev = theta_packed.device
    t = _device_tables(layout, dev)
    seeds = _seeds_on(aseg_seeds, n_adapters * layout.n_segments, dev)
    return _reconstruct_apply_packed_adapters_op(
        scale_batch, theta_packed, seeds, t["size"], t["pdim"],
        t["param_off"], t["coord_off"], t["recon_blocks"], layout.n_segments,
        t["n_recon_blocks"], layout.pos_block, n_adapters, layout.d_packed,
        layout.q_packed, t["max_ndb"], _DIST_CODE[distribution],
        impl_code(prng))


@kernel_op("reconstruct_apply_packed_adapters")
def _reconstruct_apply_packed_adapters_op(
        scale: Tensor, theta: Tensor, seeds: Tensor, size: Tensor,
        pdim: Tensor, param_off: Tensor, coord_off: Tensor,
        recon_blocks: Tensor, n_segments: int, n_blocks: int, pos_block: int,
        n_adapters: int, d_packed: int, q_packed: int, max_ndb: int,
        dist: int, impl: int) -> Tensor:
    out = torch.empty((n_adapters, q_packed), dtype=torch.float32,
                      device=theta.device)
    _launch("reconstruct_apply_packed_adapters",
            library().lib.rbd_reconstruct_apply_packed_adapters,
            scale.data_ptr(), theta.data_ptr(), out.data_ptr(),
            seeds.data_ptr(), size.data_ptr(), pdim.data_ptr(),
            param_off.data_ptr(), coord_off.data_ptr(),
            recon_blocks.data_ptr(), n_segments, n_blocks, pos_block,
            n_adapters, d_packed, q_packed, max_ndb, dist, impl,
            variant=(_IMPL_NAME[impl], False))
    return out


@_reconstruct_apply_packed_adapters_op.register_fake
def _(scale, theta, seeds, size, pdim, param_off, coord_off, recon_blocks,
      n_segments, n_blocks, pos_block, n_adapters, d_packed, q_packed,
      max_ndb, dist, impl):
    return theta.new_empty((n_adapters, q_packed), dtype=torch.float32)


def reconstruct_apply_packed_adapters_plain(aseg_seeds,
                                            scale_batch: torch.Tensor,
                                            theta_packed: torch.Tensor,
                                            layout: PackedLayout,
                                            distribution: str = "normal", *,
                                            prng="threefry"):
    """Plain PyTorch version of :func:`reconstruct_apply_packed_adapters`:
    the single-tenant plain apply of each adapter, in adapter order, from
    the same base theta into its own output row."""
    n_adapters = int(scale_batch.shape[0])
    seeds = rng.as_u32(aseg_seeds).reshape(n_adapters, layout.n_segments)
    out = torch.empty((n_adapters, layout.q_packed), dtype=torch.float32,
                      device=theta_packed.device)
    for a in range(n_adapters):
        reconstruct_apply_packed_plain(seeds[a], scale_batch[a],
                                       theta_packed, layout, distribution,
                                       out=out[a], prng=prng)
    return out


# ---------------------------------------------------------------------------
# kernels 5-7: one slab of the model-sharded buffer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _sharded_device_tables(slayout: ShardedPackedLayout, shard: int,
                           device: torch.device):
    host = sharded_segment_tables(slayout, shard, PROJECT_POS_CHUNK)
    dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    dev["n_proj_blocks"] = int(host["proj_blocks"][-1])
    return dev


def _check_shard(slayout: ShardedPackedLayout, shard: int) -> None:
    if not 0 <= int(shard) < slayout.n_shards:
        raise ValueError(f"shard {shard} outside [0, {slayout.n_shards})")


def project_packed_sharded(seg_seeds, g_slab: torch.Tensor,
                           slayout: ShardedPackedLayout, shard: int,
                           distribution: str = "normal", *,
                           prng="threefry", double_buffer=None):
    """The PARTIAL raw projections and squared row norms of one slab:
    ``(u, sq)``, each ``(d_packed,)`` float32, holding only the
    contributions of shard ``shard``'s positions (zero for a coordinate
    with none there).  Their sum over the model group is
    :func:`project_packed`'s output.  ``g_slab`` is the (q_slab,) slice
    of the zero-padded packed gradient.  Tiles are keyed within their
    segment, as unsharded."""
    CALLS["project_packed_sharded"] += 1
    _check_shard(slayout, shard)
    if g_slab.device.type == "cpu":
        return project_packed_sharded_plain(seg_seeds, g_slab, slayout,
                                            shard, distribution, prng=prng)
    base = slayout.base
    _check(g_slab, "g_slab", (slayout.q_slab,))
    _check_layout(base, distribution)
    dev = g_slab.device
    t = _device_tables(base, dev)
    w = _sharded_device_tables(slayout, int(shard), dev)
    seeds = _seeds_on(seg_seeds, base.n_segments, dev)
    db = resolve_double_buffer(double_buffer, prng, dev)
    return _project_packed_sharded_op(
        g_slab, seeds, t["param_off"], t["coord_off"], w["col_lo"],
        w["col_hi"], w["chunk_lo"], w["n_chunk"], w["proj_blocks"],
        base.n_segments, w["n_proj_blocks"],
        slayout.slab_range(int(shard))[0], base.pos_block, base.d_packed,
        _DIST_CODE[distribution], impl_code(prng), int(db))


@kernel_op("project_packed_sharded")
def _project_packed_sharded_op(
        g: Tensor, seeds: Tensor, param_off: Tensor, coord_off: Tensor,
        col_lo: Tensor, col_hi: Tensor, chunk_lo: Tensor, n_chunk: Tensor,
        proj_blocks: Tensor, n_segments: int, n_blocks: int, slab_start: int,
        pos_block: int, d_packed: int, dist: int, impl: int,
        db: int) -> tuple[Tensor, Tensor]:
    dev = g.device
    partial = torch.empty((n_blocks * 16,), dtype=torch.float32, device=dev)
    arrived = torch.zeros((d_packed // 8,), dtype=torch.int32, device=dev)
    u = torch.empty((d_packed,), dtype=torch.float32, device=dev)
    sq = torch.empty_like(u)
    _launch("project_packed_sharded",
            library().lib.rbd_project_packed_sharded,
            g.data_ptr(), seeds.data_ptr(), param_off.data_ptr(),
            coord_off.data_ptr(), col_lo.data_ptr(), col_hi.data_ptr(),
            chunk_lo.data_ptr(), n_chunk.data_ptr(), proj_blocks.data_ptr(),
            n_segments, n_blocks, slab_start, pos_block, PROJECT_POS_CHUNK,
            dist, impl, db, partial.data_ptr(), arrived.data_ptr(),
            u.data_ptr(), sq.data_ptr(),
            variant=(_IMPL_NAME[impl], bool(db)))
    return u, sq


@_project_packed_sharded_op.register_fake
def _(g, seeds, param_off, coord_off, col_lo, col_hi, chunk_lo, n_chunk,
      proj_blocks, n_segments, n_blocks, slab_start, pos_block, d_packed,
      dist, impl, db):
    u = g.new_empty((d_packed,), dtype=torch.float32)
    return u, torch.empty_like(u)


def project_packed_sharded_plain(seg_seeds, g_slab: torch.Tensor,
                                 slayout: ShardedPackedLayout, shard: int,
                                 distribution: str = "normal", *,
                                 prng="threefry"):
    """Plain PyTorch version of :func:`project_packed_sharded`: the plain
    projection over the slab's columns only."""
    base = slayout.base
    dev = g_slab.device
    g_slab = g_slab.to(torch.float32)
    start = slayout.slab_range(int(shard))[0]
    lo, hi = slayout.seg_windows(int(shard))
    u = torch.zeros((base.d_packed,), dtype=torch.float32, device=dev)
    sq = torch.zeros_like(u)
    for s, c0, blk in _layout_blocks(seg_seeds, base, distribution, dev,
                                     prng, keep=True, windows=(lo, hi)):
        a, b = max(int(lo[s]), c0), min(int(hi[s]), c0 + blk.shape[1])
        blk = blk[:, a - c0: b - c0]
        poff = int(base.seg_param_off[s]) + a - start
        coff = int(base.seg_coord_off[s])
        rows = slice(coff, coff + blk.shape[0])
        u[rows] += torch.mv(blk, g_slab[poff: poff + b - a])
        sq[rows] += (blk * blk).sum(1)
    return u, sq


def reconstruct_apply_packed_sharded(seg_seeds, scale_packed: torch.Tensor,
                                     theta_slab: torch.Tensor,
                                     slayout: ShardedPackedLayout,
                                     shard: int,
                                     distribution: str = "normal", *,
                                     out=None, prng="threefry",
                                     double_buffer=None):
    """``slab - scale @ P_slab`` on shard ``shard``'s (q_slab,) slab, in
    one launch; returns ``out``.  ``scale_packed`` is the replicated
    (d_packed,) scale of :func:`reconstruct_apply_packed`.  The slab is
    bit-identical to the matching slice of that function's output;
    padding positions keep their value.  ``out=theta_slab`` updates the
    slab in place."""
    CALLS["reconstruct_apply_packed_sharded"] += 1
    _check_shard(slayout, shard)
    if theta_slab.device.type == "cpu":
        return reconstruct_apply_packed_sharded_plain(
            seg_seeds, scale_packed, theta_slab, slayout, shard,
            distribution, out=out, prng=prng)
    base = slayout.base
    _check(theta_slab, "theta_slab", (slayout.q_slab,))
    _check(scale_packed, "scale_packed", (base.d_packed,))
    _check_layout(base, distribution)
    dev = theta_slab.device
    if out is None:
        out = torch.empty_like(theta_slab)
    _check(out, "out", (slayout.q_slab,))
    t = _device_tables(base, dev)
    seeds = _seeds_on(seg_seeds, base.n_segments, dev)
    db = resolve_double_buffer(double_buffer, prng, dev)
    _reconstruct_apply_packed_sharded_op(
        scale_packed, theta_slab, out, seeds, t["size"], t["pdim"],
        t["param_off"], t["coord_off"], t["recon_blocks"], base.n_segments,
        slayout.blocks_per_shard, int(shard) * slayout.blocks_per_shard,
        base.pos_block, t["max_ndb"], _DIST_CODE[distribution],
        impl_code(prng), int(db))
    return out


@kernel_op("reconstruct_apply_packed_sharded", mutates=("out",))
def _reconstruct_apply_packed_sharded_op(
        scale: Tensor, theta: Tensor, out: Tensor, seeds: Tensor,
        size: Tensor, pdim: Tensor, param_off: Tensor, coord_off: Tensor,
        recon_blocks: Tensor, n_segments: int, blocks_per_shard: int,
        block0: int, pos_block: int, max_ndb: int, dist: int, impl: int,
        db: int) -> None:
    _launch("reconstruct_apply_packed_sharded",
            library().lib.rbd_reconstruct_apply_packed_sharded,
            scale.data_ptr(), theta.data_ptr(), out.data_ptr(),
            seeds.data_ptr(), size.data_ptr(), pdim.data_ptr(),
            param_off.data_ptr(), coord_off.data_ptr(),
            recon_blocks.data_ptr(), n_segments, blocks_per_shard, block0,
            pos_block, max_ndb, dist, impl, db,
            variant=(_IMPL_NAME[impl], bool(db)))


@_reconstruct_apply_packed_sharded_op.register_fake
def _(scale, theta, out, seeds, size, pdim, param_off, coord_off,
      recon_blocks, n_segments, blocks_per_shard, block0, pos_block, max_ndb,
      dist, impl, db):
    return None


def reconstruct_apply_packed_sharded_plain(seg_seeds,
                                           scale_packed: torch.Tensor,
                                           theta_slab: torch.Tensor,
                                           slayout: ShardedPackedLayout,
                                           shard: int,
                                           distribution: str = "normal", *,
                                           out=None, prng="threefry"):
    """Plain PyTorch version of :func:`reconstruct_apply_packed_sharded`:
    the plain apply over the slab's columns, the same blocks and the same
    association, so the slab is bit-identical to the matching slice of
    :func:`reconstruct_apply_packed_plain`."""
    base = slayout.base
    dev = theta_slab.device
    db = base.dir_block
    if out is None:
        out = theta_slab.to(torch.float32).clone()
    elif out is not theta_slab:
        out.copy_(theta_slab)
    scale = scale_packed.to(torch.float32)
    start = slayout.slab_range(int(shard))[0]
    lo, hi = slayout.seg_windows(int(shard))
    for s, c0, blk in _layout_blocks(seg_seeds, base, distribution, dev,
                                     prng, keep=False, windows=(lo, hi)):
        pdim, nc = blk.shape
        coff = int(base.seg_coord_off[s])
        sc = scale[coff: coff + pdim].reshape(pdim, 1)
        # the parts of the whole block, then the slab's columns of them
        parts = (sc * blk).reshape(pdim // db, db, nc).sum(1)
        a, b = max(int(lo[s]), c0), min(int(hi[s]), c0 + nc)
        parts = parts[:, a - c0: b - c0]
        poff = int(base.seg_param_off[s]) + a - start
        th = out[poff: poff + b - a]
        for i in range(pdim // db):
            th -= parts[i]
    return out


def reconstruct_apply_packed_workers_sharded(wseg_seeds,
                                             scale_gathered: torch.Tensor,
                                             theta_slab: torch.Tensor,
                                             slayout: ShardedPackedLayout,
                                             shard: int,
                                             distribution: str = "normal",
                                             *, out=None, prng="threefry",
                                             double_buffer=None):
    """``slab - sum_k scale_k @ P_k`` on shard ``shard``'s slab, in one
    launch for any K: :func:`reconstruct_apply_packed_workers`'s contract
    on a (q_slab,) slab, bit-identical to the matching slice of its
    output."""
    CALLS["reconstruct_apply_packed_workers_sharded"] += 1
    _check_shard(slayout, shard)
    if theta_slab.device.type == "cpu":
        return reconstruct_apply_packed_workers_sharded_plain(
            wseg_seeds, scale_gathered, theta_slab, slayout, shard,
            distribution, out=out, prng=prng)
    base = slayout.base
    k_workers = int(scale_gathered.shape[0])
    _check(theta_slab, "theta_slab", (slayout.q_slab,))
    _check(scale_gathered, "scale_gathered", (k_workers, base.d_packed))
    _check_layout(base, distribution)
    dev = theta_slab.device
    if out is None:
        out = torch.empty_like(theta_slab)
    _check(out, "out", (slayout.q_slab,))
    t = _device_tables(base, dev)
    seeds = _seeds_on(wseg_seeds, k_workers * base.n_segments, dev)
    db = resolve_double_buffer(double_buffer, prng, dev)
    _reconstruct_apply_packed_workers_sharded_op(
        scale_gathered, theta_slab, out, seeds, t["size"], t["pdim"],
        t["param_off"], t["coord_off"], t["recon_blocks"], base.n_segments,
        slayout.blocks_per_shard, int(shard) * slayout.blocks_per_shard,
        base.pos_block, k_workers, base.d_packed, t["max_ndb"],
        _DIST_CODE[distribution], impl_code(prng), int(db))
    return out


@kernel_op("reconstruct_apply_packed_workers_sharded", mutates=("out",))
def _reconstruct_apply_packed_workers_sharded_op(
        scale: Tensor, theta: Tensor, out: Tensor, seeds: Tensor,
        size: Tensor, pdim: Tensor, param_off: Tensor, coord_off: Tensor,
        recon_blocks: Tensor, n_segments: int, blocks_per_shard: int,
        block0: int, pos_block: int, k_workers: int, d_packed: int,
        max_ndb: int, dist: int, impl: int, db: int) -> None:
    _launch("reconstruct_apply_packed_workers_sharded",
            library().lib.rbd_reconstruct_apply_packed_workers_sharded,
            scale.data_ptr(), theta.data_ptr(), out.data_ptr(),
            seeds.data_ptr(), size.data_ptr(), pdim.data_ptr(),
            param_off.data_ptr(), coord_off.data_ptr(),
            recon_blocks.data_ptr(), n_segments, blocks_per_shard, block0,
            pos_block, k_workers, d_packed, max_ndb, dist, impl, db,
            variant=(_IMPL_NAME[impl], bool(db)))


@_reconstruct_apply_packed_workers_sharded_op.register_fake
def _(scale, theta, out, seeds, size, pdim, param_off, coord_off,
      recon_blocks, n_segments, blocks_per_shard, block0, pos_block,
      k_workers, d_packed, max_ndb, dist, impl, db):
    return None


def reconstruct_apply_packed_workers_sharded_plain(
        wseg_seeds, scale_gathered: torch.Tensor, theta_slab: torch.Tensor,
        slayout: ShardedPackedLayout, shard: int,
        distribution: str = "normal", *, out=None, prng="threefry"):
    """Plain PyTorch version of
    :func:`reconstruct_apply_packed_workers_sharded`: the plain slab apply
    once per worker, in worker order, on one buffer."""
    k_workers = int(scale_gathered.shape[0])
    seeds = rng.as_u32(wseg_seeds).reshape(k_workers, slayout.n_segments)
    out = reconstruct_apply_packed_sharded_plain(
        seeds[0], scale_gathered[0], theta_slab, slayout, shard,
        distribution, out=out, prng=prng)
    for k in range(1, k_workers):
        reconstruct_apply_packed_sharded_plain(
            seeds[k], scale_gathered[k], out, slayout, shard, distribution,
            out=out, prng=prng)
    return out


# ---------------------------------------------------------------------------
# debug: one tile of the generator
# ---------------------------------------------------------------------------


def generate_tile(seed: int, row0: int, col0: int, shape: tuple[int, int],
                  distribution: str = "normal", *, device="cuda",
                  prng="threefry"):
    """Bits ``(b0, b1)`` (int32 tensors of uint32 bits) and float32 samples
    of the (rows, cols) basis tile at (row0, col0), from the kernel on a
    CUDA device or from :mod:`repro_torch.core.rng` on the CPU.  A
    tile-keyed ``prng`` makes the whole shape one tile
    (``PrngSpec.generate_tile``); b0 and b1 are then its two streams."""
    CALLS["generate_tile"] += 1
    device = torch.device(device)
    impl = rng.get_prng_spec(prng).impl
    rows, cols = shape
    if device.type == "cpu":
        if impl == "threefry":
            r, c = rng.tile_counters(row0, col0, shape)
            b0, b1 = rng._bits_for_counters(seed, c, r)
        else:
            r, c = rng.tile_counters(0, 0, shape)
            b0, b1 = rng.tile_keyed_bits(
                impl, rng.hw_tile_key(seed, row0, col0), r, c, cols)
        return b0, b1, rng.bits_to_sample(distribution, b0, b1)
    if distribution not in _DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")
    b0 = torch.empty(shape, dtype=torch.int32, device=device)
    b1 = torch.empty_like(b0)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    _launch("generate_tile", library().lib.rbd_generate_tile,
            seed & 0xFFFFFFFF, row0 & 0xFFFFFFFF, col0 & 0xFFFFFFFF, rows,
            cols, _DIST_CODE[distribution], impl_code(prng), b0.data_ptr(),
            b1.data_ptr(), out.data_ptr(), variant=(prng, False))
    return b0, b1, out
