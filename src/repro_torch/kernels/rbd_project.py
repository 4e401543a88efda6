"""Per-leaf projection kernel, beside its plain PyTorch version.

* :func:`project_flat` -- one launch per ``LeafPlan``: raw projections
  ``u_s = P_s g_s`` and squared row norms of each of the leaf's
  ``n_stack`` compartments (replaces the reference's
  ``repro/kernels/rbd_project.py: project_flat -> _project_kernel``, which
  the reference vmaps over the stacked axis).
* :func:`project_flat_shard` -- its shard instance (the same kernel with
  the template flag ``SHARD``): the partial ``(u, sq)`` of a leaf shard
  under pjit-style parameter sharding, the basis values generated at the
  compartment's global columns (:func:`shard_columns`); one sum over the
  model group completes them.  Threefry only.

Compartment s generates its basis from ``seeds[s]`` (``fold_seed(
leaf_seed, s)`` for a stacked leaf, the leaf seed for an unstacked one)
over its unpadded ``(q,)`` row of the ``(n_stack, q)`` gradient.  The
wrapper takes its plain version for a tensor on the CPU, and only then;
for a CUDA tensor it calls its op (``torch.ops.repro_torch.project_flat``
and ``.project_flat_shard``), which launches ``rbd_project_flat`` of
``csrc/rbd_flat.cu`` or raises (a meta tensor reaches the op's fake
implementation, see :mod:`repro_torch.kernels.rbd_step`).  Launches,
calls and CUDA-event times are counted in
:mod:`repro_torch.kernels.rbd_step`'s ``LAUNCHES``/``CALLS``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core import rng
from repro_torch.kernels import rbd_step

DIR_BLOCK = 8      # rows of P per coordinate block
POS_BLOCK = 512    # positions per tile of the reference's grid
# pos-blocks swept by one CUDA block: the packed projection's chunk, so the
# two kernels' sums run in the same order
POS_CHUNK = rbd_step.PROJECT_POS_CHUNK


def padded_dim(dim: int) -> int:
    return -(-int(dim) // DIR_BLOCK) * DIR_BLOCK


def check_flat(name: str, t: torch.Tensor, n_stack: int, q: int,
               dtypes=(torch.float32,)) -> None:
    if t.device.type not in rbd_step.KERNEL_DEVICES:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes or tuple(t.shape) != (n_stack, q):
        raise ValueError(f"{name} must be one of {dtypes} of shape "
                         f"{(n_stack, q)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def project_flat(seeds, g: torch.Tensor, dim: int,
                 distribution: str = "normal", *, prng="threefry"):
    """``(u, sq)``, each ``(n_stack, dim)`` float32, for the ``(n_stack,
    q)`` float32 gradient rows ``g``; ``seeds`` holds the ``(n_stack,)``
    uint32 compartment seeds as int32 bits.  ``prng`` as in
    :func:`repro_torch.kernels.rbd_step.project_packed` (tiles of (8,
    512) at (dir-block, pos-block) of each compartment)."""
    rbd_step.CALLS["project_flat"] += 1
    if g.device.type == "cpu":
        return project_flat_plain(seeds, g, dim, distribution, prng=prng)
    n_stack, q = (int(x) for x in g.shape)
    check_flat("g", g, n_stack, q)
    if distribution not in rbd_step._DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")
    dev = g.device
    seeds = rbd_step._seeds_on(seeds, n_stack, dev)
    n_db = padded_dim(dim) // DIR_BLOCK
    chunk_cols = POS_CHUNK * POS_BLOCK
    # under hw a CUDA block holds the round keys of the pos-blocks its
    # chunk meets: whole pos-blocks, at most 64 (csrc/rbd_flat.cu)
    assert chunk_cols % POS_BLOCK == 0 and chunk_cols <= 64 * POS_BLOCK
    n_chunk = max(1, -(-q // chunk_cols))
    u, sq = _project_flat_op(g, seeds, n_db, n_chunk, chunk_cols,
                             rbd_step._DIST_CODE[distribution],
                             rbd_step.impl_code(prng))
    return u[:, :dim], sq[:, :dim]


def _flat_buffers(g: Tensor, n_db: int, n_chunk: int):
    """The projection kernels' scratch (partials, arrival counters) and
    their padded ``(n_stack, n_db * 8)`` outputs ``u`` and ``sq``."""
    n_stack, dev = int(g.shape[0]), g.device
    partial = torch.empty((n_stack * n_db * n_chunk * 2 * DIR_BLOCK,),
                          dtype=torch.float32, device=dev)
    arrived = torch.zeros((n_stack * n_db,), dtype=torch.int32, device=dev)
    u = torch.empty((n_stack, n_db * DIR_BLOCK), dtype=torch.float32,
                    device=dev)
    return partial, arrived, u, torch.empty_like(u)


@rbd_step.kernel_op("project_flat")
def _project_flat_op(g: Tensor, seeds: Tensor, n_db: int, n_chunk: int,
                     chunk_cols: int, dist: int,
                     impl: int) -> tuple[Tensor, Tensor]:
    n_stack, q = (int(x) for x in g.shape)
    partial, arrived, u, sq = _flat_buffers(g, n_db, n_chunk)
    rbd_step._launch(
        "project_flat",
        rbd_step.library(rbd_step.FLAT_SOURCE).lib.rbd_project_flat,
        g.data_ptr(), seeds.data_ptr(), n_stack, q, n_db, n_chunk,
        chunk_cols, dist, impl, partial.data_ptr(), arrived.data_ptr(),
        u.data_ptr(), sq.data_ptr(),
        variant=(rbd_step._IMPL_NAME[impl], False))
    return u, sq


@_project_flat_op.register_fake
def _(g, seeds, n_db, n_chunk, chunk_cols, dist, impl):
    u = g.new_empty((int(g.shape[0]), n_db * DIR_BLOCK), dtype=torch.float32)
    return u, torch.empty_like(u)


def check_colmap(colmap, q_local: int, prng) -> tuple[int, int, int]:
    """A shard's column map ``(w, W, off)`` as three ints, after the
    checks the shard instances need: Threefry (the tile-keyed impls key
    a value by its tile of the whole compartment, and no per-leaf plan
    resolves to them), ``w`` dividing ``q_local``, columns below 2**32."""
    impl = rng.get_prng_spec(prng).impl
    if impl != "threefry":
        raise ValueError(
            f"the shard instances take the threefry impl, not {impl!r}: a "
            "tile-keyed value is keyed by its (8, 512) tile of the whole "
            "compartment, and every per-leaf strategy resolves to threefry")
    w, big_w, off = (int(x) for x in colmap)
    if w < 1 or q_local % w or off + w > big_w:
        raise ValueError(f"column map {colmap} does not fit {q_local} local "
                         "positions")
    if (q_local // w - 1) * big_w + off + w > 2 ** 32:
        raise ValueError(f"column map {colmap}: columns past 2**32")
    return w, big_w, off


def shard_columns(colmap, c0: int, n: int, device) -> torch.Tensor:
    """The global columns of local positions ``[c0, c0 + n)`` of a leaf
    shard: ``(j // w) * W + off + j % w`` as int32 bits (``colmap`` is
    ``(w, W, off)``)."""
    w, big_w, off = colmap
    j = torch.arange(c0, c0 + n, dtype=torch.int64, device=device)
    return rng.as_u32((j // w) * big_w + off + j % w)


def shard_blocks(seeds, n_stack: int, q: int, dim: int, distribution: str,
                 device, colmap):
    """Yield ``(compartment, first local column, block)`` over the (padded
    dim, columns) basis blocks of every compartment of a leaf shard, each
    value generated at its global column (``rng.sample_from_counter`` on
    the mapped counters), a block of at most the plain versions' budget
    of values; where a block ends does not change a value (the plain
    reconstructions are position-independent)."""
    device = torch.device(device)
    pdim = padded_dim(dim)
    budget = rbd_step._PLAIN_BUDGET[device.type]
    cols = min(q, max(1, budget // pdim))
    rows = torch.arange(pdim, dtype=torch.int32, device=device)[:, None]
    for s, seed in enumerate(rng.as_u32(seeds).cpu().reshape(-1).tolist()):
        for c0 in range(0, q, cols):
            nc = min(cols, q - c0)
            gcol = shard_columns(colmap, c0, nc, device)[None]
            yield s, c0, rng.sample_from_counter(seed, gcol, rows,
                                                 distribution)


def flat_blocks(seeds, n_stack: int, q: int, dim: int, distribution: str,
                device, *, keep: bool, prng="threefry"):
    """Yield ``(compartment, first column, block)`` over the (padded dim,
    columns) basis blocks of every compartment (see
    ``rbd_step._plain_blocks``: on the CPU a projection keeps its blocks
    for the apply of the same step)."""
    return rbd_step._plain_blocks(seeds, [q] * n_stack,
                                  [padded_dim(dim)] * n_stack, distribution,
                                  torch.device(device), keep=keep,
                                  prng=prng, pos_block=POS_BLOCK,
                                  dir_block=DIR_BLOCK)


def project_flat_plain(seeds, g: torch.Tensor, dim: int,
                       distribution: str = "normal", *, prng="threefry"):
    """Plain PyTorch version of :func:`project_flat`, on ``g``'s device."""
    n_stack, q = (int(x) for x in g.shape)
    g = g.to(torch.float32)
    u = torch.zeros((n_stack, padded_dim(dim)), dtype=torch.float32,
                    device=g.device)
    sq = torch.zeros_like(u)
    for s, c0, blk in flat_blocks(seeds, n_stack, q, dim, distribution,
                                  g.device, keep=True, prng=prng):
        u[s] += torch.mv(blk, g[s, c0: c0 + blk.shape[1]])
        sq[s] += (blk * blk).sum(1)
    return u[:, :dim], sq[:, :dim]


def project_flat_shard(seeds, g: torch.Tensor, dim: int,
                       distribution: str = "normal", *, colmap,
                       prng="threefry"):
    """The partial ``(u, sq)``, each ``(n_stack, dim)`` float32, of the
    ``(n_stack, q_local)`` rows of a leaf shard: the shard instance of
    :func:`project_flat`, its basis values at the global columns that
    ``colmap = (w, W, off)`` gives each local position (module
    docstring)."""
    rbd_step.CALLS["project_flat_shard"] += 1
    n_stack, q = (int(x) for x in g.shape)
    colmap = check_colmap(colmap, q, prng)
    if g.device.type == "cpu":
        return project_flat_shard_plain(seeds, g, dim, distribution,
                                        colmap=colmap)
    check_flat("g", g, n_stack, q)
    if distribution not in rbd_step._DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")
    dev = g.device
    seeds = rbd_step._seeds_on(seeds, n_stack, dev)
    n_db = padded_dim(dim) // DIR_BLOCK
    chunk_cols = POS_CHUNK * POS_BLOCK
    n_chunk = max(1, -(-q // chunk_cols))
    u, sq = _project_flat_shard_op(g, seeds, n_db, n_chunk, chunk_cols,
                                   rbd_step._DIST_CODE[distribution],
                                   *colmap)
    return u[:, :dim], sq[:, :dim]


@rbd_step.kernel_op("project_flat_shard")
def _project_flat_shard_op(g: Tensor, seeds: Tensor, n_db: int,
                           n_chunk: int, chunk_cols: int, dist: int, w: int,
                           big_w: int, off: int) -> tuple[Tensor, Tensor]:
    n_stack, q = (int(x) for x in g.shape)
    partial, arrived, u, sq = _flat_buffers(g, n_db, n_chunk)
    rbd_step._launch(
        "project_flat_shard",
        rbd_step.library(rbd_step.FLAT_SOURCE).lib.rbd_project_flat_shard,
        g.data_ptr(), seeds.data_ptr(), n_stack, q, n_db, n_chunk,
        chunk_cols, dist, w, big_w, off, partial.data_ptr(),
        arrived.data_ptr(), u.data_ptr(), sq.data_ptr())
    return u, sq


@_project_flat_shard_op.register_fake
def _(g, seeds, n_db, n_chunk, chunk_cols, dist, w, big_w, off):
    u = g.new_empty((int(g.shape[0]), n_db * DIR_BLOCK), dtype=torch.float32)
    return u, torch.empty_like(u)


def project_flat_shard_plain(seeds, g: torch.Tensor, dim: int,
                             distribution: str = "normal", *, colmap,
                             prng="threefry"):
    """Plain PyTorch version of :func:`project_flat_shard`, on ``g``'s
    device."""
    n_stack, q = (int(x) for x in g.shape)
    colmap = check_colmap(colmap, q, prng)
    g = g.to(torch.float32)
    u = torch.zeros((n_stack, padded_dim(dim)), dtype=torch.float32,
                    device=g.device)
    sq = torch.zeros_like(u)
    for s, c0, blk in shard_blocks(seeds, n_stack, q, dim, distribution,
                                   g.device, colmap):
        u[s] += torch.mv(blk, g[s, c0: c0 + blk.shape[1]])
        sq[s] += (blk * blk).sum(1)
    return u[:, :dim], sq[:, :dim]
