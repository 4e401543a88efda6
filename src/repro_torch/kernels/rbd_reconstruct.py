"""Per-leaf reconstruction kernels, each beside its plain PyTorch version.

* :func:`reconstruct_flat` -- one launch per ``LeafPlan``: the float32
  update ``delta_s = scale_s @ P_s`` of each of the leaf's ``n_stack``
  compartments (replaces the reference's ``repro/kernels/
  rbd_reconstruct.py: reconstruct_flat -> _recon_kernel``).
* :func:`reconstruct_apply_flat` -- one launch per ``LeafPlan``:
  ``theta_s' = theta_s - eta * (scale_s @ P_s)`` with a float32
  accumulator started from ``float(theta)`` and ONE rounding back to
  theta's dtype (float32 or bfloat16), the delta never in memory
  (replaces ``reconstruct_apply_flat -> _recon_apply_kernel``).

* :func:`reconstruct_flat_shard` and :func:`reconstruct_apply_flat_shard`
  -- their shard instances (template flag ``SHARD``; Threefry only): the
  same on the ``(n_stack, q_local)`` rows of a leaf shard under
  pjit-style parameter sharding, every value generated at its global
  column (``rbd_project.shard_columns``), so a shard's output is the
  unsharded output at the same positions, bit for bit.

Both take the reference's ``prng`` (tile-keyed impls keyed by the
(8, 512) tile at (dir-block, pos-block) of the compartment; the
reference's resolver routes every per-leaf strategy to Threefry, so only
callers that ask get them).  Per position both visit the dir-blocks in
order, forming each block's part ``sum_{r<8} s_r P_r`` first (the
reference's association).  The
wrappers take their plain versions for CPU tensors, and only then; for a
CUDA tensor they call their ops (``torch.ops.repro_torch.<name>``), which
launch the kernels of ``csrc/rbd_flat.cu`` or raise (a meta tensor
reaches an op's fake implementation, see
:mod:`repro_torch.kernels.rbd_step`).
Launches, calls and CUDA-event times are counted in
:mod:`repro_torch.kernels.rbd_step`'s ``LAUNCHES``/``CALLS``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from repro_torch.kernels import rbd_step
from repro_torch.kernels.rbd_project import (DIR_BLOCK, check_colmap,
                                             check_flat, flat_blocks,
                                             padded_dim, shard_blocks)

_THETA_DTYPES = (torch.float32, torch.bfloat16)


def _padded_scale(scale: torch.Tensor, n_stack: int, dim: int):
    """(n_stack, dim) scale -> contiguous (n_stack, padded dim) float32,
    zero on the padding rows."""
    if tuple(scale.shape) != (n_stack, dim):
        raise ValueError(f"scale must have shape {(n_stack, dim)}, got "
                         f"{tuple(scale.shape)}")
    out = torch.zeros((n_stack, padded_dim(dim)), dtype=torch.float32,
                      device=scale.device)
    out[:, :dim] = scale
    return out


def reconstruct_flat(seeds, scale: torch.Tensor, q: int,
                     distribution: str = "normal", *,
                     prng="threefry") -> torch.Tensor:
    """``(n_stack, q)`` float32 ``scale @ P`` per compartment; ``scale``
    is ``(n_stack, dim)`` and folds in normalization (and learning rate
    where the caller wants it)."""
    rbd_step.CALLS["reconstruct_flat"] += 1
    if scale.device.type == "cpu":
        return reconstruct_flat_plain(seeds, scale, q, distribution,
                                      prng=prng)
    n_stack, dim = (int(x) for x in scale.shape)
    if distribution not in rbd_step._DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")
    dev = scale.device
    sc = _padded_scale(scale, n_stack, dim)
    seeds = rbd_step._seeds_on(seeds, n_stack, dev)
    return _reconstruct_flat_op(sc, seeds, q,
                                rbd_step._DIST_CODE[distribution],
                                rbd_step.impl_code(prng))


@rbd_step.kernel_op("reconstruct_flat")
def _reconstruct_flat_op(sc: Tensor, seeds: Tensor, q: int, dist: int,
                         impl: int) -> Tensor:
    n_stack = int(sc.shape[0])
    out = torch.empty((n_stack, q), dtype=torch.float32, device=sc.device)
    rbd_step._launch(
        "reconstruct_flat",
        rbd_step.library(rbd_step.FLAT_SOURCE).lib.rbd_reconstruct_flat,
        sc.data_ptr(), seeds.data_ptr(), n_stack, q,
        sc.shape[1] // DIR_BLOCK, dist, impl, out.data_ptr(),
        variant=(rbd_step._IMPL_NAME[impl], False))
    return out


@_reconstruct_flat_op.register_fake
def _(sc, seeds, q, dist, impl):
    return sc.new_empty((int(sc.shape[0]), q), dtype=torch.float32)


def reconstruct_flat_plain(seeds, scale: torch.Tensor, q: int,
                           distribution: str = "normal", *,
                           prng="threefry") -> torch.Tensor:
    """Plain PyTorch version of :func:`reconstruct_flat`: per block of
    positions each dir-block's part is added in dir-block order."""
    n_stack, dim = (int(x) for x in scale.shape)
    return _reconstruct_plain(flat_blocks(
        seeds, n_stack, q, dim, distribution, scale.device, keep=False,
        prng=prng), scale, q)


def _reconstruct_plain(blocks, scale: torch.Tensor, q: int):
    """The plain reconstruction over ``blocks`` (``(s, c0, block)``)."""
    n_stack, dim = (int(x) for x in scale.shape)
    sc = _padded_scale(scale.to(torch.float32), n_stack, dim)
    out = torch.zeros((n_stack, q), dtype=torch.float32,
                      device=scale.device)
    for s, c0, blk, parts in _parts(blocks, sc):
        o = out[s, c0: c0 + blk.shape[1]]
        for part in parts:
            o += part
    return out


def reconstruct_apply_flat(seeds, scale: torch.Tensor, theta: torch.Tensor,
                           eta, distribution: str = "normal", *, out=None,
                           prng="threefry"):
    """``theta - eta * (scale @ P)`` per compartment, fused; returns
    ``out`` (theta's dtype and shape ``(n_stack, q)``).  ``out=None``
    allocates it; ``out=theta`` updates theta in place."""
    rbd_step.CALLS["reconstruct_apply_flat"] += 1
    if theta.device.type == "cpu":
        return reconstruct_apply_flat_plain(seeds, scale, theta, eta,
                                            distribution, out=out,
                                            prng=prng)
    n_stack, q = (int(x) for x in theta.shape)
    check_flat("theta", theta, n_stack, q, _THETA_DTYPES)
    if distribution not in rbd_step._DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")
    dev = theta.device
    if out is None:
        out = torch.empty_like(theta)
    check_flat("out", out, n_stack, q, (theta.dtype,))
    sc = _padded_scale(scale, n_stack, int(scale.shape[-1]))
    seeds = rbd_step._seeds_on(seeds, n_stack, dev)
    _reconstruct_apply_flat_op(sc, theta, out, float(np.float32(eta)), seeds,
                               rbd_step._DIST_CODE[distribution],
                               rbd_step.impl_code(prng))
    return out


@rbd_step.kernel_op("reconstruct_apply_flat", mutates=("out",))
def _reconstruct_apply_flat_op(sc: Tensor, theta: Tensor, out: Tensor,
                               eta: float, seeds: Tensor, dist: int,
                               impl: int) -> None:
    n_stack, q = (int(x) for x in theta.shape)
    rbd_step._launch(
        "reconstruct_apply_flat",
        rbd_step.library(rbd_step.FLAT_SOURCE).lib.rbd_reconstruct_apply_flat,
        sc.data_ptr(), theta.data_ptr(), out.data_ptr(), eta,
        seeds.data_ptr(), n_stack, q, sc.shape[1] // DIR_BLOCK, dist, impl,
        int(theta.dtype == torch.bfloat16),
        variant=(rbd_step._IMPL_NAME[impl], False))


@_reconstruct_apply_flat_op.register_fake
def _(sc, theta, out, eta, seeds, dist, impl):
    return None


def reconstruct_apply_flat_plain(seeds, scale: torch.Tensor,
                                 theta: torch.Tensor, eta,
                                 distribution: str = "normal", *, out=None,
                                 prng="threefry"):
    """Plain PyTorch version of :func:`reconstruct_apply_flat`: a float32
    copy of theta, each dir-block's ``eta * part`` subtracted in order,
    one cast back to theta's dtype."""
    n_stack, q = (int(x) for x in theta.shape)
    return _apply_plain(flat_blocks(
        seeds, n_stack, q, int(scale.shape[-1]), distribution, theta.device,
        keep=False, prng=prng), scale, theta, eta, out)


def _apply_plain(blocks, scale: torch.Tensor, theta: torch.Tensor, eta,
                 out):
    """The plain fused apply over ``blocks`` (``(s, c0, block)``)."""
    n_stack = int(theta.shape[0])
    sc = _padded_scale(scale.to(torch.float32), n_stack,
                       int(scale.shape[-1]))
    eta = float(np.float32(eta))
    acc = theta.to(torch.float32, copy=True)
    for s, c0, blk, parts in _parts(blocks, sc):
        o = acc[s, c0: c0 + blk.shape[1]]
        for part in parts:
            o -= eta * part
    if out is None:
        return acc.to(theta.dtype)
    out.copy_(acc)
    return out


def _parts(blocks, sc):
    """Yield ``(s, c0, block, parts)``: ``parts[b]`` is dir-block b's
    ``sum_{r<8} sc_r P_r`` over the block's columns, summed in row order
    (the kernels' order), so a column's part does not depend on the
    block it lies in."""
    for s, c0, blk in blocks:
        pdim, nc = blk.shape
        t = (sc[s].reshape(pdim, 1) * blk).reshape(
            pdim // DIR_BLOCK, DIR_BLOCK, nc)
        parts = t[:, 0].clone()
        for r in range(1, DIR_BLOCK):
            parts += t[:, r]
        yield s, c0, blk, parts


def reconstruct_flat_shard(seeds, scale: torch.Tensor, q: int,
                           distribution: str = "normal", *, colmap,
                           prng="threefry") -> torch.Tensor:
    """The shard instance of :func:`reconstruct_flat`: ``(n_stack,
    q_local)`` float32 ``scale @ P`` at the global columns ``colmap =
    (w, W, off)`` gives the local positions (module docstring)."""
    rbd_step.CALLS["reconstruct_flat_shard"] += 1
    colmap = check_colmap(colmap, q, prng)
    if scale.device.type == "cpu":
        return reconstruct_flat_shard_plain(seeds, scale, q, distribution,
                                            colmap=colmap)
    n_stack, dim = (int(x) for x in scale.shape)
    if distribution not in rbd_step._DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")
    dev = scale.device
    sc = _padded_scale(scale, n_stack, dim)
    seeds = rbd_step._seeds_on(seeds, n_stack, dev)
    return _reconstruct_flat_shard_op(sc, seeds, q,
                                      rbd_step._DIST_CODE[distribution],
                                      *colmap)


@rbd_step.kernel_op("reconstruct_flat_shard")
def _reconstruct_flat_shard_op(sc: Tensor, seeds: Tensor, q: int, dist: int,
                               w: int, big_w: int, off: int) -> Tensor:
    n_stack = int(sc.shape[0])
    out = torch.empty((n_stack, q), dtype=torch.float32, device=sc.device)
    rbd_step._launch(
        "reconstruct_flat_shard",
        rbd_step.library(rbd_step.FLAT_SOURCE).lib.rbd_reconstruct_flat_shard,
        sc.data_ptr(), seeds.data_ptr(), n_stack, q,
        sc.shape[1] // DIR_BLOCK, dist, w, big_w, off, out.data_ptr())
    return out


@_reconstruct_flat_shard_op.register_fake
def _(sc, seeds, q, dist, w, big_w, off):
    return sc.new_empty((int(sc.shape[0]), q), dtype=torch.float32)


def reconstruct_flat_shard_plain(seeds, scale: torch.Tensor, q: int,
                                 distribution: str = "normal", *, colmap,
                                 prng="threefry") -> torch.Tensor:
    """Plain PyTorch version of :func:`reconstruct_flat_shard`."""
    colmap = check_colmap(colmap, q, prng)
    n_stack, dim = (int(x) for x in scale.shape)
    return _reconstruct_plain(shard_blocks(
        seeds, n_stack, q, dim, distribution, scale.device, colmap),
        scale, q)


def reconstruct_apply_flat_shard(seeds, scale: torch.Tensor,
                                 theta: torch.Tensor, eta,
                                 distribution: str = "normal", *, colmap,
                                 out=None, prng="threefry"):
    """The shard instance of :func:`reconstruct_apply_flat`: ``theta -
    eta * (scale @ P)`` on the ``(n_stack, q_local)`` rows of a leaf
    shard, at the global columns of ``colmap = (w, W, off)``."""
    rbd_step.CALLS["reconstruct_apply_flat_shard"] += 1
    n_stack, q = (int(x) for x in theta.shape)
    colmap = check_colmap(colmap, q, prng)
    if theta.device.type == "cpu":
        return reconstruct_apply_flat_shard_plain(
            seeds, scale, theta, eta, distribution, colmap=colmap, out=out)
    check_flat("theta", theta, n_stack, q, _THETA_DTYPES)
    if distribution not in rbd_step._DIST_CODE:
        raise ValueError(f"unknown distribution {distribution!r}")
    dev = theta.device
    if out is None:
        out = torch.empty_like(theta)
    check_flat("out", out, n_stack, q, (theta.dtype,))
    sc = _padded_scale(scale, n_stack, int(scale.shape[-1]))
    seeds = rbd_step._seeds_on(seeds, n_stack, dev)
    _reconstruct_apply_flat_shard_op(sc, theta, out, float(np.float32(eta)),
                                     seeds, rbd_step._DIST_CODE[distribution],
                                     *colmap)
    return out


@rbd_step.kernel_op("reconstruct_apply_flat_shard", mutates=("out",))
def _reconstruct_apply_flat_shard_op(sc: Tensor, theta: Tensor, out: Tensor,
                                     eta: float, seeds: Tensor, dist: int,
                                     w: int, big_w: int, off: int) -> None:
    n_stack, q = (int(x) for x in theta.shape)
    rbd_step._launch(
        "reconstruct_apply_flat_shard",
        rbd_step.library(
            rbd_step.FLAT_SOURCE).lib.rbd_reconstruct_apply_flat_shard,
        sc.data_ptr(), theta.data_ptr(), out.data_ptr(), eta,
        seeds.data_ptr(), n_stack, q, sc.shape[1] // DIR_BLOCK, dist,
        int(theta.dtype == torch.bfloat16), w, big_w, off)


@_reconstruct_apply_flat_shard_op.register_fake
def _(sc, theta, out, eta, seeds, dist, w, big_w, off):
    return None


def reconstruct_apply_flat_shard_plain(seeds, scale: torch.Tensor,
                                       theta: torch.Tensor, eta,
                                       distribution: str = "normal", *,
                                       colmap, out=None, prng="threefry"):
    """Plain PyTorch version of :func:`reconstruct_apply_flat_shard`."""
    n_stack, q = (int(x) for x in theta.shape)
    colmap = check_colmap(colmap, q, prng)
    return _apply_plain(shard_blocks(
        seeds, n_stack, q, int(scale.shape[-1]), distribution, theta.device,
        colmap), scale, theta, eta, out)
