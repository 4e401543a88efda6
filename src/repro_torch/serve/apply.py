"""Fused multi-adapter delta application for serving (port of
``repro.serve.apply``).

One batch of requests touches B distinct adapters.  The training-side
reconstruct-apply kernel already regenerates bases from seeds
(``kernels/rbd_step.py``); serving reuses that with the B adapters in the
role of the K workers: ONE kernel launch reads the shared base ``theta``
once and writes every adapter's personalized parameter buffer

    theta_a' = theta - c_hat_a @ P(base_seed_a)

directly -- the dense per-tenant deltas never exist in memory for
cache-MISS tenants (their bases are regenerated from kilobytes of
(seed, coords) state).  Cache-HIT tenants take the materialize-then-add
path instead: their delta is already resident in the LRU cache
(``serve.adapters.AdapterCache``) and applying it is one add.

Exactness contract: row a of the fused path is bit-identical to the
single-tenant packed apply of adapter a (the kernel runs the same
instruction sequence per row; the plain version the same plain apply).
The cached-delta path agrees with the fused path to float32 rounding:
the delta accumulates ``(0 - p_1) - p_2 - ...`` over direction blocks
while the fused path computes ``(theta - p_1) - p_2 - ...``, and the two
round identically only when a compartment has a single direction block
(then IEEE ``theta + (0 - p) == theta - p`` holds exactly).  Each path
is deterministic bit for bit.

``backend="cuda"`` (the default) goes through the kernel wrapper, which
launches the kernel for a CUDA base and takes the plain version for a
CPU one; ``"torch"`` runs the plain version on either.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import projector
from repro_torch.core.compartments import Plan
from repro_torch.models.registry import resolve_device
from repro_torch.serve.adapters import AdapterCache, AdapterSpec


def specs_to_batch(specs: Sequence[AdapterSpec], plan: Plan, layout,
                   device="cuda"):
    """Stack adapter payloads into the (seeds, coords[, row_sq]) batch the
    fused apply consumes: (B,) uint32 numpy seeds, (B, d_packed) float32
    coordinates (and row norms) on ``device``.  Under 'exact'
    normalization every spec must carry its stored row norms; under the
    static-factor norms row_sq is ignored."""
    if not specs:
        raise ValueError("specs_to_batch needs at least one adapter")
    device = resolve_device(device)
    seeds = np.asarray([s.base_seed for s in specs], np.uint32)
    coords = torch.from_numpy(np.stack([s.coords for s in specs])).to(
        device=device, dtype=torch.float32)
    if coords.shape[1] != layout.d_packed:
        raise ValueError(
            f"adapter coords have d={coords.shape[1]}, layout expects "
            f"d_packed={layout.d_packed}")
    row_sq = None
    if plan.normalization == "exact":
        missing = [s.adapter_id for s in specs if s.row_sq is None]
        if missing:
            raise ValueError(
                "'exact' normalization needs stored row norms; adapters "
                f"without row_sq: {missing}")
        row_sq = torch.from_numpy(np.stack([s.row_sq for s in specs])).to(
            device=device, dtype=torch.float32)
    return seeds, coords, row_sq


def apply_adapters_fused(theta_packed: torch.Tensor,
                         specs: Sequence[AdapterSpec], plan: Plan,
                         layout=None, *, backend: str = "cuda",
                         prng="threefry") -> torch.Tensor:
    """ONE launch: every adapter's personalized (q_packed,) buffer from
    the shared base.  Returns (len(specs), q_packed) float32 on the
    base's device."""
    layout = layout if layout is not None else plan.packed()
    seeds, coords, row_sq = specs_to_batch(specs, plan, layout,
                                           theta_packed.device)
    return projector.reconstruct_apply_packed_adapters(
        coords, plan, seeds, theta_packed, backend=backend, row_sq=row_sq,
        layout=layout, prepacked=True, prng=prng)


def materialize_deltas(specs: Sequence[AdapterSpec], plan: Plan,
                       layout=None, *, backend: str = "cuda",
                       prng="threefry", device="cuda") -> torch.Tensor:
    """Dense packed deltas for cache FILLS: the fused apply over a zero
    base gives ``delta_a = -(c_hat_a @ P_a)`` in the kernel's own
    accumulation order, so ``theta + delta_a`` matches the fused path to
    float32 rounding (bit-exact with one direction block per
    compartment; see the module docstring).  One launch for all B specs.
    Returns (len(specs), q_packed) float32 on ``device``."""
    layout = layout if layout is not None else plan.packed()
    zeros = torch.zeros((layout.q_packed,), dtype=torch.float32,
                        device=resolve_device(device))
    return apply_adapters_fused(zeros, specs, plan, layout, backend=backend,
                                prng=prng)


def personalize(theta_packed: torch.Tensor, specs: Sequence[AdapterSpec],
                plan: Plan, layout=None, *,
                cache: AdapterCache | None = None, backend: str = "cuda",
                prng="threefry", pin_misses: bool = False):
    """Per-tenant personalized buffers for a batch of DISTINCT adapters,
    each routed through the cheapest path:

    * cache HIT: ``theta + cached_delta`` -- one add, no generation;
    * cache MISS: all misses together in ONE fused regenerate-and-apply
      launch -- the delta never exists in memory.  With
      ``pin_misses=True`` (and a cache) the misses are instead
      materialized (one launch over a zero base), inserted into the cache
      (LRU evictions may fire) and applied by add, so the same request
      takes the hit path next time with identical bits.

    Returns ``(buffers, info)``: (len(specs), q_packed) float32 rows in
    spec order, and the per-call hit/miss counts and the number of fused
    launches issued."""
    layout = layout if layout is not None else plan.packed()
    theta = theta_packed.to(torch.float32)
    hits: list[tuple[int, torch.Tensor]] = []
    misses: list[tuple[int, AdapterSpec]] = []
    for i, spec in enumerate(specs):
        delta = cache.get(spec.base_seed) if cache is not None else None
        if delta is not None:
            hits.append((i, delta))
        else:
            misses.append((i, spec))
    info = {"hits": len(hits), "misses": len(misses),
            "fused_launches": int(bool(misses))}
    miss_specs = [s for _, s in misses]
    pin = pin_misses and cache is not None
    if misses and not hits and not pin:
        # every row is a miss: the fused output is the result, in order
        return apply_adapters_fused(theta, miss_specs, plan, layout,
                                    backend=backend, prng=prng), info
    # rows are written into one buffer: no stacked copy of B rows
    out = torch.empty((len(specs), layout.q_packed), dtype=torch.float32,
                      device=theta.device)
    if misses and pin:
        deltas = materialize_deltas(miss_specs, plan, layout,
                                    backend=backend, prng=prng,
                                    device=theta.device)
        for (i, spec), delta in zip(misses, deltas):
            cache.put(spec.base_seed, delta)
            hits.append((i, delta))
    elif misses:
        fused = apply_adapters_fused(theta, miss_specs, plan, layout,
                                     backend=backend, prng=prng)
        for (i, _), row in zip(misses, fused):
            out[i].copy_(row)
    for i, delta in hits:
        torch.add(theta, delta, out=out[i])
    return out, info
