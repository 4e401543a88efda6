"""Packed projection into / reconstruction from on-demand random bases
(port of the packed half of ``repro.core.projector``).

Every compartment is packed into one ``(q_packed,)`` parameter buffer
and one ``(d_packed,)`` coordinate buffer (``core.compartments``), so one
optimizer step is two launches whatever the number of compartments:

  project:       u = P g, sq = sum P^2          (launch 1)
  apply:         theta' = theta - (eta c_hat) P  (launch 2)

with normalization folded into the coordinate scale: ``rsqrt_dim``
(phi / sqrt(Q)), ``exact`` (phi / ||phi||, norms from launch 1) or
``none``.  The K-worker joint subspace of ``independent_bases`` mode
(paper Algorithm 1) applies every worker's basis in one launch too:

  joint apply:   theta' = theta - sum_k (eta c_hat_k) P_k   (launch 2)

with worker k's basis keyed by ``fold_seed(step_seed, k + 1)``
(:func:`worker_base_seeds`).  Serving writes B tenants' personalized
buffers from one shared base in one launch:

  adapter apply: theta_a' = theta - c_hat_a P(base_seed_a), a = 1..B

(:func:`reconstruct_apply_packed_adapters`).  The per-leaf paths
(``project``/``reconstruct`` and the ``orthonormal`` normalization) are
not ported yet (ROADMAP.md Queue A 16).

Backends: ``"torch"`` runs the plain PyTorch versions on the tensors'
device; ``"cuda"`` runs the kernel wrappers of
``repro_torch.kernels.rbd_step`` (which take the plain versions for CPU
tensors, as the tests do).
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.compartments import LeafPlan, Plan, leaf_order


def _leaf_seed(base_seed, lp: LeafPlan) -> torch.Tensor:
    return rng.fold_seed(base_seed, lp.seed_tag)


def segment_seeds(plan: Plan, seed) -> torch.Tensor:
    """(n_segments,) uint32 segment seeds (int32 bits, on the CPU), in
    packed segment order: leaf seed = fold(step_seed, seed_tag), and a
    stacked leaf folds the layer index on top."""
    parts = []
    for lp in plan.leaves:
        lseed = _leaf_seed(seed, lp)
        if lp.stacked:
            layers = torch.arange(lp.n_stack, dtype=torch.int32)
            parts.append(rng.fold_seed(lseed, layers).reshape(-1))
        else:
            parts.append(lseed.reshape(1))
    return torch.cat(parts)


def _ravel_tree(tree: Mapping[str, torch.Tensor], plan: Plan):
    """Parameter map -> the (K, size) virtual leaf of a flatten plan."""
    vec = torch.cat([tree[n].reshape(-1).to(torch.float32)
                     for n in leaf_order(tree)])
    if plan.pad:
        vec = torch.cat([vec, vec.new_zeros(plan.pad)])
    lp = plan.leaves[0]
    return vec.reshape(lp.n_stack, lp.size)


def pack_tree(tree: Mapping[str, torch.Tensor], plan: Plan,
              layout) -> torch.Tensor:
    """Parameter map -> (q_packed,) float32 packed buffer: each
    compartment zero-padded to a multiple of ``layout.pos_block``."""
    if plan.flatten:
        sources = {"<flat>": _ravel_tree(tree, plan)}
    else:
        sources = tree
    parts = []
    for lp in plan.leaves:
        x = sources[lp.name].to(torch.float32).reshape(lp.n_stack, lp.size)
        psize = -(-lp.size // layout.pos_block) * layout.pos_block
        if psize != lp.size:
            x = torch.nn.functional.pad(x, (0, psize - lp.size))
        parts.append(x.reshape(-1))
    return torch.cat(parts)


def unpack_tree(packed: torch.Tensor, plan: Plan, layout,
                template: Mapping[str, torch.Tensor]) -> dict:
    """(q_packed,) packed buffer -> parameter map shaped and typed like
    ``template`` (tensors, possibly on the ``meta`` device).  The leaves
    are views or copies of ``packed`` that autograd follows, so the
    gradient of a loss on them arrives as a packed buffer, zero on the
    padding."""
    if plan.flatten:
        lp = plan.leaves[0]
        psize = -(-lp.size // layout.pos_block) * layout.pos_block
        vec = packed[: lp.n_stack * psize].reshape(lp.n_stack, psize)[
            :, : lp.size].reshape(-1)
        out, off = {}, 0
        for name in leaf_order(template):
            ref = template[name]
            n = int(np.prod(ref.shape, dtype=np.int64))
            out[name] = vec[off: off + n].reshape(ref.shape).to(ref.dtype)
            off += n
        return out
    out, off = {}, 0
    for lp in plan.leaves:
        psize = -(-lp.size // layout.pos_block) * layout.pos_block
        n = lp.n_stack * psize
        x = packed[off: off + n].reshape(lp.n_stack, psize)[:, : lp.size]
        ref = template[lp.name]
        out[lp.name] = x.reshape(ref.shape).to(ref.dtype)
        off += n
    return out


def unpack_coords(packed_coords: torch.Tensor, plan: Plan,
                  layout) -> list[torch.Tensor]:
    """Packed (d_packed,) coordinates -> per-LeafPlan (n_stack, dim)."""
    out, off = [], 0
    for lp in plan.leaves:
        pdim = -(-lp.dim // layout.dir_block) * layout.dir_block
        n = lp.n_stack * pdim
        out.append(packed_coords[off: off + n].reshape(
            lp.n_stack, pdim)[:, : lp.dim])
        off += n
    return out


def packed_norm_factor(plan: Plan, layout, sq=None, device=None):
    """Per-slot normalization factor, zero on padding slots (applied once
    for the exchanged coordinates and once more for the apply scale)."""
    device = sq.device if sq is not None else device

    def table(a):
        return torch.from_numpy(a).to(device)

    if plan.normalization == "rsqrt_dim":
        return table(layout.coord_inv_sqrt_q)
    if plan.normalization == "exact":
        return table(layout.coord_valid) * torch.rsqrt(
            torch.clamp(sq, min=1e-30))
    if plan.normalization == "none":
        return table(layout.coord_valid)
    raise ValueError(
        f"normalization {plan.normalization!r} is not supported by the "
        "packed path; use the per-leaf project/reconstruct API")


def project_packed(grads, plan: Plan, seed, *, backend: str = "torch",
                   layout=None, return_norms: bool = False,
                   prepacked: bool = False, prng="threefry"):
    """Normalized coordinates for ALL compartments in one (d_packed,)
    buffer -- one kernel launch on the cuda backend.  ``prepacked=True``
    takes ``grads`` as the packed (q_packed,) buffer."""
    rng.check_threefry(prng)
    layout = layout if layout is not None else plan.packed()
    seeds = segment_seeds(plan, seed)
    g_packed = (grads.to(torch.float32) if prepacked
                else pack_tree(grads, plan, layout))
    u, sq = _get_backend(backend).project_packed(
        seeds, g_packed, layout, plan.distribution)
    coords = u * packed_norm_factor(plan, layout, sq)
    if return_norms:
        return coords, sq
    return coords


def reconstruct_apply_packed(coords_packed, plan: Plan, seed, params, eta,
                             *, backend: str = "torch", row_sq=None,
                             layout=None, prepacked: bool = False,
                             prng="threefry", out=None):
    """Fused packed update ``theta' = theta - eta * (c_hat @ P)`` in one
    kernel launch; the reconstructed delta never exists in memory.

    ``row_sq`` (from ``project_packed(..., return_norms=True)``) is needed
    only by 'exact' normalization; when None it is regenerated with a
    zero-gradient projection.  ``prepacked=True`` takes and returns the
    packed (q_packed,) buffer; ``out=params`` then updates it in place."""
    rng.check_threefry(prng)
    layout = layout if layout is not None else plan.packed()
    seeds = segment_seeds(plan, seed)
    be = _get_backend(backend)
    if plan.normalization == "exact" and row_sq is None:
        _, row_sq = be.project_packed(
            seeds, torch.zeros((layout.q_packed,), dtype=torch.float32,
                               device=coords_packed.device),
            layout, plan.distribution)
    # the factor is zero on padding slots, so phantom padded basis rows
    # never contribute to the applied update
    factor = packed_norm_factor(plan, layout, row_sq,
                                 device=coords_packed.device)
    scale = (coords_packed * factor) * float(np.float32(eta))
    theta = (params.to(torch.float32) if prepacked
             else pack_tree(params, plan, layout))
    new = be.reconstruct_apply_packed(seeds, scale, theta, layout,
                                      plan.distribution, out=out)
    if prepacked:
        return new
    return unpack_tree(new, plan, layout, params)


# Normalizations whose reconstruction scale is a static per-slot factor (no
# per-basis row norms): the K-worker apply regenerates every other
# worker's basis from the seed schedule alone.  'exact' also needs every
# worker's row norms, which ride the one widened coords+norms all-gather
# (``core.distributed``) and arrive here as ``row_sq``.
STATIC_FACTOR_NORMALIZATIONS = ("rsqrt_dim", "none")


def worker_base_seeds(seed, k_workers: int) -> torch.Tensor:
    """(k_workers,) per-worker base seeds ``fold_seed(step_seed, k + 1)``
    (int32 bits) -- the Algorithm 1 shared seed schedule, bit-identical
    to ``distributed.worker_seed`` on worker k."""
    return rng.fold_seed(seed, torch.arange(1, k_workers + 1,
                                            dtype=torch.int32))


def worker_segment_seeds(plan: Plan, seed, k_workers: int) -> torch.Tensor:
    """(k_workers * n_segments,) segment seeds, worker-major: worker k's
    segments fold from its base seed through :func:`segment_seeds`."""
    return torch.cat([segment_seeds(plan, s)
                      for s in worker_base_seeds(seed, k_workers)])


def reconstruct_apply_packed_workers(coords_gathered, plan: Plan, seed,
                                     params, eta, *, backend: str = "torch",
                                     row_sq=None, layout=None,
                                     prepacked: bool = False,
                                     prng="threefry", out=None):
    """K-worker joint fused update (packed ``independent_bases`` mode):

        theta' = theta - eta * sum_k (c_hat_k @ P_k)

    in ONE kernel launch, regenerating every worker's basis from the
    shared seed schedule.  ``coords_gathered`` is the (k_workers,
    d_packed) all-gathered normalized coordinate buffer; ``eta`` should
    fold the 1/K mean.  The static-factor normalizations need nothing
    beyond the seeds; 'exact' folds each worker's ``rsqrt(max(sq,
    1e-30))`` into its row of the scale table, from ``row_sq``, the
    (k_workers, d_packed) norms gathered with the coordinates.
    ``prepacked``/``out`` as in :func:`reconstruct_apply_packed`."""
    if plan.normalization not in STATIC_FACTOR_NORMALIZATIONS \
            and plan.normalization != "exact":
        raise ValueError(
            f"normalization {plan.normalization!r} is not supported by "
            "the K-worker packed reconstruction (needs a factor-style "
            "scale); use the per-leaf independent_bases path")
    if plan.normalization == "exact" and row_sq is None:
        raise ValueError(
            "'exact' normalization needs every worker's row norms "
            "(row_sq, the (k_workers, d_packed) buffer gathered by the "
            "widened coords+norms collective); regenerating them here "
            "would cost K extra generation passes")
    rng.check_threefry(prng)
    layout = layout if layout is not None else plan.packed()
    k_workers = int(coords_gathered.shape[0])
    wseeds = worker_segment_seeds(plan, seed, k_workers)
    # (d_packed,) static factor, or (k_workers, d_packed) exact factors:
    # either broadcasts against the gathered coordinates
    factor = packed_norm_factor(plan, layout, row_sq,
                                device=coords_gathered.device)
    scale = ((coords_gathered.to(torch.float32) * factor)
             * float(np.float32(eta)))
    theta = (params.to(torch.float32) if prepacked
             else pack_tree(params, plan, layout))
    new = _get_backend(backend).reconstruct_apply_packed_workers(
        wseeds, scale, theta, layout, plan.distribution, out=out)
    if prepacked:
        return new
    return unpack_tree(new, plan, layout, params)


def adapter_segment_seeds(plan: Plan, adapter_seeds) -> torch.Tensor:
    """(n_adapters * n_segments,) segment seeds (int32 bits, on the CPU),
    adapter-major.  Each adapter's segments fold from its OWN uint32
    ``base_seed`` through :func:`segment_seeds` -- the seed half of the
    (seed, coords) adapter identity."""
    if not isinstance(adapter_seeds, torch.Tensor):
        adapter_seeds = np.asarray(adapter_seeds, dtype=np.uint32)
    seeds = rng.as_u32(adapter_seeds).cpu().reshape(-1)
    return torch.cat([segment_seeds(plan, s) for s in seeds])


def reconstruct_apply_packed_adapters(coords_batch, plan: Plan,
                                      adapter_seeds, params, *, eta=1.0,
                                      backend: str = "torch", row_sq=None,
                                      layout=None, prepacked: bool = False,
                                      prng="threefry"):
    """Multi-tenant serving apply:

        theta_a' = theta - eta * (c_hat_a @ P_a)   for a = 1..B

    ONE kernel launch produces every adapter's personalized parameter
    buffer from the shared base, regenerating each adapter's basis from
    its own ``base_seed``; the B dense per-tenant deltas never exist in
    memory.  ``coords_batch`` is (n_adapters, d_packed) normalized
    coordinates (the stored adapter payload); ``adapter_seeds`` the
    matching (n_adapters,) uint32 base seeds.  ``eta`` defaults to 1.0: a
    serving adapter's coordinates already ARE the accumulated update.

    Normalization follows the K-worker rules: the static-factor norms
    need nothing beyond the seeds; 'exact' needs each adapter's stored
    squared row norms (``row_sq``, (n_adapters, d_packed)); 'orthonormal'
    is refused.  ``prepacked=True`` takes the packed (q_packed,) base and
    returns (n_adapters, q_packed) float32; otherwise ``params`` is a
    parameter map and the result is a map whose leaves carry a leading
    adapter axis."""
    if plan.normalization not in STATIC_FACTOR_NORMALIZATIONS \
            and plan.normalization != "exact":
        raise ValueError(
            f"normalization {plan.normalization!r} is not supported by "
            "the multi-adapter packed reconstruction (needs a "
            "factor-style scale)")
    if plan.normalization == "exact" and row_sq is None:
        raise ValueError(
            "'exact' normalization needs each adapter's stored row "
            "norms (row_sq, (n_adapters, d_packed)); regenerating them "
            "at serve time would cost B extra generation passes")
    rng.check_threefry(prng)
    layout = layout if layout is not None else plan.packed()
    aseg_seeds = adapter_segment_seeds(plan, adapter_seeds)
    # (d_packed,) static factor, or (n_adapters, d_packed) exact factors
    factor = packed_norm_factor(plan, layout, row_sq,
                                device=coords_batch.device)
    scale = ((coords_batch.to(torch.float32) * factor)
             * float(np.float32(eta)))
    theta = (params.to(torch.float32) if prepacked
             else pack_tree(params, plan, layout))
    out = _get_backend(backend).reconstruct_apply_packed_adapters(
        aseg_seeds, scale, theta, layout, plan.distribution)
    if prepacked:
        return out
    rows = [unpack_tree(row, plan, layout, params) for row in out]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


# ---------------------------------------------------------------------------
# backend dispatch (plain PyTorch vs the CUDA kernels)
# ---------------------------------------------------------------------------


@functools.cache
def _get_backend(name: str):
    from repro_torch.kernels import rbd_step

    if name == "torch":
        return _Backend(rbd_step.project_packed_plain,
                        rbd_step.reconstruct_apply_packed_plain,
                        rbd_step.reconstruct_apply_packed_workers_plain,
                        rbd_step.reconstruct_apply_packed_adapters_plain)
    if name == "cuda":
        return _Backend(rbd_step.project_packed,
                        rbd_step.reconstruct_apply_packed,
                        rbd_step.reconstruct_apply_packed_workers,
                        rbd_step.reconstruct_apply_packed_adapters)
    raise ValueError(f"unknown projector backend {name!r}")


class _Backend:
    def __init__(self, project, reconstruct_apply, reconstruct_apply_workers,
                 reconstruct_apply_adapters):
        self.project_packed = project
        self.reconstruct_apply_packed = reconstruct_apply
        self.reconstruct_apply_packed_workers = reconstruct_apply_workers
        self.reconstruct_apply_packed_adapters = reconstruct_apply_adapters
