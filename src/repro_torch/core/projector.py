"""Projection into / reconstruction from on-demand random bases (port of
``repro.core.projector``).

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

(:func:`reconstruct_apply_packed_adapters`).  On a model group of m ranks
each rank holds one (q_slab,) slab of the zero-padded buffer
(``core.compartments.ShardedPackedLayout``): launch 1 on the slab gives
RAW partial sums, completed by one sum over the group and normalized
outside (:func:`project_packed_sharded`), and launch 2 touches only the
slab (:func:`reconstruct_apply_packed_sharded`,
:func:`reconstruct_apply_packed_workers_sharded`).

The per-leaf strategies (packing off, weight decay) run a loop over the
plan's leaves instead, ONE launch per ``LeafPlan`` whatever its number of
stacked compartments (:func:`project`, :func:`reconstruct`,
:func:`reconstruct_apply`, :func:`rbd_gradient`), on parameter maps
``{leaf name: tensor}``; the ``orthonormal`` normalization materializes a
QR-orthonormalized basis per compartment (:func:`_ortho_basis`).

Leaf shards (pjit-style parameter sharding, ``shards=`` a
``models.registry.LeafShards``): a rank holds each sharded leaf's part,
cut along one dimension of the compartment's tail.  A compartment's shard
projects locally onto the basis columns at the shard's GLOBAL positions
(the per-leaf kernels' shard instances, ``kernels.rbd_project.
shard_columns``); a replicated leaf is projected by one rank of the
group (leaf i by rank ``i % m``), the others adding zeros.  Every leaf's
raw ``(u, sq)`` partials are completed by ONE all-reduce over the model
group for the whole step -- the (sum of dims,) buffer, widened to twice
that under 'exact' (:func:`complete_partials`) -- and then normalized,
``rsqrt_dim`` still by the whole compartment's size.  The
reconstructions write only this rank's part of a sharded leaf and the
whole of a replicated one.  ``orthonormal`` builds each compartment's QR
basis whole from its seed on every rank and keeps the shard's columns, so
no basis value crosses ranks.  A shard never holds whole compartments: no
config's specs cut a stacked leaf on its layer axis (checked by
``tests/test_torch_sharding_rules.py``; :meth:`LeafShards.colmap`
raises).  Flattened plans take no shards.

Backends: ``"torch"`` runs plain PyTorch on the tensors' device -- the
packed kernels' plain versions, and for the per-leaf path the reference's
tensor-shaped generation (:func:`_project_flat`, :func:`_reconstruct_flat`);
``"cuda"`` runs the kernel wrappers of ``repro_torch.kernels.rbd_step``,
``rbd_project`` and ``rbd_reconstruct`` (which take their plain versions
for CPU tensors, as the tests do).
"""

from __future__ import annotations

import functools
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.compartments import LeafPlan, Plan, leaf_order

# Rows of the virtual basis matrix generated per chunk by the tensor-shaped
# generation (the reference's DIR_CHUNK / _BLOCK_BUDGET): the live block is
# (chunk x Q), chunk a multiple of 8, at most 2^24 elements where Q allows.
DIR_CHUNK = 8
_BLOCK_BUDGET = 1 << 24


def _chunk_rows(dim: int, q: int) -> int:
    r = max(DIR_CHUNK, min(dim, _BLOCK_BUDGET // max(q, 1)))
    return (r // DIR_CHUNK) * DIR_CHUNK


def _padded_dim(d: int, chunk: int = DIR_CHUNK) -> int:
    return ((d + chunk - 1) // chunk) * chunk


def _leaf_seed(base_seed, lp: LeafPlan) -> torch.Tensor:
    return rng.fold_seed(base_seed, lp.seed_tag)


def _stack_seeds(leaf_seed, n_stack: int) -> torch.Tensor:
    """(n_stack,) independent compartment seeds of a stacked leaf
    ``fold_seed(leaf_seed, i)`` (int32 bits, on the CPU)."""
    return rng.fold_seed(leaf_seed, torch.arange(n_stack, dtype=torch.int32))


def segment_seeds(plan: Plan, seed) -> torch.Tensor:
    """(n_segments,) uint32 segment seeds (int32 bits, on the CPU), in
    packed segment order: leaf seed = fold(step_seed, seed_tag), and a
    stacked leaf folds the layer index on top."""
    return torch.cat([_leaf_seeds(seed, lp) for lp in plan.leaves])


def _leaf_seeds(seed, lp: LeafPlan) -> torch.Tensor:
    """(n_stack,) compartment seeds of one leaf: the layer-folded seeds of
    a stacked leaf, the leaf seed itself otherwise."""
    lseed = _leaf_seed(seed, lp)
    if lp.stacked:
        return _stack_seeds(lseed, lp.n_stack).reshape(-1)
    return lseed.reshape(1)


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
    layout = layout if layout is not None else plan.packed()
    seeds = segment_seeds(plan, seed)
    g_packed = (grads.to(torch.float32) if prepacked
                else pack_tree(grads, plan, layout))
    u, sq = _get_backend(backend).project_packed(
        seeds, g_packed, layout, plan.distribution, prng=prng)
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
    layout = layout if layout is not None else plan.packed()
    seeds = segment_seeds(plan, seed)
    be = _get_backend(backend)
    if plan.normalization == "exact" and row_sq is None:
        _, row_sq = be.project_packed(
            seeds, torch.zeros((layout.q_packed,), dtype=torch.float32,
                               device=coords_packed.device),
            layout, plan.distribution, prng=prng)
    # the factor is zero on padding slots, so phantom padded basis rows
    # never contribute to the applied update
    factor = packed_norm_factor(plan, layout, row_sq,
                                 device=coords_packed.device)
    scale = (coords_packed * factor) * float(np.float32(eta))
    theta = (params.to(torch.float32) if prepacked
             else pack_tree(params, plan, layout))
    new = be.reconstruct_apply_packed(seeds, scale, theta, layout,
                                      plan.distribution, out=out, prng=prng)
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
        wseeds, scale, theta, layout, plan.distribution, out=out, prng=prng)
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
        aseg_seeds, scale, theta, layout, plan.distribution, prng=prng)
    if prepacked:
        return out
    rows = [unpack_tree(row, plan, layout, params) for row in out]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


# ---------------------------------------------------------------------------
# model-sharded slabs
# ---------------------------------------------------------------------------


def project_packed_sharded(g_slab, plan: Plan, seed, shard_idx, *,
                           slayout, backend: str = "torch",
                           prng="threefry"):
    """Model-sharded packed projection: the RAW per-slab partial ``(u,
    sq)``, each (d_packed,), of the local (q_slab,) slice of the padded
    packed gradient.  Sum both over the model group
    (``core.distributed.complete_model_partials``), then ``coords = u *
    packed_norm_factor(plan, slayout.base, sq)``: normalization must see
    the completed sums ('exact' needs the full row norms)."""
    seeds = segment_seeds(plan, seed)
    return _get_backend(backend).project_packed_sharded(
        seeds, g_slab.to(torch.float32), slayout, int(shard_idx),
        plan.distribution, prng=prng)


def reconstruct_apply_packed_sharded(coords_packed, plan: Plan, seed,
                                     theta_slab, eta, shard_idx, *,
                                     slayout, backend: str = "torch",
                                     row_sq=None, prng="threefry",
                                     out=None):
    """Model-sharded fused update ``slab' = slab - eta * (c_hat @ P)`` on
    the local theta slab against the replicated post-exchange (d_packed,)
    coordinates; returns the (q_slab,) slab.  ``row_sq`` must be the
    COMPLETED squared row norms under 'exact' (a local regeneration would
    only give this slab's partial sums).  ``out=theta_slab`` updates the
    slab in place."""
    if plan.normalization == "exact" and row_sq is None:
        raise ValueError(
            "'exact' normalization on the sharded packed path needs the "
            "completed row norms (row_sq); a local regeneration pass "
            "would only produce this slab's partial sums")
    seeds = segment_seeds(plan, seed)
    factor = packed_norm_factor(plan, slayout.base, row_sq,
                                device=coords_packed.device)
    scale = (coords_packed * factor) * float(np.float32(eta))
    return _get_backend(backend).reconstruct_apply_packed_sharded(
        seeds, scale, theta_slab.to(torch.float32), slayout, int(shard_idx),
        plan.distribution, out=out, prng=prng)


def reconstruct_apply_packed_workers_sharded(coords_gathered, plan: Plan,
                                             seed, theta_slab, eta,
                                             shard_idx, *, slayout,
                                             backend: str = "torch",
                                             row_sq=None, prng="threefry",
                                             out=None):
    """Model-sharded K-worker joint fused update on the local theta slab:
    :func:`reconstruct_apply_packed_workers`'s contract with
    ``coords_gathered`` the replicated (k_workers, d_packed) gathered
    buffer and ``row_sq`` (exact) the gathered COMPLETED norms.  Returns
    the (q_slab,) slab."""
    if plan.normalization not in STATIC_FACTOR_NORMALIZATIONS \
            and plan.normalization != "exact":
        raise ValueError(
            f"normalization {plan.normalization!r} is not supported by "
            "the K-worker packed reconstruction (needs a factor-style "
            "scale); use the per-leaf independent_bases path")
    if plan.normalization == "exact" and row_sq is None:
        raise ValueError(
            "'exact' normalization needs every worker's completed row "
            "norms (row_sq, (k_workers, d_packed))")
    k_workers = int(coords_gathered.shape[0])
    wseeds = worker_segment_seeds(plan, seed, k_workers)
    factor = packed_norm_factor(plan, slayout.base, row_sq,
                                device=coords_gathered.device)
    scale = ((coords_gathered.to(torch.float32) * factor)
             * float(np.float32(eta)))
    return _get_backend(backend).reconstruct_apply_packed_workers_sharded(
        wseeds, scale, theta_slab.to(torch.float32), slayout,
        int(shard_idx), plan.distribution, out=out, prng=prng)


# ---------------------------------------------------------------------------
# per-leaf path: single-compartment generation (the "torch" backend)
# ---------------------------------------------------------------------------


def _project_flat(seed, g: torch.Tensor, dim: int, distribution: str):
    """``u = P @ g`` and the squared row norms of one compartment, chunked
    over directions.  ``g`` may have any shape: basis rows are generated
    tensor-shaped from linear-position counters and contracted over all of
    g's axes.  Returns ``(u, sq)`` of shape ``(dim,)`` each."""
    tail = tuple(g.shape)
    q = int(np.prod(tail, dtype=np.int64)) if tail else 1
    chunk = _chunk_rows(dim, q)
    n_chunks = _padded_dim(dim, chunk) // chunk
    g = g.to(torch.float32)
    red = tuple(range(1, len(tail) + 1))
    us, sqs = [], []
    for i in range(n_chunks):
        block = rng.generate_rows_nd(seed, i * chunk, chunk, tail,
                                     distribution, device=g.device)
        us.append(torch.sum(block * g[None], dim=red) if red
                  else block * g)
        sqs.append(torch.sum(block * block, dim=red) if red
                   else block * block)
    return torch.cat(us)[:dim], torch.cat(sqs)[:dim]


def _reconstruct_flat(seed, scale: torch.Tensor, tail, distribution: str,
                      dtype=torch.float32) -> torch.Tensor:
    """``delta = scale @ P`` of one compartment, chunked over directions;
    ``scale`` (dim,) already folds in learning rate and normalization,
    ``tail`` is the compartment's tensor shape (or an int for flat)."""
    tail = (tail,) if isinstance(tail, int) else tuple(tail)
    dim = int(scale.shape[0])
    q = int(np.prod(tail, dtype=np.int64)) if tail else 1
    chunk = _chunk_rows(dim, q)
    d_pad = _padded_dim(dim, chunk)
    s = torch.zeros((d_pad,), dtype=torch.float32, device=scale.device)
    s[:dim] = scale
    acc = None
    for i in range(d_pad // chunk):
        block = rng.generate_rows_nd(seed, i * chunk, chunk, tail,
                                     distribution, device=scale.device)
        sc = s[i * chunk: (i + 1) * chunk].reshape((chunk,) + (1,) * len(tail))
        part = torch.sum(sc * block, dim=0)
        acc = part if acc is None else acc + part
    return acc.to(dtype)


# explicit orthogonalization (paper section 5 / B.8): the (dim, Q) block is
# materialized and QR-orthonormalized, so compartments are limited to
_ORTHO_BUDGET = 1 << 24  # materialized d*Q elements


def _ortho_basis(seed, dim: int, tail, distribution: str,
                 device=None) -> torch.Tensor:
    """Deterministically orthonormalized (dim, Q) basis rows of one
    compartment: QR of the generated rows, signs fixed by diag(R) so the
    basis is a pure function of the seed."""
    q = int(np.prod(tail, dtype=np.int64)) if tail else 1
    if dim * q > _ORTHO_BUDGET:
        raise ValueError(
            f"orthonormal normalization materializes d*Q = {dim * q:,} "
            f"elements; compartmentalize below {_ORTHO_BUDGET:,} first")
    p = rng.generate_rows_nd(seed, 0, dim, tuple(tail), distribution,
                             device=device).reshape(dim, q)
    qmat, r = torch.linalg.qr(p.T)
    sign = torch.sign(torch.diagonal(r))
    return (qmat * sign).T


def _project_ortho(seed, g: torch.Tensor, dim: int, distribution: str):
    b = _ortho_basis(seed, dim, tuple(g.shape), distribution, g.device)
    u = b @ g.reshape(-1).to(torch.float32)
    return u, torch.ones_like(u)


def _reconstruct_ortho(seed, scale: torch.Tensor, tail, distribution: str,
                       dtype=torch.float32) -> torch.Tensor:
    tail = (tail,) if isinstance(tail, int) else tuple(tail)
    b = _ortho_basis(seed, int(scale.shape[0]), tail, distribution,
                     scale.device)
    return (scale.to(torch.float32) @ b).reshape(tail).to(dtype)


def _batched(project_one, reconstruct_one):
    """Per-leaf backend functions over the ``n_stack`` compartments of a
    leaf from single-compartment ones (the reference's vmap, written out
    as a loop)."""

    def project_flat(seeds, g, dim, distribution):
        outs = [project_one(seeds[i], g[i], dim, distribution)
                for i in range(g.shape[0])]
        return (torch.stack([u for u, _ in outs]),
                torch.stack([sq for _, sq in outs]))

    def reconstruct_flat(seeds, scale, tail, distribution):
        return torch.stack([reconstruct_one(seeds[i], scale[i], tail,
                                            distribution)
                            for i in range(scale.shape[0])])

    return project_flat, reconstruct_flat


def _norm_scales(plan: Plan, lp: LeafPlan, u, sq):
    """Normalized coordinates ``u * f``: f = 1/sqrt(Q) (rsqrt_dim), the
    inverse row norms (exact) or 1 ("none", and "orthonormal", whose rows
    are unit already).  The reconstruction folds the same factor in again
    (:func:`_recon_scale`)."""
    if plan.normalization == "rsqrt_dim":
        return u * float(np.float32(1.0 / np.sqrt(lp.size)))
    if plan.normalization == "exact":
        return u * torch.rsqrt(torch.clamp(sq, min=1e-30))
    return u


def _unravel_tree(flat2d: torch.Tensor, plan: Plan, params_like) -> dict:
    """The (K, size) virtual leaf of a flatten plan -> a parameter map
    shaped and typed like ``params_like``."""
    vec = flat2d.reshape(-1)
    if plan.pad:
        vec = vec[: vec.shape[0] - plan.pad]
    out, off = {}, 0
    for name in leaf_order(params_like):
        ref = params_like[name]
        n = int(np.prod(ref.shape, dtype=np.int64))
        out[name] = vec[off: off + n].reshape(ref.shape).to(ref.dtype)
        off += n
    return out


def _leaf_tail(lp: LeafPlan) -> tuple[int, ...]:
    """One compartment's tensor shape."""
    return tuple(lp.shape[1:]) if lp.stacked else tuple(lp.shape)


def _leaf_backend(plan: Plan, backend: str):
    """(project_flat, reconstruct_flat) of the per-leaf path, batched over
    a leaf's compartments."""
    if plan.normalization == "orthonormal":
        return _batched(_project_ortho, _reconstruct_ortho)
    be = _get_backend(backend)
    return be.project_flat, be.reconstruct_flat


def project(grads, plan: Plan, seed, *, backend: str = "torch",
            return_norms: bool = False, shards=None):
    """Project a gradient map onto the plan's random bases: a list (one
    entry per LeafPlan) of normalized ``(n_stack, dim)`` coordinates, one
    projection launch per leaf on the cuda backend.  ``return_norms``
    also returns the squared row norms (same shapes), which a colocated
    reconstruction reuses under 'exact' normalization.  With leaf
    ``shards`` (module docstring) the partials are completed over the
    model group first; the norms are then returned completed under
    'exact' and as None otherwise (no reconstruction reads them)."""
    if _sharded(shards):
        exact = plan.normalization == "exact"
        u, sq = project_partials(grads, plan, seed, backend=backend,
                                 shards=shards)
        u, sq = complete_partials(u, sq if exact else None, shards.group)
        coords = [_norm_scales(plan, lp, u[i], sq[i] if exact else None)
                  for i, lp in enumerate(plan.leaves)]
        return (coords, sq) if return_norms else coords
    proj_flat, _ = _leaf_backend(plan, backend)
    sources = ({"<flat>": _ravel_tree(grads, plan)} if plan.flatten
               else grads)
    coords, norms = [], []
    for lp in plan.leaves:
        g = sources[lp.name].reshape((lp.n_stack,) + _leaf_tail(lp))
        u, sq = proj_flat(_leaf_seeds(seed, lp), g, lp.dim,
                          plan.distribution)
        coords.append(_norm_scales(plan, lp, u, sq))
        norms.append(sq)
    if return_norms:
        return coords, norms
    return coords


def _sharded(shards) -> bool:
    return shards is not None and shards.m > 1


def project_partials(grads, plan: Plan, seed, *, backend: str = "torch",
                     shards) -> tuple[list, list]:
    """The raw ``(u, sq)`` partials, each a list of ``(n_stack, dim)``
    float32 blocks, of this rank's leaf shards (module docstring): the
    shard instances for a sharded leaf, the whole projection of a
    replicated leaf on its rank (``i % m``) and zeros elsewhere.  Their
    sums over the group's ranks are the unsharded ``(u, sq)``."""
    _check_shardable(plan)
    fns = _shard_backend(plan, backend)
    us, sqs = [], []
    for i, lp in enumerate(plan.leaves):
        seeds = _leaf_seeds(seed, lp)
        g = grads[lp.name]
        cm = shards.colmap(lp.name, lp.stacked)
        if cm is not None:
            u, sq = fns.project(seeds, g.reshape(lp.n_stack, -1), lp,
                                plan.distribution, cm, shards)
        elif i % shards.m == shards.r:
            u, sq = fns.project_whole(
                seeds, g.reshape((lp.n_stack,) + _leaf_tail(lp)), lp.dim,
                plan.distribution)
        else:
            u = torch.zeros((lp.n_stack, lp.dim), dtype=torch.float32,
                            device=g.device)
            sq = torch.zeros_like(u)
        us.append(u.to(torch.float32))
        sqs.append(sq.to(torch.float32))
    return us, sqs


def complete_partials(u: list, sq, group):
    """Sum per-leaf partials over the model ``group`` with ONE all-reduce
    of their concatenation -- ``u`` alone, or ``u`` and ``sq`` widened
    when ``sq`` is given ('exact') -- and split them back (``sq`` None
    stays None).  Shards run in turn on one device have no group: their
    caller sums :func:`project_partials` itself."""
    if group is None:
        raise ValueError(
            "leaf shards without a model group: run the shards in turn "
            "with project_partials and sum the partials in shard order")
    from repro_torch.core import distributed

    flat_u = torch.cat([x.reshape(-1) for x in u])
    flat_sq = None if sq is None else torch.cat([x.reshape(-1) for x in sq])
    flat_u, flat_sq = distributed.complete_model_partials(flat_u, flat_sq,
                                                          group)
    return _split_like(flat_u, u), (None if sq is None
                                    else _split_like(flat_sq, sq))


def _split_like(flat: torch.Tensor, like: list) -> list:
    out, off = [], 0
    for x in like:
        out.append(flat[off: off + x.numel()].reshape(x.shape))
        off += x.numel()
    return out


def _check_shardable(plan: Plan) -> None:
    if plan.flatten:
        raise ValueError("a flattened plan (granularity global / even) "
                         "takes no leaf shards: its one virtual leaf spans "
                         "every parameter")


class _ShardFns(NamedTuple):
    """A backend's per-leaf functions on leaf shards: ``project(seeds,
    rows, lp, dist, colmap, shards)`` -> partial (u, sq); ``reconstruct(
    seeds, scale, lp, q_local, dist, colmap, shards)`` -> (n_stack,
    q_local) float32; ``project_whole`` the unsharded projection (a
    replicated leaf)."""

    project: Any
    reconstruct: Any
    project_whole: Any


def _shard_backend(plan: Plan, backend: str) -> _ShardFns:
    from repro_torch.kernels import rbd_project, rbd_reconstruct

    proj_whole, _ = _leaf_backend(plan, backend)
    if plan.normalization == "orthonormal":
        return _ShardFns(_project_ortho_shard, _reconstruct_ortho_shard,
                         proj_whole)
    if backend == "cuda":
        proj, recon = (rbd_project.project_flat_shard,
                       rbd_reconstruct.reconstruct_flat_shard)
    elif backend == "torch":
        proj, recon = (rbd_project.project_flat_shard_plain,
                       rbd_reconstruct.reconstruct_flat_shard_plain)
    else:
        raise ValueError(f"unknown projector backend {backend!r}")

    def project_shard(seeds, rows, lp, dist, cm, shards):
        return proj(seeds, rows.to(torch.float32).contiguous(), lp.dim,
                    dist, colmap=cm)

    def reconstruct_shard(seeds, scale, lp, q_local, dist, cm, shards):
        return recon(seeds, scale.to(torch.float32), q_local, dist,
                     colmap=cm)

    return _ShardFns(project_shard, reconstruct_shard, proj_whole)


def _ortho_shard_basis(seed, lp: LeafPlan, cm, shards, distribution,
                       device) -> torch.Tensor:
    """One compartment's whole QR basis, built from its seed (as on every
    rank), cut to the shard's columns: ``(dim, q_local)``."""
    from repro_torch.kernels.rbd_project import shard_columns

    tail = tuple(shards.shapes[lp.name])[1 if lp.stacked else 0:]
    cols = rng.to_uint32(shard_columns(cm, 0, lp.size // shards.m, "cpu"))
    idx = torch.from_numpy(cols.astype(np.int64)).to(device)
    return _ortho_basis(seed, lp.dim, tail, distribution, device)[:, idx]


def _project_ortho_shard(seeds, rows, lp, distribution, cm, shards):
    u = torch.stack([
        _ortho_shard_basis(seeds[s], lp, cm, shards, distribution,
                           rows.device) @ rows[s].to(torch.float32)
        for s in range(lp.n_stack)])
    return u, torch.ones_like(u)


def _reconstruct_ortho_shard(seeds, scale, lp, q_local, distribution, cm,
                             shards):
    return torch.stack([
        scale[s].to(torch.float32) @ _ortho_shard_basis(
            seeds[s], lp, cm, shards, distribution, scale.device)
        for s in range(lp.n_stack)])


def _recon_scale(plan: Plan, lp: LeafPlan, seeds, coords, proj_flat,
                 sq=None):
    """Per-direction reconstruction scales ``c * f`` of one leaf, ``f`` the
    normalization factor; 'exact' without ``sq`` regenerates the row norms
    with a projection of zeros (one more launch per leaf)."""
    if plan.normalization == "rsqrt_dim":
        return coords * float(np.float32(1.0 / np.sqrt(lp.size)))
    if plan.normalization == "exact":
        if sq is None:
            zeros = torch.zeros((lp.n_stack,) + _leaf_tail(lp),
                                dtype=torch.float32, device=coords.device)
            _, sq = proj_flat(seeds, zeros, lp.dim, plan.distribution)
        return coords * torch.rsqrt(torch.clamp(sq, min=1e-30))
    return coords


def reconstruct(coords: list, plan: Plan, seed, params_like, *,
                backend: str = "torch", row_sq: list | None = None,
                shards=None) -> dict:
    """Map per-leaf coordinates back to a full-space update map shaped and
    typed like ``params_like``: ``sum_i c_i phi_hat_i`` per compartment,
    one reconstruction launch per leaf on the cuda backend.  ``row_sq``
    (from ``project(..., return_norms=True)``) saves the 'exact'
    normalization a regeneration pass; a worker that only received
    coordinates passes None.  With leaf ``shards`` ``params_like`` is this
    rank's shard map and so is the update (module docstring); 'exact'
    without ``row_sq`` regenerates the norms' partials and completes them
    over the model group."""
    proj_flat, recon_flat = _leaf_backend(plan, backend)
    sharded = _sharded(shards)
    if sharded:
        _check_shardable(plan)
        row_sq = _shard_row_sq(plan, seed, params_like, backend, shards,
                               row_sq)
        fns = _shard_backend(plan, backend)

    def one_leaf(i, lp):
        seeds = _leaf_seeds(seed, lp)
        sq = row_sq[i] if row_sq is not None else None
        scale = _recon_scale(plan, lp, seeds, coords[i].to(torch.float32),
                             proj_flat, sq)
        cm = shards.colmap(lp.name, lp.stacked) if sharded else None
        if cm is not None:
            return fns.reconstruct(seeds, scale, lp, lp.size // shards.m,
                                   plan.distribution, cm, shards).reshape(
                shards.local_shape(lp.name))
        delta = recon_flat(seeds, scale, _leaf_tail(lp), plan.distribution)
        return delta.reshape(lp.shape)

    if plan.flatten:
        return _unravel_tree(one_leaf(0, plan.leaves[0]), plan, params_like)
    deltas = {lp.name: one_leaf(i, lp).to(params_like[lp.name].dtype)
              for i, lp in enumerate(plan.leaves)}
    return {name: deltas[name] if name in deltas
            else torch.zeros(ref.shape, dtype=ref.dtype,
                             device=coords[0].device)
            for name, ref in params_like.items()}


def _shard_row_sq(plan: Plan, seed, params_like, backend, shards, row_sq):
    """'exact' row norms of a sharded reconstruction: ``row_sq`` as given,
    else regenerated from a projection of zeros on the shards and
    completed over the model group (one all-reduce); None for the other
    normalizations."""
    if plan.normalization != "exact" or row_sq is not None:
        return row_sq
    zeros = {lp.name: torch.zeros(params_like[lp.name].shape,
                                  dtype=torch.float32,
                                  device=params_like[lp.name].device)
             for lp in plan.leaves}
    _, sq = project_partials(zeros, plan, seed, backend=backend,
                             shards=shards)
    sq, _ = complete_partials(sq, None, shards.group)
    return sq


def reconstruct_apply(coords: list, plan: Plan, seed, params, eta, *,
                      backend: str = "torch", row_sq: list | None = None,
                      shards=None) -> dict:
    """Per-leaf fused apply ``theta' = theta - eta * (c_hat @ P)``: one
    ``reconstruct_apply_flat`` launch per leaf on the cuda backend (its
    shard instance on a sharded leaf), the delta never in memory, theta
    rounded once into its dtype.  The torch backend, 'orthonormal' and
    flatten plans reconstruct, then subtract (the reference's
    fallback)."""
    if backend != "cuda" or plan.normalization == "orthonormal" \
            or plan.flatten:
        delta = reconstruct(coords, plan, seed, params, backend=backend,
                            row_sq=row_sq, shards=shards)
        return {k: (p.to(torch.float32)
                    - eta * delta[k].to(torch.float32)).to(p.dtype)
                for k, p in params.items()}
    from repro_torch.kernels import rbd_reconstruct

    be = _get_backend(backend)
    sharded = _sharded(shards)
    if sharded:
        row_sq = _shard_row_sq(plan, seed, params, backend, shards, row_sq)
    out = dict(params)
    for i, lp in enumerate(plan.leaves):
        seeds = _leaf_seeds(seed, lp)
        sq = row_sq[i] if row_sq is not None else None
        scale = _recon_scale(plan, lp, seeds, coords[i].to(torch.float32),
                             be.project_flat, sq)
        theta = params[lp.name]
        rows = theta.reshape(lp.n_stack, -1).contiguous()
        cm = shards.colmap(lp.name, lp.stacked) if sharded else None
        if cm is None:
            new = be.reconstruct_apply_flat(seeds, scale, rows, eta,
                                            plan.distribution)
        else:
            new = rbd_reconstruct.reconstruct_apply_flat_shard(
                seeds, scale, rows, eta, plan.distribution, colmap=cm)
        out[lp.name] = new.reshape(theta.shape)
    return out


def rbd_gradient(grads, plan: Plan, seed, *, backend: str = "torch",
                 shards=None) -> dict:
    """The RBD low-rank gradient sketch ``P_hat^T P_hat g`` (the paper's
    g^RBD): projection, then reconstruction reusing its row norms (on
    leaf ``shards``: this rank's part of it)."""
    coords, norms = project(grads, plan, seed, backend=backend,
                            return_norms=True, shards=shards)
    return reconstruct(coords, plan, seed, grads, backend=backend,
                       row_sq=norms, shards=shards)


# ---------------------------------------------------------------------------
# materialized bases (trajectory_pca / gradient_informed BasisSpec)
# ---------------------------------------------------------------------------
#
# The random path never stores a basis.  The materialized path inverts the
# trade: the basis IS data, a (d, q_packed) row-orthonormal tensor carried
# on ``core.rbd.RBDState.basis`` and refreshed by the training loop's
# collector (``train.loop.BasisCollector``).  The rows are orthonormal by
# construction (every refresh ends in a QR), so projection and
# reconstruction are two dense products with no normalization factor.  No
# kernel of the reference computes them: they are library matmuls, as the
# reference's are XLA's.


def materialize_random_basis(plan: Plan, layout, seed, *, device,
                             generator=None) -> torch.Tensor:
    """Initial (total_dim, q_packed) row-orthonormal basis: a Gaussian
    (q, d) draw from ``generator`` (default: a generator on ``device``
    seeded with ``seed & 0x7FFFFFFF``), its padding rows zeroed, then
    :func:`orthonormal_rows`.  A zero row of the input stays exactly zero,
    so an update through the basis never writes a padding slot.  The
    values are not the reference's (``jax.random`` is not reproducible
    here); the properties are."""
    d = int(plan.total_dim)
    q = int(layout.q_packed)
    if q < d:
        raise ValueError(
            f"materialized basis needs q_packed >= d ({q} < {d})")
    if generator is None and torch.device(device).type != "meta":
        # (a meta tensor -- the dry run's -- holds no values to draw)
        generator = torch.Generator(device=device).manual_seed(
            int(seed) & 0x7FFFFFFF)
    a = torch.randn((q, d), generator=generator, dtype=torch.float32,
                    device=device)
    a.mul_(torch.from_numpy(layout.param_valid).to(device)[:, None])
    return orthonormal_rows(a)


# rows of the (q, d) input taken to float64 at a time by orthonormal_rows
QR_CHUNK_ROWS = 1 << 22


def orthonormal_rows(a: torch.Tensor,
                     chunk: int = QR_CHUNK_ROWS) -> torch.Tensor:
    """The (d, q) transpose of the Q of a tall (q, d) float32 matrix:
    rows orthonormal, spanning ``a``'s columns.  CholeskyQR2: twice, the
    (d, d) Gram matrix summed in float64 over row chunks, its Cholesky
    factor R, and ``a <- a R^-1`` in float64, rounded to float32 in place.
    A QR by Householder reflections (``torch.linalg.qr``) faults on the
    card once q * d passes 2**31 (q = 151,049,216, d = 25 at full
    qwen2-0.5b width); this one needs no workspace beyond a chunk, and a
    zero row of ``a`` stays exactly zero."""
    q, d = a.shape
    eye = torch.eye(d, dtype=torch.float64, device=a.device)
    for _ in range(2):
        gram = torch.zeros((d, d), dtype=torch.float64, device=a.device)
        for i in range(0, q, chunk):
            c = a[i: i + chunk].to(torch.float64)
            gram.addmm_(c.T, c)
        r = torch.linalg.cholesky(gram, upper=True)
        r_inv = torch.linalg.solve_triangular(r, eye, upper=True)
        for i in range(0, q, chunk):
            rows = a[i: i + chunk]
            rows.copy_(rows.to(torch.float64) @ r_inv)
    return a.T.contiguous()


def refresh_materialized_basis(basis, snapshots):
    """New (d, q_packed) row-orthonormal basis from collected snapshots
    (host numpy, the reference's code line for line, so the same inputs
    give the same bits).

    The top right-singular vectors of the (m, q) snapshot matrix lead
    (rows norm-scaled first); rows of the OLD basis fill the remaining
    slots, and one float64 QR re-orthonormalizes the stack.  All-zero
    snapshots leave the old basis unchanged."""
    basis = np.asarray(basis, np.float32)
    d = basis.shape[0]
    m = np.asarray(snapshots, np.float32).reshape(-1, basis.shape[1])
    norms = np.linalg.norm(m, axis=1)
    m = m[norms > 1e-30]
    if not len(m):
        return basis
    m = m / np.linalg.norm(m, axis=1, keepdims=True)
    _, _, vt = np.linalg.svd(m, full_matrices=False)
    cand = np.concatenate([vt[:d], basis], axis=0)
    qmat, _ = np.linalg.qr(cand.T.astype(np.float64))
    new = np.ascontiguousarray(qmat[:, :d].T.astype(np.float32))
    # positions the old basis never touched (padding) stay exactly zero
    new *= (np.abs(basis) > 0).any(axis=0).astype(np.float32)
    return new


def project_materialized(basis: torch.Tensor,
                         g_packed: torch.Tensor) -> torch.Tensor:
    """(d,) coordinates of the packed gradient on the stored basis: one
    (d, q) @ (q,) product, no kernel launch.  This buffer is what the
    data group's mean sees."""
    return torch.mv(basis, g_packed.to(torch.float32))


def reconstruct_apply_materialized(coords, basis, theta,
                                   eta) -> torch.Tensor:
    """``theta' = theta - eta * (c @ B)`` on the packed buffer: one (d,) @
    (d, q) product, rounded, then scaled and subtracted (the reference's
    two roundings).  The rows are orthonormal, so there is no
    normalization factor."""
    return (theta.to(torch.float32)
            - float(np.float32(eta))
            * (coords.to(torch.float32) @ basis))


# ---------------------------------------------------------------------------
# backend dispatch (plain PyTorch vs the CUDA kernels)
# ---------------------------------------------------------------------------


@functools.cache
def _get_backend(name: str):
    from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step

    if name == "torch":
        project_flat, reconstruct_flat = _batched(_project_flat,
                                                  _reconstruct_flat)
        return _Backend(
            rbd_step.project_packed_plain,
            rbd_step.reconstruct_apply_packed_plain,
            rbd_step.reconstruct_apply_packed_workers_plain,
            rbd_step.reconstruct_apply_packed_adapters_plain,
            project_flat, reconstruct_flat,
            rbd_reconstruct.reconstruct_apply_flat_plain,
            rbd_step.project_packed_sharded_plain,
            rbd_step.reconstruct_apply_packed_sharded_plain,
            rbd_step.reconstruct_apply_packed_workers_sharded_plain)
    if name == "cuda":
        return _Backend(rbd_step.project_packed,
                        rbd_step.reconstruct_apply_packed,
                        rbd_step.reconstruct_apply_packed_workers,
                        rbd_step.reconstruct_apply_packed_adapters,
                        _flat_project(rbd_project.project_flat),
                        _flat_reconstruct(rbd_reconstruct.reconstruct_flat),
                        rbd_reconstruct.reconstruct_apply_flat,
                        rbd_step.project_packed_sharded,
                        rbd_step.reconstruct_apply_packed_sharded,
                        rbd_step.reconstruct_apply_packed_workers_sharded)
    raise ValueError(f"unknown projector backend {name!r}")


def _flat_project(kernel):
    """A per-leaf kernel wrapper taking (n_stack, q) rows -> the backend's
    (seeds, g of shape (n_stack, *tail), dim, distribution) contract."""

    def project_flat(seeds, g, dim, distribution):
        rows = g.reshape(g.shape[0], -1).to(torch.float32).contiguous()
        return kernel(seeds, rows, dim, distribution)

    return project_flat


def _flat_reconstruct(kernel):
    def reconstruct_flat(seeds, scale, tail, distribution):
        tail = (tail,) if isinstance(tail, int) else tuple(tail)
        q = int(np.prod(tail, dtype=np.int64)) if tail else 1
        out = kernel(seeds, scale.to(torch.float32), q, distribution)
        return out.reshape((scale.shape[0],) + tail)

    return reconstruct_flat


class _Backend:
    def __init__(self, project, reconstruct_apply, reconstruct_apply_workers,
                 reconstruct_apply_adapters, project_flat, reconstruct_flat,
                 reconstruct_apply_flat, project_sharded,
                 reconstruct_apply_sharded, reconstruct_apply_workers_sharded):
        self.project_packed = project
        self.reconstruct_apply_packed = reconstruct_apply
        self.reconstruct_apply_packed_workers = reconstruct_apply_workers
        self.reconstruct_apply_packed_adapters = reconstruct_apply_adapters
        # per-leaf: batched over a leaf's (n_stack,) compartments
        self.project_flat = project_flat
        self.reconstruct_flat = reconstruct_flat
        self.reconstruct_apply_flat = reconstruct_apply_flat
        # model-sharded: one (q_slab,) slab of the padded packed buffer
        self.project_packed_sharded = project_sharded
        self.reconstruct_apply_packed_sharded = reconstruct_apply_sharded
        self.reconstruct_apply_packed_workers_sharded = \
            reconstruct_apply_workers_sharded
