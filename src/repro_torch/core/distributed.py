"""Shared-seed distributed RBD over ``torch.distributed`` (port of
``repro.core.distributed``; paper Algorithm 1, right column).

Two parallelization modes over the data-parallel process group:

* ``shared_basis`` -- every worker draws the SAME basis and projects its
  own gradient shard; the (d_packed,) coordinates are averaged by one
  all-reduce.  Mathematically single-worker RBD on the global batch.
* ``independent_bases`` -- worker k draws its own basis (seed folded with
  k + 1), so the K workers jointly span a K*d-dimensional subspace.  The
  (d_packed,) coordinates are all-gathered into the (K, d_packed) joint
  buffer and every worker regenerates all K bases to apply the combined
  update in one launch (``projector.reconstruct_apply_packed_workers``).

Either way the per-step exchange is exactly ONE collective of a
coordinate-sized buffer -- widened to the concatenated (2*d_packed,)
coords+norms buffer under 'exact' normalization -- never anything
parameter-sized.  The per-leaf strategies (packing off, weight decay) keep
that count: every leaf's ``(n_stack, dim)`` coordinates travel in one
concatenated buffer (:func:`shared_basis_coords`,
:func:`shared_basis_update`, :func:`independent_bases_update`).  Only the
paper's SGD baseline (RBD off) averages the full-D gradient
(:func:`grad_mean`), counted apart as ``grad_all_reduce``.

Model-sharded slabs (``--model m``): each rank of a model group of m
holds one slab of the packed buffer; its projection is a partial sum
that ONE all-reduce SUM over the model group completes
(:func:`complete_model_partials`, counted as ``model_all_reduce``),
before the unchanged data-axis exchange.

Axis names: the reference names a mesh axis; here ``"data"`` names the
default (world) process group, and a ``ProcessGroup`` is taken as it is
-- the data and model groups of a ``(data, model)`` mesh, which
``repro_torch.launch.mesh`` builds.  The
collectives are ``all_reduce`` (SUM, then a divide by the world size:
the reference's pmean) and ``all_gather`` into the rows of one (K, n)
buffer, both of which gloo and NCCL implement, issued with
``async_op=True`` so that :func:`start_exchange` returns at once and
:func:`finish_exchange` waits.

The resilience sentinel's checksum (``core.resilience.sentinel_rider``)
rides the one coordinate exchange as one extra trailing element
(``rider=``): the payload grows by one float, the collective count does
not.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import projector, rng

# collectives issued, by kind: the coordinate exchanges of start_exchange
# (the contract is exactly one per optimizer step), the scalar all-reduces
# of mean_scalar (metrics, e.g. the loss), the full-D gradient mean of
# the SGD baseline (grad_mean), the model-axis completion of the sharded
# projection (complete_model_partials, one per optimizer step) and the
# forward's all-gather of the slabs (all_gather_slabs, the one D-sized
# collective of the sharded path, outside the optimizer step) and the
# resilience repair's broadcasts from rank 0 (resilience.
# resync_from_worker0: one per state buffer, only after a detection) and
# the packed-gradient mean the gradient_informed basis collector reads
# (basis_grad_mean: on the metrics path, outside the update); under
# pjit-style parameter sharding, the forward's all-gathers of the leaf
# shards over the model group (models.registry.LeafShards.gather, one a
# sharded leaf a layer, again in the recompute) and the update norm's
# scalar sum over the model group (model_sum_scalar, metrics path)
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "scalar": 0,
               "grad_all_reduce": 0, "model_all_reduce": 0,
               "model_all_gather": 0, "resync": 0,
               "basis_grad_all_reduce": 0, "leaf_all_gather": 0,
               "model_scalar": 0}
# counted apart from the step's: the resilience snapshot's all-gather of
# the slabs over the writer's model group (all_gather_slabs, at snapshot
# steps only, outside the step)
SNAPSHOT_COLLECTIVES = {"all_gather": 0}


def reset_counts() -> None:
    for counts in (COLLECTIVES, SNAPSHOT_COLLECTIVES):
        for k in counts:
            counts[k] = 0


def process_group(axis_name):
    """The process group an axis name stands for."""
    if isinstance(axis_name, str):
        if axis_name != "data":
            raise ValueError(
                f"unknown axis {axis_name!r}: 'data' names the default "
                "process group; pass a ProcessGroup for any other")
        return dist.group.WORLD
    if axis_name is None:
        raise ValueError("axis_name=None has no process group")
    return axis_name


def axis_index(axis_name) -> int:
    return dist.get_rank(process_group(axis_name))


def worker_seed(transform, state, axis_name) -> torch.Tensor:
    """Per-(step, worker) seed for independent_bases mode:
    ``fold_seed(step_seed, k + 1)`` on worker k."""
    base = transform.step_seed(state.step)
    return rng.fold_seed(base, axis_index(axis_name) + 1)


def mean_scalar(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Mean of a scalar over the group (the reference's metrics pmean of
    the loss): one all-reduce of one element, outside the coordinate
    exchange."""
    buf = x.detach().to(torch.float32, copy=True).reshape(1)
    group = process_group(axis_name)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["scalar"] += 1
    return buf[0] / dist.get_world_size(group)


# ---------------------------------------------------------------------------
# widened coords+norms exchange ('exact' normalization on the packed path)
# ---------------------------------------------------------------------------


def widen_coord_buffer(coords, sq) -> torch.Tensor:
    """(..., d_packed) coords and squared row norms -> the (...,
    2*d_packed) buffer that is the one exchange quantity under 'exact'
    normalization (the collective count stays one, the payload
    doubles)."""
    return torch.cat([coords.to(torch.float32), sq.to(torch.float32)],
                     dim=-1)


def split_coord_buffer(buf, d_packed: int):
    """Inverse of :func:`widen_coord_buffer`."""
    return buf[..., :d_packed], buf[..., d_packed:]


def complete_model_partials(u_partial, sq_partial, model_axis, *,
                            words=None):
    """Complete the model-sharded projection with ONE all-reduce SUM over
    the model group.

    ``u_partial`` (and ``sq_partial``) are a slab's raw partial sums
    (``projector.project_packed_sharded``).  ``sq_partial=None``
    (static-factor normalizations): the sum of the (d_packed,) u buffer
    alone -- the norms are not needed for the update and stay
    slab-local.  ``sq_partial`` given ('exact'): the sum widens to the
    (2*d_packed,) u+sq buffer, one collective still.  Callers normalize
    the completed sums and hand them to the unchanged data-axis exchange:
    one coordinate-sized collective per axis, nothing D-sized.
    ``words`` (the sentinel's (2,) share of this rank,
    ``resilience.sentinel_words``) trail the payload, summed by the same
    collective; the return then grows to ``(u, sq, words)``.  With
    ``model_axis=None`` the partials are returned untouched."""
    if model_axis is None:
        out = u_partial, sq_partial
        return out if words is None else out + (words,)
    group = process_group(model_axis)
    widened = sq_partial is not None
    buf = (widen_coord_buffer(u_partial, sq_partial) if widened
           else u_partial.to(torch.float32, copy=True))
    if words is not None:
        buf = torch.cat([buf, words.to(torch.float32)])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["model_all_reduce"] += 1
    d = u_partial.shape[-1]
    n = 2 * d if widened else d
    out = (split_coord_buffer(buf[:n], d) if widened else (buf[:n], None))
    return out if words is None else out + (buf[n:],)


def model_sum_scalar(x: torch.Tensor, model_axis) -> torch.Tensor:
    """Sum of a scalar over the model group (the update norm's squared
    sum over leaf shards): one all-reduce of one element, counted as
    ``model_scalar``."""
    buf = x.detach().to(torch.float32, copy=True).reshape(1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                    group=process_group(model_axis))
    COLLECTIVES["model_scalar"] += 1
    return buf[0]


def all_gather_slabs(out: torch.Tensor, slab: torch.Tensor,
                     model_axis, *, snapshot: bool = False) -> torch.Tensor:
    """Every rank's (q_slab,) slab, in rank order, into the (m * q_slab,)
    buffer ``out``: the forward's all-gather of the model-sharded
    parameters (counted as ``model_all_gather``), or with ``snapshot`` a
    resilience snapshot's (counted in ``SNAPSHOT_COLLECTIVES``)."""
    group = process_group(model_axis)
    rows = out.view(dist.get_world_size(group), -1)
    dist.all_gather(list(rows.unbind(0)), slab.contiguous(), group=group)
    if snapshot:
        SNAPSHOT_COLLECTIVES["all_gather"] += 1
    else:
        COLLECTIVES["model_all_gather"] += 1
    return out


def is_group(axis_name) -> bool:
    """Whether ``axis_name`` names a process group of this process (the
    shards in turn name their model axis with a plain string instead:
    one process stands for the whole group)."""
    return dist.is_initialized() and (
        axis_name == "data" or isinstance(axis_name, dist.ProcessGroup))


class PendingExchange(NamedTuple):
    """Token of an ISSUED coordinate exchange: :func:`start_exchange`
    issues the one per-step collective as soon as the projection output
    exists, :func:`finish_exchange` waits for it where the apply needs
    the result.  ``kind`` is ``"pmean"`` (shared_basis), ``"all_gather"``
    (independent_bases) or ``"local"`` (no collective: one process, or
    the sequential K-worker simulation)."""

    kind: str       # "pmean" | "all_gather" | "local"
    buf: Any        # the collective's output buffer (or the local coords)
    sq: Any         # local row-norm passthrough (non-widened; else None)
    d: int          # d_packed (split point of the widened buffer)
    widened: bool
    work: Any = None   # torch.distributed work handle
    world: int = 1     # group size (the pmean divisor)
    has_rider: bool = False   # one sentinel scalar trails the payload
    rider_local: Any = None   # the locally computed rider


def start_exchange(coords, sq, axis_name, *, kind: str = "pmean",
                   widened: bool = False, rider=None) -> PendingExchange:
    """Issue the single per-step coordinate collective and return its
    token.  ``coords``/``sq`` are the LOCAL (d_packed,) projection
    outputs; ``widened=True`` ('exact') puts the norms on the wire, and
    ``rider`` (a 0-d float32 tensor) appends the one sentinel scalar: a
    payload of d + 1, or 2d + 1 widened.  With ``axis_name=None`` (or
    ``kind="local"``) nothing is issued."""
    d = coords.shape[-1]
    has_rider = rider is not None
    if axis_name is None or kind == "local":
        return PendingExchange("local", coords, sq, d, widened,
                               has_rider=has_rider, rider_local=rider)
    group = process_group(axis_name)
    world = dist.get_world_size(group)
    # a fresh buffer: the collective writes it in place
    body = (widen_coord_buffer(coords, sq) if widened
            else coords.to(torch.float32, copy=True))
    if has_rider:
        body = torch.cat([body, rider.reshape(1).to(torch.float32)], dim=-1)
    if kind == "pmean":
        work = dist.all_reduce(body, op=dist.ReduceOp.SUM, group=group,
                               async_op=True)
        buf = body
        COLLECTIVES["all_reduce"] += 1
    elif kind == "all_gather":
        buf = body.new_empty((world,) + tuple(body.shape))
        work = dist.all_gather(list(buf.unbind(0)), body, group=group,
                               async_op=True)
        COLLECTIVES["all_gather"] += 1
    else:
        raise ValueError(f"unknown exchange kind {kind!r}")
    return PendingExchange(kind, buf, None if widened else sq, d, widened,
                           work, world, has_rider, rider)


def finish_exchange(pending: PendingExchange):
    """Wait for a :class:`PendingExchange` and split the exchanged buffer
    into ``(coords, sq)``.  ``sq`` is the exchanged norms when widened,
    the local passthrough otherwise (``None`` on a non-widened
    all-gather, which never carried norms).  With a rider the return
    grows to ``(coords, sq, rider)``: the mean of the ranks' riders
    (pmean), the gathered (K,) riders (all-gather) or the local one."""
    kind, buf, d = pending.kind, pending.buf, pending.d
    if kind == "local":
        if pending.has_rider:
            return buf, pending.sq, pending.rider_local
        return buf, pending.sq
    pending.work.wait()
    if kind == "pmean":
        buf = buf / pending.world
    if pending.has_rider:
        rider = buf[..., -1]
        buf = buf[..., :-1]
    if not pending.widened:
        out = buf, (pending.sq if kind == "pmean" else None)
    else:
        out = split_coord_buffer(buf, d)
    return out + (rider,) if pending.has_rider else out


def shared_basis_packed_exchange(coords, sq, axis_name, *,
                                 widened: bool = False):
    """The packed sharedseed exchange: ONE all-reduce mean per step, of
    the (d_packed,) coordinates or, widened, the (2*d_packed,)
    coords+norms buffer.  Returns ``(coords, sq)``."""
    return finish_exchange(start_exchange(coords, sq, axis_name,
                                          kind="pmean", widened=widened))


def basis_grad_mean(g_packed: torch.Tensor, axis_name) -> torch.Tensor:
    """The packed (q_packed,) gradient averaged over the group, for the
    gradient_informed basis collector: one all-reduce on the metrics path
    of that configuration only, counted as ``basis_grad_all_reduce`` (the
    update itself still exchanges (d,) floats)."""
    buf = g_packed.to(torch.float32, copy=True)
    group = process_group(axis_name)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["basis_grad_all_reduce"] += 1
    return buf / dist.get_world_size(group)


def grad_mean(grads: dict, axis_name) -> dict:
    """The SGD baseline's data-parallel gradient mean: ONE all-reduce of
    every leaf's gradient, concatenated (the D-sized collective the paper
    eliminates), counted as ``grad_all_reduce``."""
    names = list(grads)
    buf = torch.cat([grads[k].reshape(-1).to(torch.float32) for k in names])
    group = process_group(axis_name)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["grad_all_reduce"] += 1
    buf /= dist.get_world_size(group)
    out, off = {}, 0
    for k in names:
        n = grads[k].numel()
        out[k] = buf[off: off + n].reshape(grads[k].shape).to(grads[k].dtype)
        off += n
    return out


def _exchange_leaf_coords(coords: list, axis_name, kind: str) -> list:
    """Every leaf's (n_stack, dim) coordinates through ONE collective of
    their concatenation: the mean (``"pmean"``, element for element the
    reference's per-leaf pmeans) or the (K, n_stack, dim) gathers
    (``"all_gather"``)."""
    flat = torch.cat([c.reshape(-1).to(torch.float32) for c in coords])
    buf, _ = finish_exchange(start_exchange(flat, None, axis_name,
                                            kind=kind))
    out, off = [], 0
    for c in coords:
        n = c.numel()
        out.append(buf[..., off: off + n].reshape(
            tuple(buf.shape[:-1]) + tuple(c.shape)))
        off += n
    return out


def shared_basis_coords(transform, local_grads: dict, state, axis_name, *,
                        shards=None):
    """The per-leaf shared-basis exchange: project the local gradient map
    on the step's basis, average the coordinates of all leaves with one
    all-reduce.  Returns ``(coords, row_sq)`` in the ``projector.project``
    convention (the norms are the same on every worker: one basis).  On
    leaf ``shards`` the projection is first completed over the model
    group (``projector.project``)."""
    seed = transform.step_seed(state.step)
    coords, norms = projector.project(
        local_grads, transform.plan, seed, backend=transform.backend,
        return_norms=True, shards=shards)
    return _exchange_leaf_coords(coords, axis_name, "pmean"), norms


def shared_basis_update(transform, local_grads: dict, state, axis_name, *,
                        shards=None):
    """All workers, one basis: average the coordinates, reconstruct
    locally.  Returns ``(update map, new RBDState)``; the full-space
    strategy (weight decay) runs its optimizer on the update."""
    from repro_torch.core.rbd import RBDState

    coords, norms = shared_basis_coords(transform, local_grads, state,
                                        axis_name, shards=shards)
    update = projector.reconstruct(
        coords, transform.plan, transform.step_seed(state.step),
        local_grads, backend=transform.backend, row_sq=norms, shards=shards)
    return update, RBDState(step=state.step + 1)


def independent_bases_start_exchange(transform, local_grads, state,
                                     axis_name, *, layout=None,
                                     prepacked: bool = True,
                                     prng="threefry",
                                     return_norms: bool = False,
                                     rider=None) -> PendingExchange:
    """Project the worker's gradient onto its OWN basis and issue the one
    all-gather of its (d_packed,) coordinates -- (2*d_packed,) with the
    norms when ``return_norms`` ('exact'), one more element with a
    ``rider`` -- into the (K, ...) joint buffer; returns the token."""
    plan = transform.plan
    layout = layout if layout is not None else plan.packed()
    proj = projector.project_packed(
        local_grads, plan, worker_seed(transform, state, axis_name),
        backend=transform.backend, layout=layout, prepacked=prepacked,
        prng=prng, return_norms=return_norms)
    coords, sq = proj if return_norms else (proj, None)
    return start_exchange(coords, sq, axis_name, kind="all_gather",
                          widened=return_norms, rider=rider)


def independent_bases_coords(transform, local_grads, state, axis_name, *,
                             layout=None, prepacked: bool = True,
                             prng="threefry", return_norms: bool = False):
    """The packed independent-bases exchange (Algorithm 1 on the packed
    representation): the gathered (K, d_packed) coordinates, or the pair
    ``(coords, sq)`` of gathered buffers when ``return_norms``."""
    coords, sq = finish_exchange(independent_bases_start_exchange(
        transform, local_grads, state, axis_name, layout=layout,
        prepacked=prepacked, prng=prng, return_norms=return_norms))
    return (coords, sq) if return_norms else coords


def independent_bases_update(transform, local_grads: dict, state,
                             axis_name, *, shards=None):
    """Paper Algorithm 1 on the per-leaf path: project on this worker's
    own basis, all-gather every leaf's coordinates in one collective, then
    regenerate each worker's basis in turn (K reconstructions, one launch
    per leaf each; 'exact' regenerates each worker's row norms with one
    more projection per leaf, completed over the model group on leaf
    ``shards``) and average the K updates.  Returns ``(update map, new
    RBDState)``."""
    from repro_torch.core.rbd import RBDState

    plan, backend = transform.plan, transform.backend
    coords = projector.project(local_grads, plan,
                               worker_seed(transform, state, axis_name),
                               backend=backend, shards=shards)
    gathered = _exchange_leaf_coords(coords, axis_name, "all_gather")
    k_workers = int(gathered[0].shape[0])
    base_seeds = projector.worker_base_seeds(
        transform.step_seed(state.step), k_workers)
    total = None
    for k in range(k_workers):
        upd = projector.reconstruct([g[k] for g in gathered], plan,
                                    base_seeds[k], local_grads,
                                    backend=backend, shards=shards)
        total = upd if total is None else {n: total[n] + upd[n]
                                           for n in total}
    update = {n: x / k_workers for n, x in total.items()}
    return update, RBDState(step=state.step + 1)


def grad_comm_bytes(plan, n_params: int, k_workers: int, mode: str, *,
                    packed: bool = False, widened: bool = False) -> dict:
    """Per-step gradient communication, counted as the reference counts
    it: a ring all-reduce of D floats (sgd) or of the d coordinates
    (shared_basis), an all-gather of K coordinate vectors
    (independent_bases).  ``packed`` counts the (d_packed,) buffer,
    ``widened`` doubles it (coords+norms)."""
    d = plan.packed().d_packed if packed else plan.total_dim
    if widened:
        d *= 2
    if mode == "sgd":
        payload = 4 * n_params * 2 * (k_workers - 1) / k_workers
    elif mode == "shared_basis":
        payload = 4 * d * 2 * (k_workers - 1) / k_workers
    elif mode == "independent_bases":
        payload = 4 * d * (k_workers - 1)
    else:
        raise ValueError(mode)
    return {"mode": mode, "bytes_per_step": payload, "dim": d,
            "D": n_params, "packed": packed}
