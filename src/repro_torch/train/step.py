"""Training step: loss, gradient, random-bases sketch, parameter update
(port of ``repro.train.step``).

The whole update chain is owned by
:class:`repro_torch.optim.subspace.SubspaceOptimizer`; this module only
computes the loss and gradient and threads state.  On the packed
two-launch step ``TrainState.params`` holds the packed (q_packed,) float32
buffer across steps: the forward pass reads views of it, so autograd
delivers the gradient as a packed buffer (zero on the padding), and the
update is two kernel launches.  On the unpacked strategies (packing off,
weight decay, RBD off) it holds the parameter map, and the gradient is a
map of the same leaves.

With ``axis_name`` set the step runs on one rank of a data-parallel
process group (``repro_torch.launch.mesh``) and the optimizer performs
the paper's shared-seed coordinate exchange: one collective per
optimizer step, whatever ``grad_accum_steps`` is.  With ``model_axis``
declared as well, ``TrainState.params`` is this rank's slab of the
model-sharded packed buffer: the step all-gathers the slabs for the
forward pass and keeps its own slab of the gradient.  Under pjit-style
parameter sharding (``model_sharded`` with ``leaf_shards``) it is this
rank's map of leaf shards: the forward pass gathers each leaf over the
model group right before its use, and the backward pass keeps this
rank's slice of its gradient; ``dense_grad_axis`` (``--mode pjit`` over
several data ranks) averages that gradient over the data group, the
collective XLA inserts under pjit.

On the materialized ``gradient_informed`` basis the metrics carry
``basis_grad``, the packed gradient (averaged over the data group) that
``train.loop.BasisCollector`` refreshes the basis from.

With ``resilience`` (a ``core.resilience.ResilienceConfig``) the packed
step runs the non-finite guard (``TrainState.guard``), the divergence
sentinel, the replay capture and fault injection, and the metrics gain
their reason-coded entries; each key is present only when its feature is
on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import compartments, distributed, rbd as rbd_lib
from repro_torch.core import resilience as res_lib
from repro_torch.models.registry import Model, resolve_device
from repro_torch.optim import subspace


class TrainState(NamedTuple):
    params: Any             # packed (q_packed,) float32 buffer, or the
                            # parameter map of the unpacked strategies
    rbd_state: Any          # RBDState (() with RBD off)
    opt_state: Any          # coordinate-space state, or shaped like params
                            # on full_space
    step: int
    guard: Any = ()         # resilience.GuardState when the non-finite
                            # guard is on; () keeps the state (and every
                            # snapshot without the guard) unchanged


def softmax_cross_entropy(logits, labels):
    """logits: (B, S, V) float32; labels: (B, S) integer -> mean CE."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    return -torch.mean(ll)


def make_plan(model: Model, rbd_cfg: RBDConfig, params_shape=None):
    """Compartment plan for the model's parameters (shapes only)."""
    if params_shape is None:
        params_shape = model.param_shapes()
    return compartments.make_plan(
        params_shape,
        rbd_cfg.total_dim,
        granularity=rbd_cfg.granularity,
        allocation=rbd_cfg.allocation,
        distribution=rbd_cfg.distribution,
        normalization=rbd_cfg.normalization,
        is_stacked=model.is_stacked,
    )


def make_transform(model: Model, rbd_cfg: RBDConfig, params_shape=None):
    if not rbd_cfg.enabled:
        return None
    plan = make_plan(model, rbd_cfg, params_shape)
    return rbd_lib.RandomBasesTransform(
        plan, base_seed=rbd_cfg.base_seed, redraw=rbd_cfg.redraw,
        backend=rbd_cfg.backend, prng=rbd_cfg.prng_impl,
        basis=rbd_cfg.basis, steps_fpd=rbd_cfg.steps_fpd,
    )


def make_subspace_optimizer(
        model: Model, tcfg: TrainConfig,
        transform: Optional[rbd_lib.RandomBasesTransform] = None,
        axis_name=None, *, k_workers: int = 1, model_sharded: bool = False,
        model_axis=None, model_shards: int = 1, leaf_shards=None,
        device=None, resilience=None) -> subspace.SubspaceOptimizer:
    """The one update-path object for a (model, TrainConfig) pair;
    ``device`` is where its step's tensors live.  ``resilience``: an
    optional ``ResilienceConfig``; it turns on the non-finite step guard,
    the divergence sentinel, coordinate capture (for the replay log, when
    a directory is set) and fault injection on the optimizer."""
    if transform is None and tcfg.rbd.enabled:
        transform = make_transform(model, tcfg.rbd)
    sub_opt = subspace.SubspaceOptimizer.from_config(
        tcfg, transform=transform, axis_name=axis_name,
        k_workers=k_workers, model_sharded=model_sharded,
        model_axis=model_axis, model_shards=model_shards,
        leaf_shards=leaf_shards, params_template=model.param_template(),
        device=device)
    if resilience is not None and resilience.any_enabled:
        sub_opt = dataclasses.replace(
            sub_opt, guard=resilience.guard,
            sentinel_every=resilience.sentinel_every,
            capture_coords=bool(resilience.directory),
            fault_plan=resilience.fault_plan)
    return sub_opt


def make_loss_fn(model: Model, aux_coef: float = 0.01, shards=None):
    """``loss_fn(params, batch)``; with leaf ``shards`` ``params`` holds
    this rank's shards (``registry.LeafShards``)."""
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, shards=shards)
        ce = softmax_cross_entropy(logits, batch["labels"])
        return ce + aux_coef * aux, {"ce": ce, "aux": aux}

    return loss_fn


def stack_microbatches(batches):
    """Stack per-microbatch dicts into the one batch ``train_step`` takes
    when ``grad_accum_steps == len(batches)``: every tensor gains a
    leading (N,) microbatch axis."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def make_train_step(model: Model, tcfg: TrainConfig,
                    transform: Optional[rbd_lib.RandomBasesTransform] = None,
                    axis_name: Optional[str] = None, *,
                    k_workers: int = 1, model_sharded: bool = False,
                    model_axis=None, model_shards: int = 1, leaf_shards=None,
                    dense_grad_axis=None, device="cuda",
                    return_optimizer: bool = False, resilience=None):
    """Returns ``(init_state, train_step)`` -- plus the
    :class:`SubspaceOptimizer` when ``return_optimizer`` is set.

    ``init_state(seed=tcfg.seed, params=None)`` stores ``params`` (a
    parameter map, e.g. from ``registry.params_from_reference``) or a
    fresh random init -- packed on the packed-resident strategy.
    ``train_step(state, batch)`` runs one optimizer step and returns
    ``(new_state, metrics)``.

    ``axis_name``: the data-parallel group of this rank (``"data"``: the
    default process group); the batch is this rank's shard, the loss is
    averaged over the group (a scalar all-reduce on the metrics path)
    and the coordinates are exchanged as ``tcfg.rbd.mode`` says.
    ``k_workers``: the group size, the joint subspace's worker count in
    ``independent_bases`` mode.  ``model_sharded`` declares the
    parameters sharded over a model group; with ``model_axis`` (that
    group, as ``launch.mesh`` builds it) and ``model_shards`` the state
    holds this rank's slab of the packed buffer, and the batch (sharded
    over data) is the same on every rank of the model group; without
    ``model_axis`` the sharding is pjit-style: ``leaf_shards`` (a
    ``registry.LeafShards`` of the model group; None on a group of one)
    cuts the parameter map, the per-leaf strategies run on the shards,
    and ``init_state`` cuts the map it stores.  ``dense_grad_axis``: the
    data group whose mean of the dense gradient ``--mode pjit`` takes
    (``distributed.grad_mean``; None: no mean), with the loss averaged
    over it too.
    With ``tcfg.grad_accum_steps == N > 1`` every batch tensor carries a
    leading (N,) microbatch axis
    (:func:`stack_microbatches`): the gradients accumulate in the packed
    buffer and the step runs once -- two launches, one collective.
    ``resilience``: an optional ``ResilienceConfig`` (see
    :func:`make_subspace_optimizer`): ``TrainState.guard`` carries the
    guard state, gradient faults are injected after accumulation and
    before the sketch -- on the model-sharded slabs into this rank's slab
    of the gradient, keyed on the data index as the reference keys its
    ``shard_map``'d injection, so a ``nan_grad`` event writes element 0 of
    every slab of the targeted data worker -- and the metrics gain
    ``guard_reason``, ``guard_count``, ``guard_lr_scale``,
    ``sentinel_diverged``, ``replay_coords`` and ``replay_row_sq`` -- each
    only when its feature is on."""
    device = resolve_device(device)
    n_accum = int(tcfg.grad_accum_steps)
    if n_accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {n_accum}")
    loss_fn = make_loss_fn(model, model.cfg.router_aux_coef, leaf_shards)
    sub_opt = make_subspace_optimizer(
        model, tcfg, transform, axis_name, k_workers=k_workers,
        model_sharded=(model_sharded or model_axis is not None
                       or leaf_shards is not None),
        model_axis=model_axis,
        model_shards=model_shards if model_axis is not None else 1,
        leaf_shards=leaf_shards, device=device, resilience=resilience)
    eplan = sub_opt.check_supported()
    split = eplan.strategy == "fused_packed"
    emit_basis_grad = eplan.materialized and eplan.basis == "gradient_informed"
    guard_on = sub_opt.guard is not None
    sharded = model_axis is not None

    def init_state(seed: Optional[int] = None, params=None) -> TrainState:
        if params is None:
            params = model.init(tcfg.seed if seed is None else seed,
                                device=device)
        params = {k: v.to(device) for k, v in params.items()}
        if leaf_shards is not None:
            from repro_torch.models.registry import shard_params

            params = shard_params(params, leaf_shards)
        return TrainState(
            params=sub_opt.prepare_params(params),
            rbd_state=sub_opt.init_rbd_state(params),
            opt_state=sub_opt.init_opt_state(params, device=device),
            step=0,
            guard=res_lib.guard_init(device) if guard_on else (),
        )

    def grad_of(params, batch):
        if isinstance(params, dict):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss, metrics = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(leaves.items(), grads)}
        elif sharded:
            # one forward and backward on the gathered slabs, then this
            # rank's slab of the packed gradient.  The reference
            # differentiates through the all-gather, whose transpose sums
            # the m identical cotangents of the model group's replicated
            # batch, and rescales by 1/m; for m a power of two (m * g) / m
            # is g bit for bit, so the two agree exactly there, and to
            # rounding otherwise.
            full = sub_opt.gather_params(params).detach().requires_grad_(
                True)
            loss, metrics = loss_fn(sub_opt.materialize_params(full), batch)
            (grads,) = torch.autograd.grad(loss, full)
            grads = sub_opt.slab_of(grads)
        else:
            stored = params.detach().requires_grad_(True)
            loss, metrics = loss_fn(sub_opt.materialize_params(stored),
                                    batch)
            (grads,) = torch.autograd.grad(loss, stored)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch):
        if n_accum == 1:
            loss, metrics, grads = grad_of(state.params, batch)
        else:
            acc, losses, parts = None, [], []
            for i in range(n_accum):
                mloss, mmetrics, mgrads = grad_of(
                    state.params, {k: v[i] for k, v in batch.items()})
                acc = sub_opt.accumulate_grads(acc, mgrads)
                losses.append(mloss)
                parts.append(mmetrics)
            grads = sub_opt.finalize_accum(acc, n_accum)
            loss = sum(losses) / n_accum
            metrics = {k: sum(m[k] for m in parts) / n_accum
                       for k in parts[0]}
        if dense_grad_axis is not None:
            # pjit over several data ranks: the dense gradient's mean over
            # the data group (the D-sized collective XLA inserts)
            grads = distributed.grad_mean(grads, dense_grad_axis)
        if sub_opt.fault_plan is not None:
            grads = res_lib.inject_grad_faults(
                sub_opt.fault_plan, state.rbd_state.step, grads,
                worker_index=(distributed.axis_index(axis_name)
                              if axis_name is not None else None))
        with torch.no_grad():
            params = state.params
            if split:
                ticket = sub_opt.step_sketch(params, grads, state.rbd_state,
                                             state.opt_state)
            if axis_name is not None or dense_grad_axis is not None:
                # overlap window: the coordinate collective is in flight
                # under the issue_early schedule while the loss is averaged
                loss = distributed.mean_scalar(
                    loss, axis_name if axis_name is not None
                    else dense_grad_axis)
            if split:
                params, rbd_state, opt_state, aux = sub_opt.step_finish(
                    params, ticket, state.rbd_state, state.opt_state,
                    state.guard)
            else:
                params, rbd_state, opt_state, aux = sub_opt.step(
                    params, grads, state.rbd_state, state.opt_state,
                    state.guard)
        metrics.update(loss=loss, update_norm=aux.update_norm)
        if emit_basis_grad:
            # the collector needs the GLOBAL mean gradient: a (q_packed,)
            # all-reduce of this configuration's metrics path only
            metrics["basis_grad"] = (
                grads if axis_name is None
                else distributed.basis_grad_mean(grads, axis_name))
        if guard_on:
            metrics.update(guard_reason=aux.reason,
                           guard_count=aux.guard.nonfinite_count,
                           guard_lr_scale=aux.guard.lr_scale)
        if sub_opt.sentinel_every:
            metrics["sentinel_diverged"] = aux.diverged
        if sub_opt.capture_coords:
            metrics["replay_coords"] = aux.coords
            if not isinstance(aux.row_sq, tuple):  # () = no norms
                metrics["replay_row_sq"] = aux.row_sq
        return TrainState(params, rbd_state, opt_state, state.step + 1,
                          aux.guard if guard_on else state.guard), metrics

    if return_optimizer:
        return init_state, train_step, sub_opt
    return init_state, train_step
