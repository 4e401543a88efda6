"""Coordinate-space subspace optimizer (port of ``repro.optim.subspace``).

:class:`SubspaceOptimizer` owns the whole update chain of one step

    packed gradient -> project (launch 1) -> [one coordinate collective]
    -> coordinate-space optimizer (sgd | momentum | adam | lbfgs |
    newton, with optional clipping before and an LR schedule after) ->
    reconstruct-apply (launch 2)

on the ``fused_packed`` strategy: the parameters stay packed in one
``(q_packed,)`` float32 buffer across steps, and the step is two kernel
launches whatever the number of compartments.  :func:`plan_from_flags`
is the reference's decision function, strategy names and reason strings
unchanged.

``materialized_packed`` (``basis=trajectory_pca | gradient_informed``)
keeps the basis itself as data, a (total_dim, q_packed) row-orthonormal
tensor on ``RBDState.basis``: the step is one projection product, one
(d,) all-reduce over the data group, the coordinate optimizer and one
apply product -- no kernel launch -- and the training loop's
``train.loop.BasisCollector`` refreshes the basis.  The second-order
optimizers pair coordinate gradients across steps, so they run only where
the basis is fixed between steps: the materialized path, or FPD
(``redraw=False``) on the packed step.

The unpacked strategies keep the parameters as a map ``{leaf name:
tensor}`` and run one launch per ``LeafPlan`` instead:
``fused_per_leaf`` (packing off, cuda backend: project -> coordinate
optimizer on the per-leaf ``(n_stack, dim)`` list -> fused
reconstruct-apply), ``coord_unfused`` (the torch backend or the
``orthonormal`` normalization: project -> optimizer -> reconstruct ->
apply) and ``full_space`` (weight decay, the per-leaf independent bases
or RBD off: the RBD sketch -- or the raw gradient, mean-reduced over the
group -- then ``+ wd * p`` and the optimizer on the parameter map).

Distributed modes (``core.distributed``, paper Algorithm 1): with
``axis_name`` set, ``shared_basis`` averages the (d_packed,) coordinates
with one all-reduce, and ``independent_bases`` all-gathers them into the
(K, d_packed) joint buffer, keeps the optimizer state on that buffer and
applies all K workers' bases in one launch with ``eta = lr / K``.  With
``axis_name=None`` and ``k_workers > 1``, ``independent_bases`` runs the
sequential K-worker simulation on stacked (K, q_packed) gradients.  The
collective is issued at sketch time (``issue_early``) or at finish time
(``sync``, ``overlap="off"``); both send the same payload through the
same collective, so they are bit-identical.

Model-sharded slabs (``model_axis`` declared, ``model_shards = m``): each
rank of the model group keeps one (q_slab,) slab of the zero-padded
packed buffer (``core.compartments.ShardedPackedLayout``).  The sketch
projects the slab's gradient into partial sums (launch 1 on the slab),
completes them with ONE all-reduce over the model group (widened under
'exact'), normalizes and hands the coordinates to the unchanged data-axis
exchange; the finish applies the replicated coordinates to the slab
(launch 2 on the slab).  The forward pass reads the slabs all-gathered
over the model group (:meth:`SubspaceOptimizer.gather_params`), the one
D-sized collective, outside the optimizer step.
:meth:`SubspaceOptimizer.step_shards_in_turn` runs the m shards of a
model group one after the other in one process (one device), with the
completion a sum in shard order.

Resilience hooks (``core.resilience``; all off by default): ``guard``
(the non-finite step guard), ``sentinel_every`` (the divergence sentinel,
its checksum riding the one exchange), ``capture_coords`` (the
post-exchange coordinates on ``aux``, the replay log's record) and
``fault_plan`` (fault injection).  They need the packed two-launch step,
and the decision stays on the device: no host synchronization is added
to the step.  :meth:`SubspaceOptimizer.apply_exchanged` is the
post-exchange half both the live step and the coordinate replay run.

Pjit-style parameter sharding (``model_sharded`` without ``model_axis``):
the parameter map holds this rank's leaf shards (``leaf_shards``, a
``models.registry.LeafShards`` of the model group), and
``fused_per_leaf``, ``coord_unfused`` and ``full_space`` run on them --
the per-leaf kernels' shard instances, one all-reduce over the model group
completing every leaf's projection partials (``core.projector``), the
(d,)-sized coordinate state replicated, a full-space state that mirrors
the parameters (momentum's ``m``, adam's ``mu`` and ``nu``) sharded like
them.  The update norm of the metrics sums its squares over the group
(one scalar all-reduce).

The resilience hooks run on the model-sharded slabs too.  The sketch
completes the coordinates over the model group, so the guard's decision
(read from the completed coordinates) is the same on every rank of the
group; the sentinel's share of each slab rides the completion all-reduce
(``core.resilience.sentinel_words``), so every rank of the mesh folds the
same whole-buffer checksum and reaches the same verdict; the finish chain
-- fault injection on the received payload, the reason code, the
sentinel check, the guard's transition -- is the unsharded step's, then
the apply on the slab.  :meth:`SubspaceOptimizer.apply_exchanged` takes
this rank's slab, or the list of a group's slabs in turn, which is how
the coordinate replay runs on slabs: one slab apply a record.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import BASIS_SPECS, KERNEL_BACKEND
from repro_torch.core import (compartments, distributed, projector,
                              resilience, rng)
from repro_torch.core.compartments import PACKABLE_NORMALIZATIONS
from repro_torch.core.rbd import RandomBasesTransform, RBDState
from repro_torch.optim import transforms as opt


class ExecutionPlan(NamedTuple):
    """Static decision of how one optimizer step executes, with a
    structured reason code (surfaced by ``launch/dryrun.py``)."""

    strategy: str          # fused_packed | materialized_packed
                           # | fused_per_leaf | coord_unfused | full_space
    packed_resident: bool  # TrainState stores params packed across steps
    reason: str            # human-readable decision trail
    prng_impl: str = "threefry"   # EFFECTIVE core.rng.PrngSpec impl (the
                                  # requested impl after reason-coded
                                  # degradation: hw off-TPU -> emulated,
                                  # tile-keyed on per-leaf -> threefry)
    prng_reason: str = ""         # why that impl was selected
    overlap_exchange: str = "none"  # issue_early | sync | none -- where
                                    # the one coordinate collective is
                                    # issued relative to the split step
                                    # (sketch-time vs finish-time vs no
                                    # collective at all)
    overlap_reason: str = ""        # why that schedule was selected
    basis: str = "random"           # EFFECTIVE core.rbd BasisSpec (the
                                    # requested spec after reason-coded
                                    # degradation: materialized specs
                                    # fall back to random redraw where
                                    # no resident basis can exist)
    basis_reason: str = ""          # why that basis was selected

    @property
    def fused(self) -> bool:
        return self.strategy in ("fused_packed", "fused_per_leaf")

    @property
    def coord_space(self) -> bool:
        """Optimizer state lives in the d-dimensional coordinate space."""
        return self.strategy != "full_space"

    @property
    def materialized(self) -> bool:
        """The basis is a stored (d, q_packed) array on RBDState, not
        regenerated from (seed, counters) each step."""
        return self.strategy == "materialized_packed"


def plan_from_flags(*, optimizer: str = "sgd", weight_decay: float = 0.0,
                    rbd_enabled: bool = True, use_packed: bool = False,
                    normalization: str = "rsqrt_dim", backend: str = "jnp",
                    mode: str = "shared_basis", axis_name=None,
                    model_sharded: bool = False,
                    model_axis=None,
                    k_workers: int = 1,
                    prng_impl: str = "threefry",
                    hw_prng_available: bool = False,
                    overlap: str = "auto",
                    basis: str = "random") -> ExecutionPlan:
    """The one fuse/state-placement decision point: a pure function of
    the config flags with the reference's strategy names and reason
    strings, so both packages share one catalog (docs/PLANS.md).  The
    port's kernel backend ``"cuda"`` plays the reference's ``"pallas"``.
    Strategies the port does not run yet are still planned here;
    :class:`SubspaceOptimizer` raises on them, naming the ROADMAP item.
    """
    del optimizer  # all optimizers have coordinate-space state now
    if basis not in BASIS_SPECS:
        raise ValueError(
            f"unknown basis spec {basis!r}; expected one of {BASIS_SPECS}")
    model_sharded = model_sharded or model_axis is not None
    joint = (mode == "independent_bases"
             and (axis_name is not None or k_workers > 1))

    def _resolve_basis():
        """(effective basis, reason, materialized ExecutionPlan | None).

        The RANDOM path must stay byte-identical, so this never touches
        the random reason codes -- it only decides whether a requested
        materialized spec can actually hold a resident basis."""
        if basis == "random":
            return "random", (
                "per-step random redraw (paper default): the basis is "
                "regenerated from (seed, counters), never stored"), None
        if not rbd_enabled:
            return "random", (
                f"{basis} requested but rbd is disabled -> no subspace "
                "exists, basis spec unused"), None
        if weight_decay:
            return "random", (
                f"{basis} requested but weight_decay forces the "
                "full-space sketch path -> no resident coordinate "
                "subspace to materialize; per-step random redraw"), None
        if joint:
            return "random", (
                f"{basis} requested but independent_bases workers each "
                "redraw a per-worker basis; per-worker trajectory "
                "buffers do not compose with the joint (K, d) exchange "
                "-> per-step random redraw"), None
        if model_sharded:
            return "random", (
                f"{basis} requested but the model-sharded layout "
                "regenerates basis slabs device-locally; a materialized "
                "(d, q) basis would itself need sharding -> per-step "
                "random redraw"), None
        source = ("PCA of the trajectory ring buffer"
                  if basis == "trajectory_pca"
                  else "SVD of the packed gradient-sketch history")
        why = (
            f"{basis}: resident (d, q_packed) row-orthonormal basis on "
            f"RBDState, refreshed from {source} by the loop's collector "
            "-- orthonormal by construction, so every normalization's "
            "scale is exactly 1")
        mplan = ExecutionPlan(
            "materialized_packed", True,
            "materialized-basis step: dense (d, q_packed) basis stored "
            "on RBDState -> sketch and apply are two XLA matmuls (0 "
            "kernel launches -- relaxes the two-launch invariant, keeps "
            "the one (d,) coordinate exchange and the packed-resident "
            "TrainState)")
        return basis, why, mplan

    def _decide() -> ExecutionPlan:
        if not rbd_enabled:
            return ExecutionPlan(
                "full_space", False,
                "rbd disabled -> full-space optimizer on raw gradients")
        if weight_decay:
            return ExecutionPlan(
                "full_space", False,
                "weight_decay couples updates to full-space params -> "
                "unfused full-space path")
        if mode == "independent_bases" and (axis_name is not None
                                            or k_workers > 1):
            if not use_packed:
                return ExecutionPlan(
                    "full_space", False,
                    "independent_bases per-leaf exchange -> K per-worker "
                    "bases, full-space optimizer state (use_packed joins "
                    "the K*d coordinate space)")
            if normalization == "orthonormal":
                return ExecutionPlan(
                    "full_space", False,
                    "independent_bases with orthonormal normalization "
                    "materializes a QR basis per worker -> per-leaf "
                    "full-space path (no basis= escape: materialized "
                    "BasisSpecs do not compose with the per-worker "
                    "joint exchange either)")
            if model_sharded and model_axis is None:
                return ExecutionPlan(
                    "full_space", False,
                    "independent_bases with model-axis param sharding but "
                    "no declared model mesh axis (pjit-style) -> per-leaf "
                    "full-space path (the packed-resident buffer would "
                    "replicate the params; declare model_axis to shard "
                    "the packed theta buffer instead)")
            if model_sharded:
                if normalization == "exact":
                    return ExecutionPlan(
                        "fused_packed", True,
                        "model-sharded packed independent_bases with exact "
                        "row norms: slab-partial projection on own basis, "
                        "completed by one widened (2d,) coords+norms psum "
                        "over the model axis -> one widened all-gather "
                        "over data -> (K, d) joint-coordinate optimizer "
                        "-> K-worker reconstruct-apply on the local theta "
                        "slab; sharded packed-resident TrainState")
                return ExecutionPlan(
                    "fused_packed", True,
                    "model-sharded packed independent_bases: slab-partial "
                    "projection on own basis, completed by one (d,) psum "
                    "over the model axis -> one all-gather over data -> "
                    "(K, d) joint-coordinate optimizer -> K-worker "
                    "reconstruct-apply on the local theta slab; sharded "
                    "packed-resident TrainState")
            if normalization == "exact":
                return ExecutionPlan(
                    "fused_packed", True,
                    "packed independent_bases with exact row norms: "
                    "project on own basis (norms in-kernel) -> one "
                    "widened (2d,) coords+norms all-gather -> (K, d) "
                    "joint-coordinate optimizer -> K-worker "
                    "reconstruct-apply with per-worker exact scales; "
                    "packed-resident TrainState")
            return ExecutionPlan(
                "fused_packed", True,
                "packed independent_bases: project on own basis -> one "
                "(d,) all-gather -> (K, d) joint-coordinate optimizer -> "
                "K-worker reconstruct-apply; packed-resident TrainState")
        if normalization not in PACKABLE_NORMALIZATIONS:
            return ExecutionPlan(
                "coord_unfused", False,
                f"{normalization} normalization with a random basis -> "
                "unfused (materializes a QR basis per compartment; a "
                "materialized BasisSpec -- basis=trajectory_pca / "
                "gradient_informed -- is orthonormal by construction "
                "and keeps the packed-resident path); coordinate-space "
                "state")
        if use_packed and model_sharded and model_axis is not None:
            if normalization == "exact":
                return ExecutionPlan(
                    "fused_packed", True,
                    "model-sharded packed two-launch step with exact row "
                    "norms: slab-partial projection completed by one "
                    "widened (2d,) coords+norms psum over the model axis, "
                    "composed with the one sharedseed pmean over data -> "
                    "(d,)-replicated coordinate optimizer -> reconstruct-"
                    "apply on the local theta slab; sharded packed-"
                    "resident TrainState")
            return ExecutionPlan(
                "fused_packed", True,
                "model-sharded packed two-launch step: slab-partial "
                "projection completed by one (d,) psum over the model "
                "axis, composed with the one sharedseed pmean over data "
                "-> (d,)-replicated coordinate optimizer -> reconstruct-"
                "apply on the local theta slab; sharded packed-resident "
                "TrainState")
        if use_packed and model_sharded:
            if backend == KERNEL_BACKEND:
                return ExecutionPlan(
                    "fused_per_leaf", False,
                    "model-axis param sharding without a declared model "
                    "mesh axis (pjit-style) is incompatible with the "
                    "packed-resident buffer -> per-leaf fused apply "
                    "(declare model_axis to shard the packed theta "
                    "buffer instead)")
            return ExecutionPlan(
                "coord_unfused", False,
                "model-axis param sharding without a declared model "
                "mesh axis (pjit-style) is incompatible with the "
                "packed-resident buffer -> per-leaf XLA-fused stages "
                "(declare model_axis to shard the packed theta buffer "
                "instead)")
        if use_packed:
            if normalization == "exact":
                return ExecutionPlan(
                    "fused_packed", True,
                    "packed two-launch step with exact row norms "
                    "(in-kernel, second projection output; the sharedseed "
                    "exchange is one widened (2d,) coords+norms pmean): "
                    "project -> (d,)-state coordinate optimizer -> "
                    "reconstruct-apply; packed-resident TrainState")
            return ExecutionPlan(
                "fused_packed", True,
                "packed two-launch step: project -> (d,)-state coordinate "
                "optimizer -> reconstruct-apply; packed-resident TrainState")
        if backend == KERNEL_BACKEND:
            return ExecutionPlan(
                "fused_per_leaf", False,
                "packing disabled -> per-leaf fused reconstruct-apply; "
                "coordinate-space state")
        return ExecutionPlan(
            "coord_unfused", False,
            "jnp backend unpacked -> per-leaf XLA-fused stages (no kernel "
            "launches); coordinate-space state")

    eff_basis, basis_why, mplan = _resolve_basis()
    eplan = mplan if mplan is not None else _decide()
    impl, why = rng.resolve_prng_impl(
        prng_impl, strategy=eplan.strategy, backend=backend,
        hw_available=hw_prng_available, rbd_enabled=rbd_enabled)
    joint_sim = (mode == "independent_bases" and axis_name is None
                 and k_workers > 1)
    if eplan.strategy == "materialized_packed":
        if axis_name is None:
            ov, ov_why = "none", (
                "axis_name=None: no data-axis collective exists; the "
                "materialized sketch and apply matmuls run back-to-back")
        else:
            ov, ov_why = "sync", (
                "materialized-basis step: the one (d,) pmean is issued "
                "synchronously between the dense sketch and apply "
                "matmuls (no launch-split window to overlap under)")
    elif eplan.strategy != "fused_packed":
        ov, ov_why = "none", (
            f"no packed split step: the {eplan.strategy} strategy has "
            "no single coordinate collective to overlap")
    elif axis_name is None and joint_sim:
        ov, ov_why = "none", (
            "sequential K-worker simulation: the 'gather' is local "
            "lax.map compute, there is no collective latency to hide")
    elif axis_name is None:
        ov, ov_why = "none", (
            "axis_name=None: no data-axis collective exists; sketch and "
            "finish run back-to-back"
            + (" (the model-axis completion psum is synchronous at "
               "sketch time)" if model_axis is not None else ""))
    elif overlap == "off":
        ov, ov_why = "sync", (
            "overlap disabled: the collective is issued at finish time "
            "(synchronous reference path, bit-identical payload)")
    else:
        kind = ("all-gather" if mode == "independent_bases" else "pmean")
        ov, ov_why = "issue_early", (
            f"one {kind} issued at sketch (right after the projection "
            "launch), awaited at apply (just before the reconstruct-"
            "apply launch); the window between the split halves "
            "overlaps the collective under XLA's async scheduler -- "
            "still exactly ONE collective site")
    return eplan._replace(prng_impl=impl, prng_reason=why,
                          overlap_exchange=ov, overlap_reason=ov_why,
                          basis=eff_basis, basis_reason=basis_why)


class _Aux(NamedTuple):
    """Step byproducts.  The resilience fields stay () unless their
    feature is on."""

    update_norm: torch.Tensor
    coords: Any = ()      # post-exchange coordinate buffer (replay capture)
    row_sq: Any = ()      # its squared row norms, when the step has them
    guard: Any = ()       # new GuardState (non-finite step guard on)
    reason: Any = ()      # int32 REASON_* code of this step (guard on)
    diverged: Any = ()    # bool sentinel verdict (sentinel on)


class StepTicket(NamedTuple):
    """State of a split packed step between :meth:`SubspaceOptimizer.
    step_sketch` and :meth:`SubspaceOptimizer.step_finish`.  Under the
    ``issue_early`` schedule (and with no collective at all) ``pending``
    holds the :class:`~repro_torch.core.distributed.PendingExchange`;
    under the ``sync`` schedule ``pending`` is None and the local
    projection outputs ride on ``coords``/``sq`` until finish issues the
    collective."""

    pending: Any = None   # PendingExchange, or None on the sync schedule
    coords: Any = None    # local (d_packed,) coordinates (sync schedule)
    sq: Any = None        # local squared row norms (sync schedule)
    rider: Any = None     # locally computed sentinel rider scalar
    local_ok: Any = ()    # pre-exchange finite check (guard on,
                          # shared_basis only; () = not computed)


@dataclasses.dataclass(frozen=True, eq=False)
class SubspaceOptimizer:
    """``init`` / ``step`` over the sketch -> optimizer -> apply chain.

    ``params``/``grads`` flow through :meth:`step` in the STORED
    representation: the packed (q_packed,) float32 buffer (see
    :meth:`prepare_params` / :meth:`materialize_params`)."""

    transform: Optional[RandomBasesTransform] = None
    optimizer: str = "sgd"
    learning_rate: float = 0.01
    weight_decay: float = 0.0
    momentum_beta: float = 0.9
    nesterov: bool = False
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    mode: str = "shared_basis"
    use_packed: bool = False
    axis_name: Any = None
    k_workers: int = 1
    model_sharded: bool = False
    model_axis: Any = None
    model_shards: int = 1
    leaf_shards: Any = None           # models.registry.LeafShards of the
                                      # pjit-style route (None: whole
                                      # leaves, a model group of one)
    overlap: str = "auto"
    switch_policy: str = "reset"
    coord_clip_norm: float = 0.0      # >0: clip the (d,) coordinate
                                      # gradient to this global norm
                                      # before the optimizer
    lr_schedule: str = "constant"     # LR schedule after the optimizer
                                      # ("constant" | "cosine")
    lr_warmup_steps: int = 0          # linear warmup steps of the schedule
    lr_total_steps: int = 0           # cosine horizon (TrainConfig.steps)
    lbfgs_history: int = 8            # (m, d) ring depth of lbfgs
    log_update_norm: bool = True
    params_template: Any = None       # {name: tensor} of shapes/dtypes
                                      # (meta tensors will do)
    device: Any = None                # where the step's tensors live:
                                      # the hw PRNG needs the cuda
                                      # backend on a CUDA device
    # -- resilience hooks (core.resilience; all off by default) --
    guard: Any = None                 # GuardConfig -> non-finite step guard
    sentinel_every: int = 0           # divergence-sentinel cadence (0=off)
    capture_coords: bool = False      # emit post-exchange coords on aux
                                      # (the replay log's per-step record)
    fault_plan: Any = None            # FaultPlan (tests only)

    @classmethod
    def from_config(cls, tcfg, transform=None, axis_name=None,
                    model_sharded=False, params_template=None,
                    k_workers: int = 1, model_axis=None,
                    model_shards: int = 1, leaf_shards=None,
                    device=None) -> "SubspaceOptimizer":
        return cls(
            transform=transform,
            optimizer=tcfg.optimizer,
            learning_rate=tcfg.learning_rate,
            weight_decay=tcfg.weight_decay,
            momentum_beta=tcfg.momentum_beta,
            nesterov=tcfg.nesterov,
            adam_b1=tcfg.adam_b1,
            adam_b2=tcfg.adam_b2,
            adam_eps=tcfg.adam_eps,
            mode=tcfg.rbd.mode,
            use_packed=tcfg.rbd.use_packed,
            axis_name=axis_name,
            k_workers=k_workers,
            model_sharded=model_sharded,
            model_axis=model_axis,
            model_shards=model_shards,
            leaf_shards=leaf_shards,
            switch_policy=tcfg.rbd.switch_policy,
            coord_clip_norm=tcfg.coord_clip_norm,
            lr_schedule=tcfg.lr_schedule,
            lr_warmup_steps=tcfg.lr_warmup_steps,
            lr_total_steps=tcfg.steps,
            lbfgs_history=tcfg.lbfgs_history,
            log_update_norm=tcfg.log_update_norm,
            params_template=params_template,
            device=device,
        )

    # -- static planning ----------------------------------------------------

    def plan_execution(self) -> ExecutionPlan:
        t = self.transform
        return plan_from_flags(
            optimizer=self.optimizer,
            weight_decay=self.weight_decay,
            rbd_enabled=t is not None,
            use_packed=self.use_packed,
            normalization=(t.plan.normalization if t else "rsqrt_dim"),
            backend=(t.backend if t else "torch"),
            mode=self.mode,
            axis_name=self.axis_name,
            model_sharded=self.model_sharded,
            model_axis=self.model_axis,
            k_workers=self.k_workers,
            prng_impl=(t.prng if t else "threefry"),
            hw_prng_available=self.hw_prng_available(),
            overlap=self.overlap,
            basis=(t.basis if t else "random"),
        )

    def hw_prng_available(self) -> bool:
        """The counterpart of the reference's "real TPU kernels exist":
        the kernel backend, with the step's tensors on a CUDA device.
        Elsewhere a requested ``hw`` resolves to ``hw_emulated``, with the
        reference's reason."""
        t = self.transform
        return (t is not None and t.backend == KERNEL_BACKEND
                and self.device is not None
                and torch.device(self.device).type == "cuda")

    @property
    def joint_subspace(self) -> bool:
        """True when the K-worker joint subspace (independent_bases) is
        active -- over a process group (axis_name set) or in the
        sequential K-worker simulation (k_workers > 1, axis_name None)."""
        return self.mode == "independent_bases" and (
            self.axis_name is not None or self.k_workers > 1)

    def check_supported(self) -> ExecutionPlan:
        """The execution plan, or ``NotImplementedError`` naming the
        ROADMAP item of a route this slice does not run."""
        eplan = self.plan_execution()
        if self.model_axis is not None and eplan.strategy != "fused_packed":
            raise ValueError(
                "a declared model_axis shards the packed buffer into slabs, "
                "which needs the packed step (the cuda backend, or "
                "packed='on'); pjit-style sharding declares model_sharded "
                f"with leaf_shards instead: {eplan.reason}")
        if self.leaf_shards is not None and (
                eplan.packed_resident or not self.model_sharded):
            raise ValueError(
                "leaf_shards are the pjit-style route's (model_sharded "
                f"without model_axis), not {eplan.strategy!r}'s")
        if self.model_axis is not None and self.joint_subspace \
                and self.axis_name is None:
            raise ValueError(
                "the sequential K-worker simulation does not compose with "
                "model_axis (the slab projection needs real groups); run "
                "over a data group")
        return eplan

    @property
    def resilience_active(self) -> bool:
        return bool(self.guard is not None or self.sentinel_every
                    or self.capture_coords or self.fault_plan is not None)

    def _check_resilience(self, eplan) -> None:
        if self.resilience_active and eplan.strategy != "fused_packed":
            raise ValueError(
                "resilience features (guard/sentinel/replay capture/"
                "fault injection) require the packed two-launch "
                f"strategy; this config plans {eplan.strategy!r} -- "
                + eplan.reason)

    def _optimizer(self) -> opt.Transform:
        base = opt.get_optimizer(
            self.optimizer, momentum_beta=self.momentum_beta,
            nesterov=self.nesterov, adam_b1=self.adam_b1,
            adam_b2=self.adam_b2, adam_eps=self.adam_eps,
            learning_rate=self.learning_rate,
            lbfgs_history=self.lbfgs_history)
        pre = ([opt.clip_by_global_norm(self.coord_clip_norm)]
               if self.coord_clip_norm else [])
        post = ([opt.schedule(self.lr_schedule,
                              total_steps=self.lr_total_steps,
                              warmup_steps=self.lr_warmup_steps)]
                if (self.lr_schedule != "constant"
                    or self.lr_warmup_steps) else [])
        if not pre and not post:
            # the bare optimizer: its state (and every snapshot of it) is
            # unchanged by the chain existing
            return base
        return opt.chain(*pre, base, *post)

    def _validate_second_order(self, eplan) -> None:
        """The second-order coordinate optimizers pair gradients ACROSS
        steps, so the basis must be fixed between steps: materialized
        (trajectory_pca / gradient_informed) or FPD (redraw=False).
        Per-step random redraw makes coordinate gradients incomparable,
        and the per-leaf / joint (K, d) states have no single (d,) buffer
        for the curvature history."""
        if self.optimizer not in opt.SECOND_ORDER_OPTIMIZERS:
            return
        t = self.transform
        if eplan.strategy not in ("materialized_packed", "fused_packed") \
                or self.joint_subspace:
            raise ValueError(
                f"{self.optimizer} needs the single (d,)-shaped packed "
                "coordinate buffer for its curvature history; this "
                f"config plans {eplan.strategy!r} "
                f"(joint_subspace={self.joint_subspace}) -- "
                + eplan.reason)
        fixed = eplan.materialized or (t is not None and not t.redraw
                                       and not t.steps_fpd)
        if not fixed:
            raise ValueError(
                f"{self.optimizer} pairs coordinate gradients across "
                "steps, which requires a basis FIXED between steps: a "
                "materialized BasisSpec (basis=trajectory_pca / "
                "gradient_informed) or FPD (redraw=False, steps_fpd=0). "
                "A per-step random redraw makes coordinate gradients "
                "incomparable across steps.")

    # -- state --------------------------------------------------------------

    def init_rbd_state(self, params=None, *, device=None):
        """The basis state; on the materialized plan it carries the
        initial basis, drawn from the base seed on ``device`` (default:
        the parameters' device, else the optimizer's)."""
        if self.transform is None:
            return ()
        state = self.transform.init(params)
        if self.plan_execution().materialized:
            t = self.transform
            if device is None:
                device = (self.device if params is None
                          else _device_of(params))
            state = state._replace(basis=projector.materialize_random_basis(
                t.plan, t.plan.packed(), t.base_seed, device=device))
        return state

    def init_opt_state(self, params=None, *, device=None):
        """Optimizer state (SGD is stateless): on the (d_packed,) or
        gathered (K, d_packed) coordinate buffer on the packed path, on
        the (total_dim,) buffer on the materialized path, on the per-leaf
        (n_stack, dim) coordinate list on the per-leaf coordinate-space
        strategies, and shaped like ``params`` (the parameter map,
        required) on ``full_space``.  ``device`` defaults to the
        parameters' device, else the optimizer's (``params=None``: the
        collector's re-zeroing after a refresh)."""
        eplan = self.check_supported()
        self._validate_second_order(eplan)
        if not eplan.coord_space:
            if not isinstance(params, dict):
                raise ValueError("the full_space optimizer state is shaped "
                                 "like the parameter map: pass params")
            return self._optimizer().init(params)
        if device is None:
            device = self.device if params is None else _device_of(params)
        return self._optimizer().init(self._coord_template(device, eplan))

    def _coord_template(self, device, eplan):
        """Zeros shaped like the post-exchange coordinates: the packed
        (d_packed,) buffer -- (K, d_packed) for the K*d-dimensional joint
        subspace -- the materialized path's (total_dim,) buffer (exactly
        total_dim live rows, no dir-block padding), or one (n_stack, dim)
        block per LeafPlan."""
        plan = self.transform.plan
        if eplan.materialized:
            return torch.zeros((plan.total_dim,), dtype=torch.float32,
                               device=device)
        if eplan.strategy != "fused_packed":
            return [torch.zeros((lp.n_stack, lp.dim), dtype=torch.float32,
                                device=device) for lp in plan.leaves]
        d = plan.packed().d_packed
        shape = (self.k_workers, d) if self.joint_subspace else (d,)
        return torch.zeros(shape, dtype=torch.float32, device=device)

    # -- stored-representation boundary -------------------------------------

    def sharded_layout(self):
        """The slab layout, or None when ``model_axis`` is unset."""
        if self.model_axis is None:
            return None
        return compartments.sharded_packed_layout(
            self.transform.plan.packed(), self.model_shards)

    def model_index(self) -> int:
        """This rank's slab: its index in the model group."""
        return distributed.axis_index(self.model_axis)

    def padded_params(self, params) -> torch.Tensor:
        """Parameter map -> the (q_padded,) packed buffer of every slab
        (zero padding past q_packed); the (q_packed,) buffer when
        unsharded."""
        plan = self.transform.plan
        packed = projector.pack_tree(params, plan, plan.packed())
        slayout = self.sharded_layout()
        if slayout is None or slayout.q_padded == packed.shape[0]:
            return packed
        return torch.cat([packed, packed.new_zeros(
            (slayout.q_padded - packed.shape[0],))])

    def slab_of(self, buf: torch.Tensor, shard: Optional[int] = None
                ) -> torch.Tensor:
        """Slab ``shard`` (default: this rank's) of a (q_padded,) buffer."""
        slayout = self.sharded_layout()
        a, b = slayout.slab_range(self.model_index() if shard is None
                                  else shard)
        return buf[a:b]

    def prepare_params(self, params):
        """Parameter map -> the stored representation: the packed
        (q_packed,) float32 buffer on the packed-resident strategy --
        this rank's (q_slab,) slab of the zero-padded buffer under a
        declared ``model_axis`` -- the map itself otherwise."""
        if not self.check_supported().packed_resident:
            return params
        if self.model_axis is None:
            return self.padded_params(params)
        return self.slab_of(self.padded_params(params)).clone()

    def gather_params(self, stored) -> torch.Tensor:
        """A rank's (q_slab,) slab -> the (q_padded,) buffer, all-gathered
        over the model group (the forward's one D-sized collective,
        counted as ``model_all_gather``); anything else as it is."""
        slayout = self.sharded_layout()
        if (slayout is None or stored.shape[-1] != slayout.q_slab
                or slayout.q_slab == slayout.q_padded):
            return stored
        full = stored.new_empty((slayout.q_padded,))
        distributed.all_gather_slabs(full, stored, self.model_axis)
        return full

    def materialize_params(self, stored) -> dict:
        """Stored representation -> parameter map: views of the packed
        buffer that autograd follows (a slab is first all-gathered, then
        the padding tail is cut), or the map itself."""
        if not self.plan_execution().packed_resident:
            return stored
        if self.params_template is None:
            raise ValueError(
                "packed-resident SubspaceOptimizer needs params_template "
                "(a map of shapes/dtypes) to materialize parameters")
        plan = self.transform.plan
        layout = plan.packed()
        return projector.unpack_tree(
            self.gather_params(stored)[: layout.q_packed], plan, layout,
            self.params_template)

    # -- the update ---------------------------------------------------------

    def step(self, params, grads, rbd_state, opt_state, guard_state=()):
        """One optimizer step on the stored representation (the packed
        buffer, or the parameter map of the unpacked strategies).  Returns
        ``(new_params, new_rbd_state, new_opt_state, aux)``.  In the
        K-worker simulation ``grads`` is the stacked (K, q_packed) buffer
        of the workers' gradients.  ``guard_state`` threads the non-finite
        step guard's GuardState when ``guard`` is set (the new state comes
        back on ``aux.guard``)."""
        self._check_resilience(self.plan_execution())
        eplan = self.check_supported()
        self._validate_second_order(eplan)
        if eplan.strategy == "full_space":
            return self._full_space_step(params, grads, rbd_state,
                                         opt_state)
        if eplan.materialized:
            return self._materialized_step(params, grads, rbd_state,
                                           opt_state)
        if eplan.strategy != "fused_packed":
            return self._per_leaf_step(
                params, grads, rbd_state, opt_state,
                fused=eplan.strategy == "fused_per_leaf")
        ticket = self.step_sketch(params, grads, rbd_state, opt_state)
        return self.step_finish(params, ticket, rbd_state, opt_state,
                                guard_state)

    def _check_split(self, what="step_sketch/step_finish split the packed "
                     "two-launch step") -> ExecutionPlan:
        eplan = self.check_supported()
        if eplan.strategy != "fused_packed":
            raise ValueError(
                f"{what}; this config plans {eplan.strategy!r} -- "
                + eplan.reason)
        return eplan

    def step_sketch(self, params, grads, rbd_state, opt_state
                    ) -> StepTicket:
        """First half of the split step: project the gradient (launch 1;
        one launch per worker in the K-worker simulation) and -- under
        the ``issue_early`` schedule -- issue the one coordinate
        collective at once, the sentinel's checksum riding it.
        ``step() == step_finish(step_sketch())``."""
        eplan = self._check_split()
        if self.model_axis is not None:
            return self._sharded_sketch(params, grads, rbd_state, opt_state)
        t = self.transform
        plan = t.plan
        layout = plan.packed()
        prng = eplan.prng_impl
        exact = plan.normalization == "exact"
        seed = t.step_seed(rbd_state.step)
        rider = (resilience.sentinel_rider(opt_state, params)
                 if self.sentinel_every else None)
        if self.joint_subspace:
            if self.axis_name is None:
                # sequential K-worker simulation: the "gather" is local
                if grads.shape[0] != self.k_workers:
                    raise ValueError(
                        f"the K-worker simulation takes stacked "
                        f"({self.k_workers}, q_packed) gradients, got "
                        f"{tuple(grads.shape)}")
                wseeds = projector.worker_base_seeds(seed, self.k_workers)
                outs = [projector.project_packed(
                    grads[k], plan, wseeds[k], backend=t.backend,
                    layout=layout, prepacked=True, prng=prng,
                    return_norms=True) for k in range(self.k_workers)]
                coords = torch.stack([c for c, _ in outs])
                sq = torch.stack([q for _, q in outs]) if exact else None
                return StepTicket(pending=distributed.PendingExchange(
                    "local", coords, sq, layout.d_packed, exact,
                    has_rider=rider is not None, rider_local=rider),
                    rider=rider)
            if eplan.overlap_exchange == "issue_early":
                return StepTicket(
                    pending=distributed.independent_bases_start_exchange(
                        t, grads, rbd_state, self.axis_name, layout=layout,
                        prng=prng, return_norms=exact, rider=rider),
                    rider=rider)
            proj = projector.project_packed(
                grads, plan,
                distributed.worker_seed(t, rbd_state, self.axis_name),
                backend=t.backend, layout=layout, prepacked=True,
                prng=prng, return_norms=exact)
            coords, sq = proj if exact else (proj, None)
            return StepTicket(coords=coords, sq=sq, rider=rider)
        coords, sq = projector.project_packed(
            grads, plan, seed, backend=t.backend, layout=layout,
            return_norms=True, prepacked=True, prng=prng)
        local_ok = (resilience.all_finite(coords, sq)
                    if self.guard is not None else ())
        if self.axis_name is not None and eplan.overlap_exchange == "sync":
            return StepTicket(coords=coords, sq=sq, rider=rider,
                              local_ok=local_ok)
        return StepTicket(pending=distributed.start_exchange(
            coords, sq, self.axis_name, kind="pmean", widened=exact,
            rider=rider), rider=rider, local_ok=local_ok)

    def step_finish(self, params, ticket: StepTicket, rbd_state, opt_state,
                    guard_state=()):
        """Second half: wait for the collective (on the ``sync`` schedule
        issue it first -- same payload, same collective), then the
        post-exchange chain: fault injection on the received payload, the
        guard's reason code from the (d,)-sized buffers, the sentinel's
        verdict from the rider, and :meth:`apply_exchanged` (the
        coordinate-space optimizer and launch 2, on this rank's slab under
        a declared ``model_axis``, or on each slab of a list).  Still two
        launches and one collective with every resilience hook on.
        Functional: returns a new parameter buffer unless
        ``log_update_norm`` is off, in which case ``params`` is updated in
        place (the update norm needs the old buffer)."""
        eplan = self._check_split()
        guard_on = self.guard is not None
        joint = self.joint_subspace
        coords, sq, rider_out = self._finish_exchange(ticket)
        sim = joint and self.axis_name is None
        widx = (distributed.axis_index(self.axis_name)
                if self.axis_name is not None else 0)
        local_ok = ticket.local_ok
        if joint:
            if sim and ticket.rider is not None:
                # sequential simulation: K copies of the one local checksum
                rider_out = ticket.rider.expand(self.k_workers)
            if guard_on:
                # the own row only LABELS the reason (LOCAL vs EXCHANGE);
                # the decision reads the whole gathered buffer, which every
                # rank sees alike, so the guarded update stays replicated
                local_ok = (resilience.all_finite(coords, sq) if sim else
                            resilience.all_finite(
                                coords[widx],
                                None if sq is None else sq[widx]))
        if self.fault_plan is not None:
            coords = resilience.inject_collective_faults(
                self.fault_plan, rbd_state.step, coords, widx)
        reason = None
        if guard_on:
            dev = coords.device
            ok_code = torch.full((), resilience.REASON_OK, dtype=torch.int32,
                                 device=dev)
            reason = torch.where(
                local_ok,
                torch.where(resilience.all_finite(coords, sq), ok_code,
                            torch.full_like(
                                ok_code,
                                resilience.REASON_NONFINITE_EXCHANGE)),
                torch.full_like(ok_code, resilience.REASON_NONFINITE_LOCAL))
        diverged = ()
        if rider_out is not None:
            diverged = resilience.sentinel_check(
                ticket.rider, rider_out, rbd_state.step,
                self.sentinel_every)
        new_params, new_rbd, new_opt, new_guard, in_place = \
            self._apply_exchanged(params, coords, sq, rbd_state, opt_state,
                                  guard_state, reason, eplan)
        aux = self._delta_aux(params, new_params, in_place)
        if self.resilience_active:
            aux = aux._replace(
                coords=coords if self.capture_coords else (),
                row_sq=(sq if self.capture_coords and sq is not None
                        else ()),
                guard=new_guard if guard_on else (),
                reason=reason if guard_on else (),
                diverged=diverged)
        return new_params, new_rbd, new_opt, aux

    def apply_exchanged(self, params, coords, sq, rbd_state, opt_state,
                        guard_state=(), reason=None):
        """The POST-EXCHANGE half of the packed step: [guard transition +
        sanitize] -> coordinate-space optimizer -> reconstruct-apply
        (launch 2).  The live step and the coordinate replay
        (``core.resilience.replay_records``) both run this code, which is
        what makes restore + replay bit-exact by construction.

        ``params``: the packed buffer, this rank's slab under a declared
        ``model_axis``, or the list of a model group's slabs (the shards
        in turn: the optimizer runs once, then one apply a slab).
        ``coords``/``sq``: the post-exchange buffers ((d_packed,) or the
        gathered (K, d_packed); ``sq`` may be None on the joint path under
        static-factor normalizations).  ``reason``: this step's REASON_*
        code (a 0-d int32 tensor); with a guard set, a non-OK reason zeroes
        the applied update and freezes the optimizer state bit-exactly
        while the basis schedule still advances.  Returns ``(new_params,
        new_rbd_state, new_opt_state, new_guard_state)``."""
        eplan = self._check_split(
            "apply_exchanged is the packed two-launch step's post-exchange "
            "half")
        return self._apply_exchanged(params, coords, sq, rbd_state,
                                     opt_state, guard_state, reason,
                                     eplan)[:4]

    def _apply_exchanged(self, params, coords, sq, rbd_state, opt_state,
                         guard_state, reason, eplan):
        # the switch-policy reset comes BEFORE the guard reads opt_state,
        # so a rejected switch step freezes the RESET state
        opt_state = self._switch_opt_state(opt_state, rbd_state.step)
        gain = ok = None
        new_guard = guard_state
        if self.guard is not None:
            if reason is None:
                reason = torch.zeros((), dtype=torch.int32,
                                     device=coords.device)
            ok = reason == resilience.REASON_OK
            new_guard = resilience.guard_transition(self.guard, guard_state,
                                                    reason)
            # sanitize BEFORE the optimizer, so NaN/Inf never reach the
            # state buffers; sq -> 1 keeps the 'exact' rsqrt finite
            coords = torch.where(ok, coords, torch.zeros_like(coords))
            if sq is not None:
                sq = torch.where(ok, sq, torch.ones_like(sq))
            # a rejected step applies a gain of exactly 0 (theta - 0 is
            # bit-exact); an accepted one the effective-LR scale (1.0 in a
            # healthy run: bit-identical to the unguarded step)
            gain = torch.where(ok, new_guard.lr_scale,
                               torch.zeros_like(new_guard.lr_scale))
        coords_u, new_opt = self._optimizer().update(coords, opt_state)
        if gain is not None:
            coords_u = coords_u * gain
            # freeze the optimizer state on a rejected step (momentum /
            # adam must not absorb the sanitized zeros' decay)
            new_opt = opt._map(lambda n, o: torch.where(ok, n, o), new_opt,
                               opt_state)
        if isinstance(params, (list, tuple)):
            # the shards in turn: one apply a slab, in shard order
            outs = [self._apply(slab, coords_u, sq, rbd_state, eplan, shard)
                    for shard, slab in enumerate(params)]
            new_params = [out for out, _ in outs]
            in_place = outs[0][1]
        else:
            shard = (self.model_index() if self.model_axis is not None
                     else None)
            new_params, in_place = self._apply(params, coords_u, sq,
                                               rbd_state, eplan, shard)
        return (new_params, RBDState(step=rbd_state.step + 1), new_opt,
                new_guard, in_place)

    def _finish_exchange(self, ticket: StepTicket):
        """``(coords, sq, rider)`` after the one exchange (the rider None
        when none rode it)."""
        exact = self.transform.plan.normalization == "exact"
        joint = self.joint_subspace
        pending = ticket.pending
        if pending is None:
            pending = distributed.start_exchange(
                ticket.coords, ticket.sq, self.axis_name,
                kind="all_gather" if joint else "pmean", widened=exact,
                rider=ticket.rider)
        coords, sq, *rider = distributed.finish_exchange(pending)
        if joint and coords.shape[0] != self.k_workers:
            raise ValueError(
                f"k_workers={self.k_workers} does not match the "
                f"'{self.axis_name}' group size {coords.shape[0]}")
        return coords, sq, (rider[0] if rider else None)

    # -- model-sharded slabs --------------------------------------------------

    def slab_partials(self, grads, rbd_state, shard: int):
        """Launch 1 on one slab: the raw partial ``(u, sq)`` of slab
        ``shard``'s (q_slab,) gradient -- on this worker's own basis in
        the joint subspace."""
        eplan = self._check_split()
        t = self.transform
        seed = (distributed.worker_seed(t, rbd_state, self.axis_name)
                if self.joint_subspace else t.step_seed(rbd_state.step))
        return projector.project_packed_sharded(
            grads, t.plan, seed, shard, slayout=self.sharded_layout(),
            backend=t.backend, prng=eplan.prng_impl)

    def sketch_from_sums(self, u, psq, csq, words=None, opt_state=None
                         ) -> StepTicket:
        """The completed sums -> normalized coordinates -> the unchanged
        data-axis exchange (issued at once under ``issue_early``).
        ``csq``: the completed norms ('exact'), else None; ``psq``: the
        slab's own partial norms, passed through (unused by the update).
        ``words``: the sentinel's completed words
        (``resilience.sentinel_words`` summed over the group), from which
        every rank folds the same rider; ``opt_state`` says how they fold.
        With the guard on, the ticket's ``local_ok`` reads the completed
        coordinates, the same on every rank of the model group."""
        eplan = self._check_split()
        plan = self.transform.plan
        exact = plan.normalization == "exact"
        coords = u * projector.packed_norm_factor(
            plan, plan.packed(), csq, device=u.device)
        rider = (None if words is None else resilience.sentinel_rider_of_words(
            words, self.model_shards, opt_state))
        if self.joint_subspace:
            if eplan.overlap_exchange == "issue_early":
                return StepTicket(pending=distributed.start_exchange(
                    coords, csq, self.axis_name, kind="all_gather",
                    widened=exact, rider=rider), rider=rider)
            return StepTicket(coords=coords, sq=csq, rider=rider)
        sq = csq if exact else psq
        local_ok = (resilience.all_finite(coords, sq)
                    if self.guard is not None else ())
        if self.axis_name is not None and eplan.overlap_exchange == "sync":
            return StepTicket(coords=coords, sq=sq, rider=rider,
                              local_ok=local_ok)
        return StepTicket(pending=distributed.start_exchange(
            coords, sq, self.axis_name, kind="pmean", widened=exact,
            rider=rider), rider=rider, local_ok=local_ok)

    def _sharded_sketch(self, params, grads, rbd_state, opt_state
                        ) -> StepTicket:
        """Sketch half on this rank's slab: the slab's partial sums, ONE
        all-reduce over the model group (widened to u+sq under 'exact',
        and by the sentinel's two words when it is on), then
        :meth:`sketch_from_sums`.  One coordinate-sized collective per
        group and step, nothing D-sized."""
        exact = self.transform.plan.normalization == "exact"
        u, psq = self.slab_partials(grads, rbd_state, self.model_index())
        words = (resilience.sentinel_words(opt_state, params)
                 if self.sentinel_every else None)
        u, csq, *words = distributed.complete_model_partials(
            u, psq if exact else None, self.model_axis, words=words)
        return self.sketch_from_sums(u, psq, csq, words[0] if words else None,
                                     opt_state)

    def step_shards_in_turn(self, slabs, grads, rbd_state, opt_state,
                            guard_state=()):
        """One optimizer step of a whole model group run in one process,
        the shards one after the other (one device standing in for m
        ranks): the fault plan's gradient faults on each slab's gradient
        (every slab of the targeted data worker, as on the ranks), the m
        slab projections, the completion -- the partials and the
        sentinel's words summed in shard order -- then the finish chain
        of :meth:`step_finish`: the data-axis exchange, collective-fault
        injection, the reason code, the sentinel check, the guard and the
        coordinate optimizer once (the ranks' replicated copies would
        agree), then the m slab applies.  ``slabs``/``grads``: the m
        (q_slab,) slabs and their gradients.  Returns ``(new slabs,
        new_rbd_state, new_opt_state, aux)``, ``aux`` the fields
        :meth:`step` fills; ``aux.update_norm`` over all slabs."""
        self._check_split()
        exact = self.transform.plan.normalization == "exact"
        if len(slabs) != self.model_shards or len(grads) != len(slabs):
            raise ValueError(f"expected {self.model_shards} slabs and "
                             f"gradients, got {len(slabs)} and {len(grads)}")
        widx = (distributed.axis_index(self.axis_name)
                if self.axis_name is not None else None)
        u = psq = words = None
        for shard, (slab, g) in enumerate(zip(slabs, grads)):
            g = resilience.inject_grad_faults(
                self.fault_plan, rbd_state.step, g, worker_index=widx)
            pu, ps = self.slab_partials(g, rbd_state, shard)
            u = pu if u is None else u + pu
            psq = ps if psq is None else psq + ps
            if self.sentinel_every:
                w = resilience.sentinel_words(opt_state, slab)
                words = w if words is None else words + w
        ticket = self.sketch_from_sums(u, psq, psq if exact else None, words,
                                       opt_state)
        return self.step_finish(list(slabs), ticket, rbd_state, opt_state,
                                guard_state)

    # -- microbatch accumulation --------------------------------------------

    def accumulate_grads(self, acc, grads):
        """Fold one microbatch gradient into the running sum, in the
        stored representation: one (q_packed,) add on the packed path.
        ``acc=None`` starts the sum."""
        if acc is None:
            return grads
        return opt._map(torch.add, acc, grads)

    def finalize_accum(self, acc, n_micro: int):
        """Mean gradient of ``n_micro`` accumulated microbatches.  The
        projection is linear, so ONE exchange on this mean stands for the
        mean of the per-microbatch exchanges: one collective per
        optimizer step, not one per microbatch."""
        if n_micro == 1:
            return acc
        inv = 1.0 / float(n_micro)
        return opt._map(lambda g: g * inv, acc)

    def _apply(self, params, coords_u, sq, rbd_state, eplan, shard):
        """Launch 2: the reconstruct-apply of the updated coordinates on
        the packed buffer, or on slab ``shard`` (not None) -- the joint
        route applies all K bases with ``eta = lr / K``.  Returns
        ``(new params, whether params was updated in place)``."""
        t = self.transform
        plan = t.plan
        seed = t.step_seed(rbd_state.step)
        in_place = not (self.log_update_norm and self.learning_rate)
        out = params if in_place else None
        eta = self.learning_rate
        kw = dict(backend=t.backend, row_sq=sq, prng=eplan.prng_impl, out=out)
        if self.joint_subspace:
            eta = self.learning_rate / self.k_workers
        if shard is not None:
            fn = (projector.reconstruct_apply_packed_workers_sharded
                  if self.joint_subspace
                  else projector.reconstruct_apply_packed_sharded)
            return fn(coords_u, plan, seed, params, eta, shard,
                      slayout=self.sharded_layout(), **kw), in_place
        fn = (projector.reconstruct_apply_packed_workers
              if self.joint_subspace else projector.reconstruct_apply_packed)
        return fn(coords_u, plan, seed, params, eta, layout=plan.packed(),
                  prepacked=True, **kw), in_place

    def _materialized_step(self, params, grads, rbd_state, opt_state):
        """One step on the MATERIALIZED basis: coordinates = basis @
        g_packed, one (d,) all-reduce mean over the data group, the
        coordinate optimizer, theta - lr * (c @ basis).  No kernel launch
        and one collective; the collector refreshes the basis outside the
        step."""
        basis = rbd_state.basis
        coords = projector.project_materialized(basis, grads)
        if self.axis_name is not None:
            coords, _ = distributed.shared_basis_packed_exchange(
                coords, None, self.axis_name)
        coords_u, new_opt = self._optimizer().update(coords, opt_state)
        new_params = projector.reconstruct_apply_materialized(
            coords_u, basis, params, self.learning_rate)
        return (new_params, RBDState(step=rbd_state.step + 1, basis=basis),
                new_opt, self._delta_aux(params, new_params, False))

    def _per_leaf_step(self, params, grads, rbd_state, opt_state, *,
                       fused: bool):
        """``fused_per_leaf`` / ``coord_unfused``: project every leaf (one
        launch each), one coordinate all-reduce over the group, the
        coordinate optimizer on the per-leaf list, then the fused per-leaf
        apply or reconstruct-then-apply."""
        t = self.transform
        shards = self.leaf_shards
        seed = t.step_seed(rbd_state.step)
        if self.axis_name is not None:
            coords, norms = distributed.shared_basis_coords(
                t, grads, rbd_state, self.axis_name, shards=shards)
        else:
            coords, norms = projector.project(
                grads, t.plan, seed, backend=t.backend, return_norms=True,
                shards=shards)
        opt_state = self._switch_opt_state(opt_state, rbd_state.step)
        coords, opt_state = self._optimizer().update(coords, opt_state)
        new_rbd = RBDState(step=rbd_state.step + 1)
        if fused:
            new_params = projector.reconstruct_apply(
                coords, t.plan, seed, params, self.learning_rate,
                backend=t.backend, row_sq=norms, shards=shards)
            return (new_params, new_rbd, opt_state,
                    self._delta_aux(params, new_params, False))
        updates = projector.reconstruct(coords, t.plan, seed, params,
                                        backend=t.backend, row_sq=norms,
                                        shards=shards)
        new_params = opt.apply_updates(params, updates, self.learning_rate)
        return new_params, new_rbd, opt_state, self._norm_aux(updates)

    def _full_space_step(self, params, grads, rbd_state, opt_state):
        """``full_space``: the update is the raw gradient (RBD off; its
        full-D mean over the group, the SGD baseline's one collective) or
        the RBD sketch of it (the shared or per-leaf independent bases
        exchange over the group); then ``+ wd * p`` and the full-space
        optimizer on the parameter map."""
        t = self.transform
        if t is None:
            if self.axis_name is not None:
                grads = distributed.grad_mean(grads, self.axis_name)
            updates, new_rbd = grads, rbd_state
        elif self.axis_name is None:
            seed = t.step_seed(rbd_state.step)
            updates = projector.rbd_gradient(grads, t.plan, seed,
                                             backend=t.backend,
                                             shards=self.leaf_shards)
            new_rbd = RBDState(step=rbd_state.step + 1)
        else:
            fn = (distributed.shared_basis_update
                  if self.mode == "shared_basis"
                  else distributed.independent_bases_update)
            updates, new_rbd = fn(t, grads, rbd_state, self.axis_name,
                                  shards=self.leaf_shards)
        if self.weight_decay:
            updates = {k: u + self.weight_decay * params[k]
                       for k, u in updates.items()}
        updates, opt_state = self._optimizer().update(updates, opt_state)
        new_params = opt.apply_updates(params, updates, self.learning_rate)
        return new_params, new_rbd, opt_state, self._norm_aux(updates)

    def _norm_aux(self, updates) -> _Aux:
        if not self.log_update_norm:
            return _Aux(torch.zeros(()))
        return _Aux(self._global_norm(updates))

    def _global_norm(self, tree) -> torch.Tensor:
        """``opt.global_norm`` of a parameter-shaped map; on leaf shards
        the sharded leaves' squares are summed over the model group (one
        scalar all-reduce) and a replicated leaf counts once."""
        shards = self.leaf_shards
        if shards is None or shards.m == 1:
            return opt.global_norm(tree)
        part = [torch.sum(torch.square(x.to(torch.float32)))
                for k, x in tree.items() if shards.sharded(k)]
        whole = [torch.sum(torch.square(x.to(torch.float32)))
                 for k, x in tree.items() if not shards.sharded(k)]
        sq = sum(whole) if whole else torch.zeros(())
        if part:
            local = sum(part)
            sq = sq + (local if shards.group is None
                       else distributed.model_sum_scalar(local,
                                                         shards.group))
        return torch.sqrt(sq)

    def _switch_opt_state(self, opt_state, step: int):
        """FPD -> RBD state policy: ``reset`` re-zeroes the coordinate
        optimizer state at the switch step, ``carry`` keeps it."""
        t = self.transform
        if (t is None or not t.steps_fpd or self.switch_policy != "reset"
                or int(step) != t.steps_fpd):
            return opt_state
        return _zeros_like_state(opt_state)

    def _delta_aux(self, old, new, in_place: bool) -> _Aux:
        """The fused steps never materialize the update; its norm comes
        from the parameter delta (one read of both buffers or maps)."""
        if in_place or not (self.log_update_norm and self.learning_rate):
            return _Aux(torch.zeros((), device=opt.leaves(new)[0].device))
        n = self._global_norm(opt._map(
            lambda a, b: a.to(torch.float32) - b.to(torch.float32), old,
            new))
        return _Aux(n / self.learning_rate)


def _zeros_like_state(state):
    if isinstance(state, torch.Tensor):
        return torch.zeros_like(state)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_zeros_like_state(s) for s in state))
    if isinstance(state, (list, tuple)):
        return type(state)(_zeros_like_state(s) for s in state)
    return state


def _device_of(params):
    if isinstance(params, torch.Tensor):
        return params.device
    if isinstance(params, dict) and params:
        return next(iter(params.values())).device
    raise ValueError("init_opt_state needs params or device")
