"""The single-process training loop and the materialized-basis
collector (port of ``repro.train.loop``).

:func:`train` is the simple loop of the examples and the paper-repro
experiments: data feed with a one-deep prefetch, metrics every
``log_every`` steps, evaluation, checkpoints and the resilience hooks;
the multi-rank path is ``repro_torch.launch.train``.

The ``trajectory_pca`` / ``gradient_informed`` BasisSpecs store their
basis as data on ``RBDState`` (``optim.subspace`` strategy
``materialized_packed``); its REFRESH is host work and lives here: a ring
of packed observations -- theta deltas for trajectory_pca (Li et al.'s
PCA over training-trajectory snapshots) or the per-step packed gradients
for gradient_informed -- is reduced every R steps by
``projector.refresh_materialized_basis`` (numpy SVD + QR against the old
basis) and the new basis is copied into the resident one: same shape,
dtype and device.  The coordinate optimizer state is re-zeroed at each
refresh, since its history pairs coordinates with the RETIRED basis rows
(the argument of the FPD -> RBD ``switch_policy="reset"``).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import projector
from repro_torch.models.registry import resolve_device
from repro_torch.train.step import make_train_step, stack_microbatches


class BasisCollector:
    """Snapshot ring + periodic refresh for a materialized basis.

    ``observe`` is called once per optimizer step with the post-step
    state; it pulls one packed (q_packed,) observation to the host and,
    every ``refresh_every`` steps, rebuilds the basis from the ring,
    writes it into ``state.rbd_state.basis`` in place and returns the
    state with re-zeroed coordinate optimizer state.  Use :meth:`build`,
    which returns None unless the execution plan is materialized."""

    def __init__(self, sub_opt, spec: str, refresh_every: int,
                 capacity: int):
        self.sub_opt = sub_opt
        self.spec = spec                  # trajectory_pca | gradient_informed
        self.refresh_every = refresh_every
        self.capacity = capacity
        self.ring = []                    # newest-last packed observations
        self.refreshes = 0                # completed refresh count
        self._prev_theta = None           # trajectory_pca delta anchor

    @classmethod
    def build(cls, sub_opt, tcfg):
        eplan = sub_opt.plan_execution()
        if not eplan.materialized:
            return None
        d = int(sub_opt.transform.plan.total_dim)
        # ring depth: enough snapshots to replace a meaningful fraction of
        # the d basis rows per refresh (the old basis fills the rest)
        capacity = max(4, min(d, 64))
        refresh_every = int(tcfg.rbd.basis_refresh_every) or capacity
        return cls(sub_opt, eplan.basis, refresh_every, capacity)

    def _observation(self, state, metrics):
        if self.spec == "gradient_informed":
            return _host(metrics["basis_grad"])
        theta = _host(state.params)
        if self._prev_theta is None:
            self._prev_theta = theta
            return None
        delta = theta - self._prev_theta
        self._prev_theta = theta
        return delta

    def observe(self, state, metrics, step: int):
        obs = self._observation(state, metrics)
        if obs is not None and np.all(np.isfinite(obs)):
            self.ring.append(obs)
            if len(self.ring) > self.capacity:
                self.ring.pop(0)
        if (step + 1) % self.refresh_every or not self.ring:
            return state
        basis = state.rbd_state.basis
        new = projector.refresh_materialized_basis(_host(basis),
                                                   np.stack(self.ring))
        basis.copy_(torch.from_numpy(new))
        self.ring.clear()
        self.refreshes += 1
        # coordinate history in the retired basis is meaningless
        return state._replace(opt_state=self.sub_opt.init_opt_state(
            None, device=basis.device))


def _host(x: torch.Tensor) -> np.ndarray:
    """A float32 host copy of a tensor (a copy also on the CPU, so that a
    later in-place update cannot reach it)."""
    return x.detach().to("cpu", torch.float32, copy=True).numpy()


def train(model, tcfg, data: Iterator, *, eval_fn: Optional[Callable] = None,
          eval_every: int = 0, log_every: int = 10,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
          verbose: bool = True, resilience=None, resume: bool = False,
          device="cuda"):
    """Simple single-process loop (examples, paper-repro experiments) on
    ``device`` (the card unless the caller asks for the CPU).  ``data``
    yields batches on that device; with ``tcfg.grad_accum_steps`` N > 1
    each optimizer step takes N consecutive batches, stacked.

    ``resilience``: an optional :class:`repro_torch.core.resilience.
    ResilienceConfig`.  With a directory the loop appends every step's
    coordinates to the replay log, writes sparse packed snapshots and --
    with ``resume=True`` -- recovers from the newest intact snapshot plus
    the log before training, skipping the batches already consumed.  With
    resilience on it returns ``(state, history, monitor)`` (the
    reason-coded recovery events are on the monitor), else ``(state,
    history)``.  ``history`` holds the scalar metrics of every
    ``log_every``-th step and the last (``verbose`` only), and each
    evaluation under ``"eval"`` on its step's record.  Checkpoints store
    the parameter map nested at ``/`` (the reference's tree and keys),
    whatever the stored representation."""
    device = resolve_device(device)
    init_state, train_step, sub_opt = make_train_step(
        model, tcfg, device=device, return_optimizer=True,
        resilience=resilience)
    state = init_state(tcfg.seed)
    n_accum = max(1, int(tcfg.grad_accum_steps))
    # materialized BasisSpecs only; None on the random path
    collector = BasisCollector.build(sub_opt, tcfg)

    def fetch():
        # one OPTIMIZER step's data: N consecutive batches stacked on a
        # leading microbatch axis (N = 1 passes the batch through)
        if n_accum == 1:
            return next(data)
        return stack_microbatches([next(data) for _ in range(n_accum)])

    monitor = None
    start = 0
    if resilience is not None and resilience.any_enabled:
        from repro_torch.core import resilience as res_lib

        recovery_events = []
        if resume and resilience.directory:
            recovered, info = res_lib.recover(resilience, sub_opt, state)
            recovery_events = info["events"]
            if recovered is not None:
                state = recovered
                start = int(state.step)
                if verbose:
                    print(f"recovered to step {start} "
                          f"(snapshot {info['snapshot_step']}, "
                          f"replayed {info['replayed']} records)")
                # keep the stream step-aligned: each optimizer step
                # consumed n_accum batches (O(1) on a counter stream)
                res_lib.skip_batches(data, start * n_accum)
        monitor = res_lib.ResilienceMonitor(resilience, sub_opt)
        monitor.events.extend(recovery_events)
    # the replay log appends every step and the sentinel fails promptly,
    # so both observe every step; a guard-only (or fault-injection-only)
    # monitor reads scalar metrics alone, so its observes wait for the log
    # boundary: no device-to-host synchronization a step
    per_step_observe = monitor is not None and bool(
        resilience.directory or resilience.sentinel_every)
    pending = []        # deferred (step, metrics) observations

    def report(events):
        if verbose:
            for ev in events:
                print(f"  [resilience] step {ev.step}: "
                      f"{res_lib.reason_name(ev.reason)} -- {ev.detail}")

    def drain_pending():
        for s, m in pending:
            report(monitor.observe(None, m, step=s))
        pending.clear()

    history = []
    t0 = time.time()
    try:
        if start < tcfg.steps:
            batch = fetch()     # prime the one-deep prefetch
        for step in range(start, tcfg.steps):
            if monitor is not None and monitor.should_kill(step):
                drain_pending()
                raise res_lib.SimulatedWorkerKill(
                    f"fault plan kills step {step}")
            state, metrics = train_step(state, batch)
            if collector is not None:
                state = collector.observe(state, metrics, step)
            if step + 1 < tcfg.steps:
                # one-deep prefetch: the step above runs asynchronously on
                # the card while the host builds the next batch; the
                # batches consumed are unchanged (resume stays aligned)
                batch = fetch()
            boundary = step % log_every == 0 or step == tcfg.steps - 1
            if monitor is not None:
                if per_step_observe:
                    report(monitor.observe(state, metrics))
                else:
                    pending.append((step, metrics))
                    if boundary:
                        drain_pending()
            if verbose and boundary:
                m = {k: float(v) for k, v in metrics.items()
                     if getattr(v, "ndim", 0) == 0}
                m.update(step=step, wall=time.time() - t0)
                history.append(m)
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"wall {m['wall']:.1f}s")
            if eval_fn and eval_every and step % eval_every == eval_every - 1:
                # a packed-resident state stores one packed buffer: the
                # evaluation takes the parameter map
                acc = float(eval_fn(sub_opt.materialize_params(
                    state.params)))
                # attach to this step's record, or open one (eval steps
                # need not be log steps, and verbose may be off)
                if not history or history[-1].get("step") != step:
                    history.append({"step": step})
                history[-1]["eval"] = acc
                if verbose:
                    print(f"  eval: {acc:.4f}")
            if (checkpoint_dir and checkpoint_every
                    and step % checkpoint_every == checkpoint_every - 1):
                from repro_torch.checkpoint import io as ckpt
                from repro_torch.launch.train import nest_params

                # the parameter map, whatever the stored representation
                ckpt.save(checkpoint_dir, state._replace(params=nest_params(
                    sub_opt.materialize_params(state.params))), step)
    finally:
        if monitor is not None and monitor.log is not None:
            monitor.log.close()
    if monitor is not None:
        return state, history, monitor
    return state, history
