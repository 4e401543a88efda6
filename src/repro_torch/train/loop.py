"""The materialized-basis collector of the training loop (port of
``repro.train.loop.BasisCollector``; the rest of that module, the simple
single-process ``train`` loop, is ROADMAP.md Queue A 19).

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

import numpy as np
import torch

from repro_torch.core import projector


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
