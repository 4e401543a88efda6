"""RBD / FPD as the basis configuration of a run (port of
``repro.core.rbd``).

``RandomBasesTransform`` is the sketch CONFIG handed to
``repro_torch.optim.subspace.SubspaceOptimizer``: ``redraw`` toggles RBD
(a new basis every step) and FPD (the basis of step 0 throughout), and
``steps_fpd`` pins the seed for the first N steps (the paper's FPD -> RBD
switch).  The step counter is a host integer: the per-step seed is folded
on the host and handed to the kernels with the segment seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import BASIS_SPECS
from repro_torch.core import rng
from repro_torch.core.compartments import Plan

__all__ = ["BASIS_SPECS", "RBDState", "RandomBasesTransform"]


class RBDState(NamedTuple):
    step: int        # step counter (folds into the per-step seed)
    basis: Any = ()  # the (total_dim, q_packed) float32 row-orthonormal
                     # basis on the materialized path (trajectory_pca /
                     # gradient_informed); () on the random path


@dataclasses.dataclass(frozen=True)
class RandomBasesTransform:
    """Basis config implementing RBD (redraw=True) or FPD (False)."""

    plan: Plan
    base_seed: int = 0
    redraw: bool = True
    backend: str = "torch"
    prng: str = "threefry"
    basis: str = "random"
    steps_fpd: int = 0

    def init(self, params=None) -> RBDState:
        del params
        return RBDState(step=0)

    def step_seed(self, step: int) -> torch.Tensor:
        """uint32 seed of step ``step`` (an int32 tensor of its bits)."""
        if not self.redraw:
            return rng.fold_seed(self.base_seed, 0)
        step = int(step)
        if self.steps_fpd and step < self.steps_fpd:
            step = 0
        return rng.fold_seed(self.base_seed, step)
