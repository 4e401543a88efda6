"""Antithetic NES baseline (paper section 2.2 / supplementary A; port of
``repro.core.nes``).

A gradient-free estimator in the same random bases as RBD:

    c_n = (L(theta + sigma*phi_n) - L(theta - sigma*phi_n)) / (2*sigma*d)

(antithetic pairs; the one-sided form is ``L(theta + sigma*phi_n) /
(sigma*d)``), reconstructed through the shared projector.  It reuses the
compartment plan and the counter PRNG, so NES, FPD and RBD explore the
same directions at a seed -- the comparison of paper Table 1 is only in
how the coordinates are obtained (loss samples against projections).

It costs 2 forward passes a direction (one one-sided), evaluated one
direction at a time as the reference's ``lax.map`` does; only the
reconstruction runs a kernel (``reconstruct_flat``, and under 'exact'
normalization the ``project_flat`` norm pass, one launch each a leaf).
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core import projector, rng
from repro_torch.core.compartments import Plan, leaf_order


def _direction(plan: Plan, lp, seed, dir_i: int, device) -> torch.Tensor:
    """Row ``dir_i`` of compartment seed ``seed``'s basis, normalized as
    the plan says (the reference's per-direction draw)."""
    phi = rng.generate_block(seed, dir_i, 0, (1, lp.size),
                             plan.distribution, device=device)[0]
    if plan.normalization == "rsqrt_dim":
        phi = phi * float(np.float32(1.0 / np.sqrt(lp.size)))
    elif plan.normalization == "exact":
        phi = phi * torch.rsqrt(torch.clamp((phi * phi).sum(), min=1e-30))
    return phi


def nes_coordinates(loss_fn: Callable[[Mapping[str, torch.Tensor]],
                                      torch.Tensor],
                    params: Mapping[str, torch.Tensor], plan: Plan, seed, *,
                    sigma: float = 0.01, antithetic: bool = True) -> list:
    """The estimator's coordinates: one ``(n_stack, dim)`` float32 tensor a
    LeafPlan, each a directional finite difference over ``sigma`` divided
    by ``d_k``, every loss evaluated under ``torch.no_grad()``."""
    params_like = params
    if plan.flatten:
        # global/even plans perturb the raveled vector; the loss sees the
        # parameter map unraveled from it at every evaluation
        params = {"<flat>": projector._ravel_tree(params, plan)}
        orig_loss = loss_fn
        loss_fn = lambda tree: orig_loss(  # noqa: E731
            projector._unravel_tree(tree["<flat>"], plan, params_like))
    names = leaf_order(params)
    device = params[names[0]].device

    coords = []
    with torch.no_grad():
        for lp in plan.leaves:
            name = names[lp.leaf_idx]
            leaf = params[name]
            # compartment seeds as projector._stack_seeds folds them (the
            # stack index only on stacked leaves)
            seeds = projector._leaf_seeds(seed, lp)
            c = []
            for stack_i in range(lp.n_stack):
                for dir_i in range(lp.dim):
                    phi = _direction(plan, lp, int(seeds[stack_i]), dir_i,
                                     device)

                    def perturbed(sign):
                        if lp.stacked:
                            flat = leaf.reshape(lp.n_stack, lp.size).clone()
                            flat[stack_i] += sign * sigma * phi
                            new = flat.reshape(lp.shape)
                        else:
                            new = (leaf.reshape(-1)
                                   + sign * sigma * phi).reshape(lp.shape)
                        return loss_fn({**params, name: new})

                    if antithetic:
                        c.append((perturbed(1.0) - perturbed(-1.0))
                                 / (2.0 * sigma))
                    else:
                        c.append(perturbed(1.0) / sigma)
            c = torch.stack(c).to(torch.float32).reshape(lp.n_stack, lp.dim)
            # the 1/d of the ES estimator (expectation over directions)
            coords.append(c / float(np.float32(lp.dim)))
    return coords


def nes_gradient(loss_fn: Callable[[Mapping[str, torch.Tensor]],
                                   torch.Tensor],
                 params: Mapping[str, torch.Tensor], plan: Plan, seed, *,
                 sigma: float = 0.01, antithetic: bool = True,
                 backend: str = "auto") -> dict:
    """Estimate the gradient sketch from loss evaluations only: the
    coordinates of :func:`nes_coordinates` reconstructed through
    ``projector.reconstruct``, so the result lies in the span RBD uses at
    this seed.  ``backend="auto"`` is ``cuda`` (the kernels) on a card and
    ``torch`` (their plain versions) on the CPU, as the launcher resolves
    it; ``cuda`` needs the parameters on a CUDA device.
    ``params`` is a parameter map; the result is a map shaped and typed
    like it."""
    from repro_torch.launch.train import resolve_backend

    device = next(iter(params.values())).device
    backend = resolve_backend(backend, device)
    if backend == "cuda" and device.type != "cuda":
        raise RuntimeError(
            f"backend='cuda' launches the kernels and needs the parameters "
            f"on a CUDA device, got {device}; use backend='torch' (or "
            "'auto') for the plain versions on the CPU")
    coords = nes_coordinates(loss_fn, params, plan, seed, sigma=sigma,
                             antithetic=antithetic)
    return projector.reconstruct(coords, plan, seed, params, backend=backend)
