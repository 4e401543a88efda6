"""Coordinate-space optimizers (port of the first-order part of
``repro.optim.transforms``).

A ``Transform`` is an ``(init, update)`` pair of pure functions over
tensors, lists of tensors or parameter maps ``{name: tensor}``:
``update(u, state) -> (u', state')``.  The subspace optimizer runs them on
the ``(d_packed,)`` coordinate buffer, on the per-leaf ``(n_stack, dim)``
coordinate list, and -- on the ``full_space`` strategy -- on the parameter
map itself.
The second-order ``lbfgs``/``newton``, clipping, schedules and ``chain``
are not ported yet (ROADMAP.md Queue A 15).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

SECOND_ORDER_OPTIMIZERS = ("lbfgs", "newton")


class Transform(NamedTuple):
    init: Any
    update: Any  # (updates, state) -> (updates, state)


def _map(fn, *trees):
    """Apply ``fn`` leafwise over a tensor, a list/tuple (NamedTuples
    included) of tensors or a map of them (keys in the first tree's
    order)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple) and hasattr(trees[0], "_fields"):
        return type(trees[0])(*(_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def leaves(tree) -> list:
    """The tensors of a tensor, list/tuple or map, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def sgd() -> Transform:
    return Transform(init=lambda params: (),
                     update=lambda u, s: (u, s))


def momentum(beta: float = 0.9, nesterov: bool = False) -> Transform:
    def init(params):
        return _map(torch.zeros_like, params)

    def update(u, m):
        m = _map(lambda mi, ui: beta * mi + ui, m, u)
        if nesterov:
            u = _map(lambda mi, ui: beta * mi + ui, m, u)
        else:
            u = m
        return u, m

    return Transform(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor   # int32 update counter


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
        z = _map(torch.zeros_like, params)
        return AdamState(z, z, torch.zeros((), dtype=torch.int32,
                                           device=leaves(z)[0].device))

    def update(u, s):
        count = s.count + 1
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g, s.mu, u)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * g * g, s.nu, u)
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=c.device), c)
        u = _map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps),
                 mu, nu)
        return u, AdamState(mu, nu, count)

    return Transform(init, update)


def get_optimizer(name: str, *, momentum_beta: float = 0.9,
                  nesterov: bool = False, adam_b1: float = 0.9,
                  adam_b2: float = 0.999, adam_eps: float = 1e-8,
                  learning_rate: float = 0.01,
                  lbfgs_history: int = 8) -> Transform:
    """Optimizer by name with explicit hyperparameters."""
    del learning_rate, lbfgs_history  # consumed by the second-order ones
    if name == "sgd":
        return sgd()
    if name == "momentum":
        return momentum(momentum_beta, nesterov)
    if name == "adam":
        return adam(adam_b1, adam_b2, adam_eps)
    if name in SECOND_ORDER_OPTIMIZERS:
        raise NotImplementedError(
            f"the {name} coordinate optimizer is not ported yet "
            "(ROADMAP.md Queue A 15)")
    raise KeyError(f"unknown optimizer {name!r}")


def apply_updates(params, updates, lr):
    """Subtract in float32 and round ONCE into the parameter dtype."""
    return _map(lambda p, u: (p.to(torch.float32)
                              - lr * u.to(torch.float32)).to(p.dtype),
                params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))
