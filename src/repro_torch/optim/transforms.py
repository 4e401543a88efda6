"""Coordinate-space optimizers (port of ``repro.optim.transforms``).

A ``Transform`` is an ``(init, update)`` pair of pure functions over
tensors, lists of tensors or parameter maps ``{name: tensor}``:
``update(u, state) -> (u', state')``.  The subspace optimizer runs them on
the ``(d_packed,)`` or ``(total_dim,)`` coordinate buffer, on the per-leaf
``(n_stack, dim)`` coordinate list, and -- on the ``full_space`` strategy
-- on the parameter map itself.

The second-order :func:`lbfgs` (two-loop recursion over ``(m, d)`` rings)
and :func:`newton` (dense BFGS inverse Hessian at ``d <= 64``) keep their
history on the single ``(d,)`` coordinate buffer, so they need a basis
fixed between steps (a materialized basis, or FPD); ``SubspaceOptimizer``
validates the pairing.  :func:`clip_by_global_norm` and :func:`schedule`
are ``(d,)`` transforms that :func:`chain` in front of / behind any
optimizer.

Every branch stays on the device: conditions are 0-d tensors selected
with ``torch.where``, constants are Python floats or device fills, so no
update copies a value to or from the host.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

# Optimizers whose history pairs coordinate gradients ACROSS steps, so
# they require a basis that is fixed between steps (materialized, or FPD's
# redraw=False) -- SubspaceOptimizer validates the pairing.
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
        # the bases are device fills: a host-built tensor would be a
        # synchronizing copy every step
        bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                       device=c.device), c)
        bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                       device=c.device), c)
        u = _map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps),
                 mu, nu)
        return u, AdamState(mu, nu, count)

    return Transform(init, update)


class LBFGSState(NamedTuple):
    """(m, d) ring buffers, oldest -> newest.  ``mask`` is 1.0 on live
    curvature pairs; masked slots are exact no-ops in the two-loop
    recursion, so the state shape is static for any history fill."""

    s_hist: Any           # (m, d) coordinate displacements
    y_hist: Any           # (m, d) gradient differences
    sy: Any               # (m,) curvature products s.y
    yy: Any               # (m,) y.y (the newest live slot sets gamma)
    mask: Any             # (m,) float32 pair validity
    prev_g: Any           # (d,) previous coordinate gradient
    prev_step: Any        # (d,) applied displacement = -lr * direction
    count: torch.Tensor   # int32 update counter


def _require_coord_buffer(params, name: str):
    if not (isinstance(params, torch.Tensor) and params.ndim == 1):
        raise ValueError(
            f"{name} keeps its curvature history over the single "
            "(d,)-shaped coordinate buffer; this state template is "
            f"{params!r} -- it needs the materialized-basis or "
            "fixed-basis (FPD) packed path, not per-leaf or joint "
            "(K, d) coordinate state")


def _push(good, buf, v):
    """``buf`` rolled by one with ``v`` newest where ``good``, else
    ``buf`` (a 0-d bool tensor: no host decision)."""
    return torch.where(good, torch.cat([buf[1:], v.unsqueeze(0)]), buf)


def lbfgs(history: int = 8, learning_rate: float = 0.01,
          curvature_eps: float = 1e-10) -> Transform:
    """Coordinate-space L-BFGS (two-loop recursion).

    Returns the ASCENT direction ``H_k g_k``, so the caller's ``theta -=
    lr * u`` apply takes the quasi-Newton step; the displacement it
    implies, ``s_k = -lr * H_k g_k``, is recorded here, which is why the
    constructor takes the apply's ``learning_rate``.  Pairs with ``s.y <=
    curvature_eps`` are skipped, and with an empty history the direction
    is the gradient: the first step of L-BFGS is the SGD step."""
    m = int(history)
    neg_lr = -float(np.float32(learning_rate))

    def init(params):
        _require_coord_buffer(params, "lbfgs")
        d, dev = params.shape[0], params.device
        z = torch.zeros((m, d), dtype=torch.float32, device=dev)
        v = torch.zeros((m,), dtype=torch.float32, device=dev)
        return LBFGSState(z, z, v, v, v,
                          torch.zeros((d,), dtype=torch.float32, device=dev),
                          torch.zeros((d,), dtype=torch.float32, device=dev),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def update(g, st):
        g = g.to(torch.float32)
        s = st.prev_step
        y = g - st.prev_g
        sy = torch.dot(s, y)
        good = (st.count > 0) & (sy > curvature_eps)
        s_hist = _push(good, st.s_hist, s)
        y_hist = _push(good, st.y_hist, y)
        sy_h = _push(good, st.sy, sy)
        yy_h = _push(good, st.yy, torch.dot(y, y))
        mask = _push(good, st.mask, torch.ones_like(sy))
        # two-loop recursion, unrolled over the ring; a masked slot has
        # rho == 0, so both passes are exact no-ops there
        rho = mask / torch.clamp(sy_h, min=curvature_eps)
        q = g
        alphas = [None] * m
        for i in reversed(range(m)):
            a = rho[i] * torch.dot(s_hist[i], q)
            q = q - a * y_hist[i]
            alphas[i] = a
        gamma = torch.where(mask[-1] > 0,
                            sy_h[-1] / torch.clamp(yy_h[-1],
                                                   min=curvature_eps),
                            torch.ones_like(sy))
        r = gamma * q
        for i in range(m):
            b = rho[i] * torch.dot(y_hist[i], r)
            r = r + s_hist[i] * (alphas[i] - b)
        return r, LBFGSState(s_hist, y_hist, sy_h, yy_h, mask, prev_g=g,
                             prev_step=neg_lr * r, count=st.count + 1)

    return Transform(init, update)


class NewtonState(NamedTuple):
    h_inv: Any            # (d, d) dense inverse-Hessian estimate
    prev_g: Any
    prev_step: Any
    count: torch.Tensor


def newton(learning_rate: float = 0.01, max_dim: int = 64,
           curvature_eps: float = 1e-10) -> Transform:
    """Full-memory BFGS: the dense (d, d) inverse Hessian, updated
    exactly each step -- the exact-Newton limit of :func:`lbfgs`,
    affordable only because d is tiny.  Refuses coordinate buffers above
    ``max_dim``."""
    neg_lr = -float(np.float32(learning_rate))

    def init(params):
        _require_coord_buffer(params, "newton")
        d, dev = params.shape[0], params.device
        if d > max_dim:
            raise ValueError(
                f"newton keeps a dense ({d}, {d}) inverse Hessian; "
                f"d={d} exceeds max_dim={max_dim} -- use lbfgs for "
                "larger coordinate spaces")
        return NewtonState(torch.eye(d, dtype=torch.float32, device=dev),
                           torch.zeros((d,), dtype=torch.float32, device=dev),
                           torch.zeros((d,), dtype=torch.float32, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev))

    def update(g, st):
        g = g.to(torch.float32)
        s = st.prev_step
        y = g - st.prev_g
        sy = torch.dot(s, y)
        good = (st.count > 0) & (sy > curvature_eps)
        rho = 1.0 / torch.clamp(sy, min=curvature_eps)
        eye = torch.eye(g.shape[0], dtype=torch.float32, device=g.device)
        v = eye - rho * torch.outer(s, y)
        h_new = v @ st.h_inv @ v.T + rho * torch.outer(s, s)
        h = torch.where(good, h_new, st.h_inv)
        direction = h @ g
        return direction, NewtonState(h, g, neg_lr * direction,
                                      st.count + 1)

    return Transform(init, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """Stateless coordinate-space gradient clipping: on the subspace
    paths ``u`` is the (d,)-sized coordinate buffer, so the norm costs d
    multiplies, not D."""
    def update(u, s):
        factor = torch.clamp(
            float(np.float32(max_norm))
            / torch.clamp(global_norm(u), min=1e-12), max=1.0)
        return _map(lambda x: x * factor, u), s

    return Transform(init=lambda params: (), update=update)


class ScheduleState(NamedTuple):
    count: torch.Tensor   # int32 steps taken


def schedule(kind: str = "constant", *, total_steps: int = 0,
             warmup_steps: int = 0) -> Transform:
    """Multiplicative LR schedule as a pure (d,) transform -- chain it
    AFTER the optimizer so the factor scales the final update (state:
    one int32 counter)."""
    if kind not in ("constant", "cosine"):
        raise ValueError(
            f"unknown schedule {kind!r}; expected 'constant' or 'cosine'")

    def factor(t):
        f = torch.ones_like(t)
        if warmup_steps:
            f = f * torch.clamp((t + 1.0) / float(warmup_steps), max=1.0)
        if kind == "cosine":
            horizon = max(int(total_steps) - int(warmup_steps), 1)
            prog = torch.clamp((t - warmup_steps) / horizon, 0.0, 1.0)
            f = f * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return f

    def init(params):
        return ScheduleState(torch.zeros((), dtype=torch.int32,
                                         device=leaves(params)[0].device))

    def update(u, st):
        f = factor(st.count.to(torch.float32))
        return _map(lambda x: x * f, u), ScheduleState(st.count + 1)

    return Transform(init, update)


def scale(factor: float) -> Transform:
    return Transform(init=lambda params: (),
                     update=lambda u, s: (_map(lambda x: x * factor, u), s))


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(u, states):
        new_states = []
        for t, s in zip(transforms, states):
            u, s = t.update(u, s)
            new_states.append(s)
        return u, tuple(new_states)

    return Transform(init, update)


def get_optimizer(name: str, *, momentum_beta: float = 0.9,
                  nesterov: bool = False, adam_b1: float = 0.9,
                  adam_b2: float = 0.999, adam_eps: float = 1e-8,
                  learning_rate: float = 0.01,
                  lbfgs_history: int = 8) -> Transform:
    """Optimizer by name with explicit hyperparameters.  ``learning_rate``
    is consumed only by the second-order optimizers, which record their
    own displacements at the apply's scale."""
    if name == "sgd":
        return sgd()
    if name == "momentum":
        return momentum(momentum_beta, nesterov)
    if name == "adam":
        return adam(adam_b1, adam_b2, adam_eps)
    if name == "lbfgs":
        return lbfgs(lbfgs_history, learning_rate)
    if name == "newton":
        return newton(learning_rate)
    raise KeyError(f"unknown optimizer {name!r}")


def apply_updates(params, updates, lr):
    """Subtract in float32 and round ONCE into the parameter dtype."""
    return _map(lambda p, u: (p.to(torch.float32)
                              - lr * u.to(torch.float32)).to(p.dtype),
                params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))
