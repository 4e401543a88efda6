"""Port parity of the unpacked ``SubspaceOptimizer`` steps on the reduced
qwen2-0.5b: the port's ``coord_unfused`` (torch backend) and
``fused_per_leaf`` (cuda backend, the kernels' plain versions on the CPU)
against the reference's ``coord_unfused`` (jnp backend), the port's
``full_space`` under weight decay and with RBD off against the
reference's, two steps on the reference's parameters and fixed per-step
gradients (numpy, from a seed); ``fused_per_leaf`` against
``coord_unfused`` for sgd, momentum and adam; the optimizers on
parameter maps against the reference's on the same trees.

Tolerances: theta within 1e-3 of the cumulative update + 4 ulp of the
largest parameter (tests/test_torch_train.py: the coordinates inherit
the projection's relative error, adam amplifies small coordinates' and
the steps compound it); ``fused_per_leaf`` against ``coord_unfused`` the
reference's own 2e-4 (tests/test_subspace_optimizer.py); the optimizers
on maps rtol 1e-6.  Each reference step function is compiled once (about
15 s each at this size), so the reference runs two RBD cases and the
cheap RBD-off cases; the port-internal check covers every optimizer.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import compartments as ref_comp
from repro.models import get_model as ref_model
from repro.optim import transforms as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.kernels import rbd_step
from repro_torch.models.registry import get_model, params_from_reference
from repro_torch.optim import transforms as opt
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

EPS32 = 2.0 ** -23
LR = {"sgd": 0.5, "momentum": 0.1, "adam": 0.02}
STEPS = 2


@functools.cache
def _setup():
    """The reference's reduced qwen2-0.5b parameters (nested tree and
    named numpy leaves) and STEPS fixed gradient trees."""
    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    params = ref_model(rcfg).init(jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    names = [ref_comp._leaf_name(p) for p, _ in flat]
    rs = np.random.default_rng(0)
    grads = [[(rs.standard_normal(x.shape) * 0.05).astype(np.float32)
              for _, x in flat] for _ in range(STEPS)]
    return (rcfg, params, treedef, names,
            {n: np.asarray(x) for n, (_, x) in zip(names, flat)}, grads)


def _reference(optimizer, wd, enabled):
    rcfg, params, treedef, names, _, grads = _setup()
    model = ref_model(rcfg)
    tcfg = RefTrainConfig(model=rcfg, rbd=RefRBDConfig(
        enabled=enabled, total_dim=64, backend="jnp", packed="off"),
        optimizer=optimizer, learning_rate=LR[optimizer], weight_decay=wd)
    sub = ref_step.make_subspace_optimizer(
        model, tcfg, ref_step.make_transform(model, tcfg.rbd), None)
    st_r, st_o = sub.init_rbd_state(params), sub.init_opt_state(params)
    step = jax.jit(sub.step)
    p = params
    for g in grads:
        p, st_r, st_o, _ = step(p, jax.tree_util.tree_unflatten(treedef, g),
                                st_r, st_o)
    return sub.plan_execution().strategy, {
        n: np.asarray(x) for n, x in zip(names, jax.tree_util.tree_leaves(p))}


def _port(optimizer, wd, enabled, backend, packed):
    _, _, _, names, named, grads = _setup()
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(
        enabled=enabled, total_dim=64, backend=backend, packed=packed),
        optimizer=optimizer, learning_rate=LR[optimizer], weight_decay=wd)
    sub = steplib.make_subspace_optimizer(model, tcfg)
    params = params_from_reference(named, device="cpu")
    p = sub.prepare_params(params)
    assert p is params
    st_r, st_o = sub.init_rbd_state(p), sub.init_opt_state(p)
    for g in grads:
        gmap = {n: torch.from_numpy(x) for n, x in zip(names, g)}
        p, st_r, st_o, aux = sub.step(p, gmap, st_r, st_o)
        assert np.isfinite(float(aux.update_norm))
    return sub.plan_execution().strategy, {k: v.numpy() for k, v in p.items()}


def _assert_theta(got, want, theta0, rtol=1e-3):
    for k in want:
        tol = (rtol * np.abs(want[k] - theta0[k]).max()
               + 4 * EPS32 * np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("optimizer,wd,enabled", [
    ("adam", 0.0, True), ("momentum", 0.01, True), ("sgd", 0.0, False),
    ("momentum", 0.0, False), ("adam", 0.0, False)])
def test_unpacked_steps_match_reference(optimizer, wd, enabled):
    strategy, want = _reference(optimizer, wd, enabled)
    theta0 = _setup()[4]
    ports = ([("torch", "off"), ("cuda", "off")] if strategy ==
             "coord_unfused" else [("cuda", "auto")])
    rbd_step.reset_counts()
    for backend, packed in ports:
        got_strategy, got = _port(optimizer, wd, enabled, backend, packed)
        assert got_strategy == ("fused_per_leaf" if (backend, strategy) ==
                                ("cuda", "coord_unfused") else strategy)
        _assert_theta(got, want, theta0)
    assert sum(rbd_step.LAUNCHES.values()) == 0


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_fused_per_leaf_matches_coord_unfused(optimizer):
    """The per-leaf fused apply runs the same coordinate optimizer as the
    unfused path (the reference's contract, at its tolerance)."""
    _, fused = _port(optimizer, 0.0, True, "cuda", "off")
    _, unfused = _port(optimizer, 0.0, True, "torch", "off")
    for k in fused:
        np.testing.assert_allclose(fused[k], unfused[k], rtol=2e-4,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_optimizers_on_parameter_maps_match_reference(optimizer):
    """sgd/momentum/adam over maps (the full-space state) against the
    reference's transforms on the same trees, three updates."""
    rs = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b/c": (5,), "d": ()}
    ups = [{k: rs.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()} for _ in range(3)]
    port = opt.get_optimizer(optimizer)
    ref = (ref_opt.momentum() if optimizer == "momentum"
           else ref_opt.adam())
    st = port.init({k: torch.zeros(s) for k, s in shapes.items()})
    rst = ref.init({k: np.zeros(s, np.float32) for k, s in shapes.items()})
    for u in ups:
        got, st = port.update({k: torch.from_numpy(v) for k, v in u.items()},
                              st)
        want, rst = ref.update(u, rst)
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    assert list(got) == list(shapes)
