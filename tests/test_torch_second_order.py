"""Port parity of the coordinate-space second-order optimizers and the
(d,) transforms (``repro_torch.optim.transforms``: ``lbfgs``, ``newton``,
``clip_by_global_norm``, ``schedule``, ``chain``) against
``repro.optim.transforms``, and of their use by the packed step under FPD
(a fixed basis) and by the launcher's basis-layer flags.

* transforms: the same seeded numpy (d,) gradient sequence (an SGD
  trajectory on an ill-conditioned quadratic, two gradients repeated so
  that y = 0 and the pair is skipped) through both packages for 14 steps:
  every output and every state field within 1e-4 of the field's largest
  magnitude (float32 dot products summed in another order, amplified by
  the curvature divisions; measured up to 3.6e-5), integer counters
  exact; newton's ``max_dim`` refusal with the reference's message; the
  first lbfgs step is the sgd step bit for bit;
* the second-order pairing: refused with the reference's messages where
  the reference refuses it (per-step redraw, the joint (K, d) subspace,
  the per-leaf route), accepted under FPD and on the materialized basis;
* FPD + lbfgs (with coordinate clipping and a cosine schedule chained) on
  the packed step, the kernels' plain versions, against the reference's
  jnp packed step on the reduced qwen2-0.5b: 4 steps from the reference's
  parameters and batches, losses within 1e-5, theta within 1e-3 of the
  cumulative update + 4 ulp of max|theta|, the optimizer state within
  1e-3 of each field's largest magnitude (the coordinates inherit the
  gradient's ~1e-5 relative error and L-BFGS's divisions amplify it);
* the launcher's ``--basis`` / ``--coord-optimizer`` / ``--basis-refresh-
  every``: the reference's plan lines, a refresh, the reference's refusal;
* the guard on an lbfgs step under FPD: healthy, the unguarded step bit
  for bit; a NaN step leaves theta and the L-BFGS state untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import compartments as ref_comp
from repro.core import make_plan as ref_make_plan
from repro.core.rbd import RandomBasesTransform as RefTransform
from repro.data import synthetic as ref_data
from repro.models import get_model as ref_model
from repro.optim import subspace as ref_subspace
from repro.optim import transforms as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import compartments
from repro_torch.core import resilience as res
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.data import synthetic
from repro_torch.kernels import rbd_step
from repro_torch.launch import train as launcher
from repro_torch.models.registry import (get_model, opt_state_from_reference,
                                         params_from_reference)
from repro_torch.optim import subspace
from repro_torch.optim import transforms as opt
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

EPS32 = 2.0 ** -23
D, N_STEPS = 24, 14
FIELD_RTOL = 1e-4


def _gradients():
    """(D,) float32 gradients of an SGD trajectory on a quadratic of
    condition number ~32; steps 4 and 9 repeat the previous gradient."""
    rs = np.random.default_rng(0)
    qm, _ = np.linalg.qr(rs.standard_normal((D, D)))
    h = (qm * np.logspace(0, 1.5, D)) @ qm.T
    x = rs.standard_normal(D)
    out = []
    for k in range(N_STEPS):
        g = out[-1].copy() if k in (4, 9) else (h @ x).astype(np.float32)
        out.append(g)
        x = x - 0.05 * g
    return out


def _close(got: torch.Tensor, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    tol = FIELD_RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


TRANSFORMS = {
    "lbfgs_m4": lambda o: o.lbfgs(4, 0.05),
    "lbfgs_m16": lambda o: o.lbfgs(16, 0.05),
    "newton": lambda o: o.newton(0.05),
    "clip": lambda o: o.clip_by_global_norm(30.0),
    "cosine_warmup": lambda o: o.schedule("cosine", total_steps=10,
                                          warmup_steps=3),
    "constant_warmup": lambda o: o.schedule("constant", warmup_steps=5),
    "scale": lambda o: o.scale(0.3),
    "chain": lambda o: o.chain(o.clip_by_global_norm(30.0), o.lbfgs(4, 0.05),
                               o.schedule("cosine", total_steps=10,
                                          warmup_steps=3)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_reference(name):
    ref = TRANSFORMS[name](ref_opt)
    port = TRANSFORMS[name](opt)
    st_r = ref.init(jnp.zeros((D,), jnp.float32))
    st_p = port.init(torch.zeros(D))
    for i, g in enumerate(_gradients()):
        u_r, st_r = ref.update(jnp.asarray(g), st_r)
        u_p, st_p = port.update(torch.from_numpy(g), st_p)
        _close(u_p, u_r, f"{name} output, step {i}")
        leaves_r = jax.tree_util.tree_leaves(st_r)
        leaves_p = opt.leaves(st_p)
        assert len(leaves_r) == len(leaves_p)
        for j, (a, b) in enumerate(zip(leaves_r, leaves_p)):
            _close(b, a, f"{name} state leaf {j}, step {i}")
    if name == "lbfgs_m16":
        # 13 pairs offered, the two with y = 0 skipped (s.y <= eps)
        assert float(st_p.mask.sum()) == 11.0
        assert int(st_p.count) == N_STEPS


def test_lbfgs_first_step_is_the_sgd_step():
    g = torch.from_numpy(_gradients()[0])
    tr = opt.lbfgs(8, 0.1)
    u, st = tr.update(g, tr.init(torch.zeros(D)))
    assert torch.equal(u, g)
    assert float(st.mask.sum()) == 0.0 and int(st.count) == 1


def test_newton_refuses_large_dim():
    with pytest.raises(ValueError) as want:
        ref_opt.newton(0.1, max_dim=64).init(jnp.zeros((65,), jnp.float32))
    with pytest.raises(ValueError, match="max_dim") as got:
        opt.newton(0.1, max_dim=64).init(torch.zeros(65))
    assert str(got.value) == str(want.value)
    opt.newton(0.1, max_dim=64).init(torch.zeros(64))   # the boundary


def test_second_order_refuses_per_leaf_buffers():
    with pytest.raises(ValueError, match="single \\(d,\\)-shaped"):
        opt.lbfgs().init([torch.zeros(3, 4)])
    with pytest.raises(ValueError, match="single \\(d,\\)-shaped"):
        opt.newton().init(torch.zeros(2, 4))


def test_schedule_refuses_unknown_kind():
    with pytest.raises(ValueError) as want:
        ref_opt.schedule("linear")
    with pytest.raises(ValueError) as got:
        opt.schedule("linear")
    assert str(got.value) == str(want.value)


def test_get_optimizer_plumbs_the_second_order_ones():
    for name in ("lbfgs", "newton"):
        tr = opt.get_optimizer(name, learning_rate=0.2, lbfgs_history=3)
        st = tr.init(torch.zeros(5))
        if name == "lbfgs":
            assert tuple(st.s_hist.shape) == (3, 5)
        g = torch.arange(5, dtype=torch.float32)
        _, st = tr.update(g, st)
        assert torch.equal(st.prev_step, -0.2 * g)
    with pytest.raises(KeyError):
        opt.get_optimizer("rmsprop")


def test_adam_bias_correction_bits_unchanged():
    """Adam's bias-correction bases are device fills now: the same bits as
    the host-built constants they replace."""
    rs = np.random.default_rng(1)
    tr = opt.adam(0.9, 0.999, 1e-8)
    st = tr.init(torch.zeros(33))
    for _ in range(5):
        g = torch.from_numpy(rs.standard_normal(33).astype(np.float32))
        c = (st.count + 1).to(torch.float32)
        want_bc1 = 1 - torch.pow(torch.tensor(0.9, dtype=torch.float32), c)
        want_bc2 = 1 - torch.pow(torch.tensor(0.999, dtype=torch.float32), c)
        mu = 0.9 * st.mu + (1 - 0.9) * g
        nu = 0.999 * st.nu + (1 - 0.999) * g * g
        want = (mu / want_bc1) / (torch.sqrt(nu / want_bc2) + 1e-8)
        u, st = tr.update(g, st)
        assert torch.equal(u, want)


# ---------------------------------------------------------------------------
# the second-order pairing on the subspace optimizer
# ---------------------------------------------------------------------------

SHAPES = {"w": (16, 8), "b": (8,)}


def _ref_fixture():
    params = {"w": jnp.ones((16, 8)), "b": jnp.zeros((8,))}
    return params, ref_make_plan(params, 12)


def _subs(name, **kw):
    """The reference's and the port's SubspaceOptimizer on one config."""
    rparams, rplan = _ref_fixture()
    plan = compartments.make_plan(SHAPES, 12)
    tkw = kw.pop("transform", {})
    ref = ref_subspace.SubspaceOptimizer(
        transform=RefTransform(rplan, 0, **tkw), optimizer=name,
        learning_rate=0.1, params_template=rparams, **kw)
    port = subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, 0, **tkw), optimizer=name,
        learning_rate=0.1, **kw)
    return ref, rparams, port


@pytest.mark.parametrize("name", opt.SECOND_ORDER_OPTIMIZERS)
@pytest.mark.parametrize("case", [
    dict(use_packed=True),
    dict(use_packed=True, transform=dict(redraw=False, steps_fpd=0),
         mode="independent_bases", k_workers=2),
    dict(use_packed=False, transform=dict(redraw=False)),
    dict(use_packed=True, transform=dict(steps_fpd=2)),
], ids=["redraw", "joint", "per_leaf", "fpd_then_rbd"])
def test_second_order_refused_with_the_references_message(name, case):
    ref, rparams, port = _subs(name, **case)
    with pytest.raises(ValueError) as want:
        ref.init_opt_state(rparams)
    with pytest.raises(ValueError) as got:
        port.init_opt_state(device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", opt.SECOND_ORDER_OPTIMIZERS)
@pytest.mark.parametrize("tkw", [dict(redraw=False),
                                 dict(basis="trajectory_pca"),
                                 dict(basis="gradient_informed")])
def test_second_order_accepted_on_a_fixed_basis(name, tkw):
    ref, rparams, port = _subs(name, use_packed=True, transform=tkw)
    want = ref.init_opt_state(rparams)
    got = port.init_opt_state(device="cpu")
    assert type(got).__name__ == type(want).__name__
    for a, b in zip(jax.tree_util.tree_leaves(want), opt.leaves(got)):
        assert tuple(b.shape) == a.shape


def test_chain_state_layout_matches_reference():
    """No clip and no schedule: the bare optimizer's state (the layout of
    every earlier snapshot); otherwise the chain's tuple."""
    for kw, n in [({}, None), (dict(coord_clip_norm=1.0), 2),
                  (dict(lr_schedule="cosine", lr_total_steps=5), 2),
                  (dict(coord_clip_norm=1.0, lr_warmup_steps=2), 3)]:
        ref, rparams, port = _subs("momentum", use_packed=True, **kw)
        want = ref.init_opt_state(rparams)
        got = port.init_opt_state(device="cpu")
        assert (isinstance(got, tuple) and len(got) == n) == (n is not None)
        assert jax.tree_util.tree_structure(want).num_leaves == len(
            opt.leaves(got))


# ---------------------------------------------------------------------------
# FPD + lbfgs on the packed step against the reference's jnp packed step
# ---------------------------------------------------------------------------

TCFG = dict(optimizer="lbfgs", learning_rate=0.5, coord_clip_norm=1.0,
            lr_schedule="cosine", lr_warmup_steps=1, steps=4,
            lbfgs_history=3)


def test_fpd_lbfgs_packed_step_matches_reference():
    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    rmodel = ref_model(rcfg)
    rtcfg = RefTrainConfig(model=rcfg, rbd=RefRBDConfig(
        total_dim=64, backend="jnp", packed="on", redraw=False), **TCFG)
    r_init, r_step, r_opt = ref_step.make_train_step(
        rmodel, rtcfg, return_optimizer=True)
    assert r_opt.plan_execution().strategy == "fused_packed"
    r_step = jax.jit(r_step)
    rstate = r_init(jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        r_opt.materialize_params(rstate.params))
    named = {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=64, backend="cuda",
                                                redraw=False), **TCFG)
    init_state, train_step = steplib.make_train_step(get_model(cfg), tcfg,
                                                     device="cpu")
    state = init_state(params=params_from_reference(named, device="cpu"))
    carried = opt_state_from_reference(jax.device_get(rstate.opt_state),
                                       device="cpu")
    assert [tuple(x.shape) for x in opt.leaves(carried)] == [
        tuple(x.shape) for x in opt.leaves(state.opt_state)]
    theta0 = np.asarray(rstate.params)
    data = ref_data.lm_batches(0, 2, 16, rcfg.vocab)
    rbd_step.reset_counts()
    for i in range(4):
        batch = next(data)
        rstate, rmetrics = r_step(rstate, batch)
        state, metrics = train_step(
            state, {k: torch.from_numpy(np.array(v)).long()
                    for k, v in batch.items()})
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rmetrics["loss"]), rtol=1e-5)
        want = np.asarray(rstate.params)
        tol = (1e-3 * np.abs(want - theta0).max()
               + 4 * EPS32 * np.abs(want).max())
        np.testing.assert_allclose(state.params.numpy(), want, rtol=0,
                                   atol=tol, err_msg=f"step {i}")
        for j, (a, b) in enumerate(zip(
                jax.tree_util.tree_leaves(rstate.opt_state),
                opt.leaves(state.opt_state))):
            a = np.asarray(a)
            atol = 1e-3 * max(float(np.abs(a).max()), 1e-30)
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=atol,
                                       err_msg=f"opt leaf {j}, step {i}")
    lb = state.opt_state[1]
    assert float(lb.mask.sum()) == float(rstate.opt_state[1].mask.sum())
    # the fixed basis keeps the packed step: two kernel-wrapper calls a step
    assert rbd_step.CALLS["project_packed"] == 4
    assert rbd_step.CALLS["reconstruct_apply_packed"] == 4


# ---------------------------------------------------------------------------
# the launcher's flags
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
          "--rbd-backend", "cuda", "--rbd-dim", "8", "--batch", "2",
          "--seq", "8"]


@pytest.mark.parametrize("basis,optimizer", [
    ("trajectory_pca", "lbfgs"), ("gradient_informed", "newton"),
    ("random", "momentum")])
def test_launcher_basis_flags_print_the_references_plan(capsys, basis,
                                                        optimizer):
    res_ = launcher.main(LAUNCH + ["--basis", basis, "--coord-optimizer",
                                   optimizer, "--optimizer", "adam",
                                   "--basis-refresh-every", "2",
                                   "--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    ref = ref_subspace.plan_from_flags(
        use_packed=True, backend="pallas", axis_name="data", k_workers=1,
        basis=basis)
    for line in (f"update path: {ref.strategy} -- {ref.reason}",
                 f"basis: {ref.basis} -- {ref.basis_reason}",
                 f"prng impl: {ref.prng_impl} -- {ref.prng_reason}",
                 f"exchange schedule: {ref.overlap_exchange} -- "
                 f"{ref.overlap_reason}"):
        assert line in out
    assert res_.sub_opt.optimizer == optimizer    # supersedes --optimizer
    assert all(np.isfinite(res_.losses)) and len(res_.losses) == 3
    if basis == "random":
        assert res_.collector is None
        assert not any(x.startswith("basis refresh") for x in out)
        return
    assert res_.collector.refresh_every == 2 and res_.collector.refreshes == 1
    assert f"basis refresh 1 after step 1 ({basis})" in out
    assert res_.collectives["all_reduce"] == 3    # the one (d,) exchange
    kind = "basis_grad_all_reduce"
    assert res_.collectives[kind] == (3 if basis == "gradient_informed"
                                      else 0)


def test_launcher_refuses_lbfgs_on_a_redrawn_basis():
    _, rparams, port = _subs("lbfgs", use_packed=True)
    with pytest.raises(ValueError) as got:
        launcher.main(LAUNCH + ["--coord-optimizer", "lbfgs", "--steps",
                                "1"])
    assert "FIXED between steps" in str(got.value)
    with pytest.raises(ValueError) as want:
        port.init_opt_state(device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the guard on an lbfgs step under FPD
# ---------------------------------------------------------------------------


def test_guarded_fpd_lbfgs_step():
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=40, backend="cuda",
                                                redraw=False),
                       **dict(TCFG, learning_rate=0.2))
    runs = {}
    for name, rcfg in [
            ("plain", None),
            ("guarded", res.ResilienceConfig(guard=res.GuardConfig())),
            ("faulted", res.ResilienceConfig(
                guard=res.GuardConfig(),
                fault_plan=res.FaultPlan((res.FaultEvent(1, "nan_grad"),))))]:
        init_state, train_step = steplib.make_train_step(
            model, tcfg, device="cpu", resilience=rcfg)
        state = init_state(0)
        data = synthetic.lm_batches(0, 2, 8, cfg.vocab, device="cpu")
        states = [state]
        for _ in range(3):
            state, _ = train_step(state, next(data))
            states.append(state)
        runs[name] = states
    for a, b in zip(runs["plain"], runs["guarded"]):
        assert torch.equal(a.params, b.params)
        assert all(torch.equal(x, y) for x, y in zip(
            opt.leaves(a.opt_state), opt.leaves(b.opt_state)))
    f = runs["faulted"]
    # step 1 rejected: theta and the whole chained state frozen bit for bit
    assert torch.equal(f[2].params, f[1].params)
    assert all(torch.equal(x, y) for x, y in zip(
        opt.leaves(f[2].opt_state), opt.leaves(f[1].opt_state)))
    assert int(f[3].guard.nonfinite_count) == 1
    assert torch.isfinite(f[3].params).all()
    assert not torch.equal(f[3].params, f[2].params)


def test_from_config_plumbs_the_chain():
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    sub = steplib.make_subspace_optimizer(get_model(cfg), TrainConfig(
        model=cfg, rbd=RBDConfig(total_dim=40, backend="cuda",
                                 redraw=False), **TCFG), device="cpu")
    assert (sub.lr_total_steps, sub.coord_clip_norm, sub.lr_schedule,
            sub.lr_warmup_steps, sub.lbfgs_history) == (4, 1.0, "cosine", 1, 3)
