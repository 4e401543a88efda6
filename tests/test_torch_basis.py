"""Port parity of the basis layer: the materialized basis
(``core.projector.materialize_random_basis``,
``refresh_materialized_basis``, ``project_materialized``,
``reconstruct_apply_materialized``), the ``materialized_packed`` step of
``optim.subspace.SubspaceOptimizer`` and ``train.loop.BasisCollector``,
against ``repro`` on the same numpy inputs.

* the refresh: the port's numpy code gives the reference's bits on the
  same basis and snapshots (zero rows, all-zero snapshots, more snapshots
  than rows);
* the initial basis: its values cannot be the reference's (``jax.random``
  is not reproducible in torch), so its properties are held: rows
  orthonormal within 1e-5, padding columns exactly zero, the same seed the
  same bits, another seed another basis, ``q_packed < d`` refused with the
  reference's message;
* the two products against the reference's on the same numpy inputs,
  within 1e-6 of the largest magnitude (float32 sums in another order);
* the step: sgd is ``theta - lr B^T (B g)``; L-BFGS's first step is the
  sgd step; clipping and warmup compose; the basis is carried;
* a 6-step run on the reduced qwen2-0.5b at rbd-dim 40 (total_dim 54),
  refresh every 3 steps, from the reference's parameters, batches and
  initial basis:
  losses within 1e-5, theta within 1e-3 of the cumulative update + 4 ulp
  of max|theta|, ``basis_grad`` within 1e-4 of its largest magnitude (the
  gradient's ~1e-5 relative error, test_torch_model.py), and each
  refreshed basis by its span: the singular values of ``B_port B_ref^T``
  within 1e-4 of 1 (the SVD's signs and the order of equal singular
  values are free; the update depends only on the span).  The pairs are
  trajectory_pca + momentum here and gradient_informed + lbfgs in
  test_torch_basis_run.py (one run a file keeps each file near 20 s).
  trajectory_pca + lbfgs is not held by span: a trajectory delta lies in
  the old basis's span up to theta's float32 rounding, the refresh's QR
  of ``[snapshot directions; old rows]`` lifts that rounding into a basis
  direction, and L-BFGS's ~2e-4 relative step differences left one
  singular value at 1 - 1.74e-4 after the second refresh (the other 53
  within 1e-6) -- a property of the reference's refresh, which the same
  inputs reproduce bit for bit (above);
* resilience features refused on the materialized plan with the
  reference's ``ValueError``.
"""

import functools
import types

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
from repro.core import projector as ref_proj
from repro.core import resilience as ref_res
from repro.core.rbd import RandomBasesTransform as RefTransform
from repro.data import synthetic as ref_data
from repro.models import get_model as ref_model
from repro.optim import subspace as ref_subspace
from repro.train import loop as ref_loop
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import compartments, projector
from repro_torch.core import resilience as res
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.data import synthetic
from repro_torch.models.registry import (get_model, params_from_reference,
                                         rbd_state_from_reference)
from repro_torch.optim import subspace
from repro_torch.optim import transforms as opt
from repro_torch.train import loop
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

EPS32 = 2.0 ** -23
SHAPES = {"w": (16, 8), "b": (8,)}


def _plan(d=12, **kw):
    return compartments.make_plan(SHAPES, d, **kw)


def _ref_plan(d=12):
    params = {"w": jnp.ones((16, 8)), "b": jnp.zeros((8,))}
    return params, ref_make_plan(params, d)


def _grads(plan):
    g = {"w": torch.full((16, 8), 0.5), "b": torch.full((8,), -0.25)}
    return projector.pack_tree(g, plan, plan.packed())


# ---------------------------------------------------------------------------
# the refresh, bit for bit
# ---------------------------------------------------------------------------


def _snapshots(kind, q, valid):
    rs = np.random.default_rng(1)
    if kind == "zero":
        return np.zeros((3, q), np.float32)
    snaps = rs.normal(size=(4 if kind != "many" else 20, q)).astype(
        np.float32) * valid
    if kind == "zero_rows":
        snaps[1] = 0.0
    return snaps


@pytest.mark.parametrize("kind", ["plain", "zero_rows", "zero", "many"])
def test_refresh_is_the_references_bit_for_bit(kind):
    plan = _plan(d=8)
    layout = plan.packed()
    valid = layout.param_valid
    basis = projector.materialize_random_basis(plan, layout, 0,
                                               device="cpu").numpy()
    snaps = _snapshots(kind, layout.q_packed, valid)
    got = projector.refresh_materialized_basis(basis, snaps)
    want = ref_proj.refresh_materialized_basis(basis, snaps)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got @ got.T, np.eye(plan.total_dim),
                               atol=1e-4)
    assert np.all(got[:, valid == 0] == 0.0)
    if kind == "zero":
        np.testing.assert_array_equal(got, basis)


# ---------------------------------------------------------------------------
# the initial basis: its properties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,seed", [(12, 3), (30, 0), (7, 2**31 + 5)])
def test_materialize_random_basis_properties(d, seed):
    plan = _plan(d=d)
    layout = plan.packed()
    basis = projector.materialize_random_basis(plan, layout, seed,
                                               device="cpu")
    assert basis.shape == (plan.total_dim, layout.q_packed)
    assert basis.dtype == torch.float32 and basis.is_contiguous()
    gram = (basis.double() @ basis.double().T).numpy()
    np.testing.assert_allclose(gram, np.eye(plan.total_dim), atol=1e-5)
    valid = torch.from_numpy(layout.param_valid.astype(bool))
    assert bool((basis[:, ~valid] == 0).all())
    again = projector.materialize_random_basis(plan, layout, seed,
                                               device="cpu")
    assert torch.equal(basis, again)
    other = projector.materialize_random_basis(plan, layout, seed + 1,
                                               device="cpu")
    assert not torch.equal(basis, other)
    # seeds agree modulo 2**31, as the reference's PRNGKey(seed & 0x7FFFFFFF)
    masked = projector.materialize_random_basis(plan, layout,
                                                seed & 0x7FFFFFFF,
                                                device="cpu")
    assert torch.equal(basis, masked)


def test_materialize_random_basis_takes_a_generator():
    plan = _plan()
    gen = torch.Generator().manual_seed(11)
    a = projector.materialize_random_basis(plan, plan.packed(), 0,
                                           device="cpu", generator=gen)
    b = projector.materialize_random_basis(plan, plan.packed(), 11,
                                           device="cpu")
    assert torch.equal(a, b)


def test_materialize_refuses_q_below_d():
    plan = types.SimpleNamespace(total_dim=8)
    layout = types.SimpleNamespace(q_packed=5, param_valid=np.ones(5))
    with pytest.raises(ValueError) as want:
        ref_proj.materialize_random_basis(plan, layout, 0)
    with pytest.raises(ValueError, match="q_packed >= d") as got:
        projector.materialize_random_basis(plan, layout, 0, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("q,d,chunk", [(1000, 25, 97), (200, 64, 1 << 22),
                                       (5000, 3, 4096)])
def test_orthonormal_rows_spans_the_columns(q, d, chunk):
    a = torch.from_numpy(np.random.default_rng(q).standard_normal(
        (q, d)).astype(np.float32))
    a[::7] = 0.0
    rows = projector.orthonormal_rows(a.clone(), chunk=chunk)
    assert rows.shape == (d, q)
    np.testing.assert_allclose((rows.double() @ rows.double().T).numpy(),
                               np.eye(d), atol=1e-5)
    assert bool((rows[:, ::7] == 0).all())
    # the same span as the columns of a Householder QR
    qh, _ = torch.linalg.qr(a.double())
    sv = torch.linalg.svdvals(rows.double() @ qh).numpy()
    np.testing.assert_allclose(sv, 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# the two products and the step
# ---------------------------------------------------------------------------


def test_products_match_reference():
    rs = np.random.default_rng(4)
    basis = rs.standard_normal((9, 301)).astype(np.float32)
    g = rs.standard_normal(301).astype(np.float32)
    c = rs.standard_normal(9).astype(np.float32)
    theta = rs.standard_normal(301).astype(np.float32)
    want_u = np.asarray(ref_proj.project_materialized(basis, g))
    got_u = projector.project_materialized(torch.from_numpy(basis),
                                           torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got_u, want_u, rtol=0,
                               atol=1e-6 * np.abs(want_u).max())
    want = np.asarray(ref_proj.reconstruct_apply_materialized(
        c, basis, theta, 0.3))
    got = projector.reconstruct_apply_materialized(
        torch.from_numpy(c), torch.from_numpy(basis),
        torch.from_numpy(theta), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _sub(optimizer="sgd", basis="trajectory_pca", **kw):
    return subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(_plan(), 5, basis=basis),
        optimizer=optimizer, learning_rate=0.25, use_packed=True, **kw)


def test_materialized_step_is_the_dense_projection():
    sub = _sub()
    assert sub.plan_execution().strategy == "materialized_packed"
    plan = sub.transform.plan
    theta = torch.linspace(-1, 1, plan.packed().q_packed)
    st_rbd = sub.init_rbd_state(device="cpu")
    st_opt = sub.init_opt_state(device="cpu")
    g = _grads(plan)
    new, new_rbd, _, aux = sub.step(theta, g, st_rbd, st_opt)
    b = st_rbd.basis.double()
    want = theta.double() - 0.25 * (b.T @ (b @ g.double()))
    np.testing.assert_allclose(new.numpy(), want.numpy(), atol=1e-6)
    assert new_rbd.basis is st_rbd.basis and new_rbd.step == 1
    np.testing.assert_allclose(float(aux.update_norm),
                               float((b @ g.double()).norm()), rtol=1e-5)


def test_materialized_lbfgs_first_step_is_sgd():
    plan = _plan()
    theta = torch.linspace(-1, 1, plan.packed().q_packed)
    outs = {}
    for name in ("sgd", "lbfgs", "newton"):
        sub = _sub(name)
        st_rbd = sub.init_rbd_state(device="cpu")
        outs[name], _, _, _ = sub.step(theta, _grads(plan), st_rbd,
                                       sub.init_opt_state(device="cpu"))
    assert torch.equal(outs["lbfgs"], outs["sgd"])
    assert torch.equal(outs["newton"], outs["sgd"])


def test_clip_and_schedule_compose_on_the_materialized_step():
    """The reference's check: clip caps the (d,) coordinates at norm 1,
    warmup step 0 halves the update and the orthonormal basis keeps
    norms, so the applied delta is lr * 0.5 * min(1, ||B g||)."""
    sub = _sub("momentum", basis="gradient_informed", coord_clip_norm=1.0,
               lr_schedule="cosine", lr_warmup_steps=2, lr_total_steps=10)
    plan = sub.transform.plan
    theta = torch.zeros(plan.packed().q_packed)
    g = _grads(plan)
    st_rbd = sub.init_rbd_state(device="cpu")
    st_opt = sub.init_opt_state(device="cpu")
    assert isinstance(st_opt, tuple) and len(st_opt) == 3
    new, _, st_opt, _ = sub.step(theta, g, st_rbd, st_opt)
    coords = st_rbd.basis @ g
    expect = 0.25 * 0.5 * min(1.0, float(coords.norm()))
    np.testing.assert_allclose(float((new - theta).norm()), expect,
                               rtol=1e-5)
    assert int(st_opt[2].count) == 1


def test_materialized_state_templates():
    sub = _sub("adam")
    plan = sub.transform.plan
    st = sub.init_opt_state(None)          # the collector's re-zeroing
    assert tuple(st.mu.shape) == (plan.total_dim,)
    assert tuple(sub.init_rbd_state(device="cpu").basis.shape) == (
        plan.total_dim, plan.packed().q_packed)
    assert subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(_plan(), 5), use_packed=True
    ).init_rbd_state(device="cpu").basis == ()


def test_resilience_refused_on_the_materialized_plan():
    rparams, rplan = _ref_plan()
    ref = ref_subspace.SubspaceOptimizer(
        transform=RefTransform(rplan, 5, basis="trajectory_pca"),
        learning_rate=0.25, params_template=rparams, use_packed=True,
        guard=ref_res.GuardConfig())
    port = _sub(guard=res.GuardConfig())
    stored = ref.prepare_params(rparams)
    with pytest.raises(ValueError) as want:
        ref.step(stored, stored, ref.init_rbd_state(rparams),
                 ref.init_opt_state(rparams))
    plan = port.transform.plan
    theta = torch.zeros(plan.packed().q_packed)
    with pytest.raises(ValueError) as got:
        port.step(theta, theta, port.init_rbd_state(device="cpu"), ())
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------


def _tiny_lm(optimizer, basis, refresh=3, lr=0.5):
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tcfg = TrainConfig(
        model=cfg, optimizer=optimizer,
        rbd=RBDConfig(total_dim=40, backend="cuda", basis=basis,
                      basis_refresh_every=refresh),
        learning_rate=lr, steps=6, batch_size=2, seq_len=16)
    return cfg, get_model(cfg), tcfg


def test_random_path_builds_no_collector():
    _, model, tcfg = _tiny_lm("sgd", "random")
    _, _, sub = steplib.make_train_step(model, tcfg, device="cpu",
                                        return_optimizer=True)
    assert loop.BasisCollector.build(sub, tcfg) is None


def test_collector_refresh_installs_the_basis_in_place():
    _, _, tcfg = _tiny_lm("momentum", "trajectory_pca")
    sub = _sub("momentum")
    col = loop.BasisCollector.build(sub, tcfg)
    assert (col.refresh_every, col.capacity) == (3, 12)
    plan = sub.transform.plan
    state = steplib.TrainState(
        params=torch.linspace(-1, 1, plan.packed().q_packed),
        rbd_state=sub.init_rbd_state(device="cpu"),
        opt_state=sub.init_opt_state(device="cpu"), step=0)
    basis = state.rbd_state.basis
    basis0 = basis.clone()
    rs = np.random.default_rng(2)
    valid = torch.from_numpy(plan.packed().param_valid)
    metrics = {}
    for i in range(3):
        g = torch.from_numpy(rs.standard_normal(valid.shape[0]).astype(
            np.float32)) * valid
        params, rbd_state, opt_state, _ = sub.step(
            state.params, g, state.rbd_state, state.opt_state)
        state = steplib.TrainState(params, rbd_state, opt_state, i + 1)
        state = col.observe(state, metrics, i)
    assert col.refreshes == 1 and col.ring == []
    assert state.rbd_state.basis is basis            # written in place
    assert not torch.equal(basis, basis0)
    np.testing.assert_allclose((basis.double() @ basis.double().T).numpy(),
                               np.eye(basis.shape[0]), atol=1e-4)
    assert bool((state.opt_state == 0).all())        # re-zeroed
    # a non-finite observation never enters the ring
    bad = state._replace(params=torch.full_like(state.params, np.nan))
    col.observe(bad, metrics, 3)
    col.observe(bad, metrics, 4)
    assert col.ring == []


@functools.cache
def _reference_start():
    """The reference's reduced qwen2-0.5b, its initial parameters and its
    initial materialized basis at rbd-dim 40 (the same for both specs:
    one plan, base seed 0)."""
    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    rmodel = ref_model(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    rtcfg = RefTrainConfig(model=rcfg, rbd=RefRBDConfig(
        total_dim=40, backend="jnp", packed="on", basis="trajectory_pca"))
    _, _, r_opt = ref_step.make_train_step(rmodel, rtcfg,
                                           return_optimizer=True)
    return rcfg, rmodel, params, r_opt.init_rbd_state(params)


def run_short_against_reference(basis, optimizer):
    """6 steps of the materialized step and the collector (refresh every
    3) in both packages from the reference's parameters, batches and
    initial basis; checks after every step."""
    rcfg, rmodel, params, rbd0 = _reference_start()
    rtcfg = RefTrainConfig(
        model=rcfg, optimizer=optimizer,
        rbd=RefRBDConfig(total_dim=40, backend="jnp", packed="on",
                         basis=basis, basis_refresh_every=3),
        learning_rate=0.5, steps=6, batch_size=2, seq_len=16)
    _, r_step, r_opt = ref_step.make_train_step(rmodel, rtcfg,
                                                return_optimizer=True)
    rstate = ref_step.TrainState(
        params=r_opt.prepare_params(params), rbd_state=rbd0,
        opt_state=r_opt.init_opt_state(params),
        step=jnp.zeros((), jnp.int32), guard=())
    r_col = ref_loop.BasisCollector.build(r_opt, rtcfg)
    r_step = jax.jit(r_step)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    named = {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}

    cfg, model, tcfg = _tiny_lm(optimizer, basis)
    _, train_step, sub = steplib.make_train_step(
        model, tcfg, device="cpu", return_optimizer=True)
    assert sub.plan_execution() == r_opt.plan_execution()._replace(
        overlap_exchange="none", overlap_reason=sub.plan_execution()
        .overlap_reason)
    port_params = params_from_reference(named, device="cpu")
    state = steplib.TrainState(
        params=sub.prepare_params(port_params),
        rbd_state=rbd_state_from_reference(jax.device_get(rbd0),
                                           device="cpu"),
        opt_state=sub.init_opt_state(port_params), step=0)
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(rstate.params))
    col = loop.BasisCollector.build(sub, tcfg)
    theta0 = np.asarray(rstate.params)
    data = ref_data.lm_batches(0, 2, 16, rcfg.vocab)
    for i in range(6):
        batch = next(data)
        rstate, rmetrics = r_step(rstate, batch)
        rstate = r_col.observe(rstate, rmetrics, i)
        state, metrics = train_step(
            state, {k: torch.from_numpy(np.array(v)).long()
                    for k, v in batch.items()})
        state = col.observe(state, metrics, i)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rmetrics["loss"]), rtol=1e-5)
        want = np.asarray(rstate.params)
        tol = (1e-3 * np.abs(want - theta0).max()
               + 4 * EPS32 * np.abs(want).max())
        np.testing.assert_allclose(state.params.numpy(), want, rtol=0,
                                   atol=tol, err_msg=f"step {i}")
        if basis == "gradient_informed":
            g = np.asarray(rmetrics["basis_grad"])
            np.testing.assert_allclose(
                metrics["basis_grad"].numpy(), g, rtol=0,
                atol=1e-4 * np.abs(g).max())
        else:
            assert "basis_grad" not in metrics
        b_ref = np.asarray(rstate.rbd_state.basis, np.float64)
        b = state.rbd_state.basis.double().numpy()
        sv = np.linalg.svd(b @ b_ref.T, compute_uv=False)
        np.testing.assert_allclose(sv, 1.0, atol=1e-4,
                                   err_msg=f"basis span, step {i}")
    assert col.refreshes == r_col.refreshes == 2


def test_short_run_matches_reference():
    """trajectory_pca + momentum (gradient_informed + lbfgs:
    test_torch_basis_run.py)."""
    run_short_against_reference("trajectory_pca", "momentum")
