"""Port parity of the whole slice: three ``fused_packed`` steps of the
port against ``repro.train.step.make_train_step`` (jnp backend, packed,
``axis_name=None``) on the reduced qwen2-0.5b with the reference's
parameters and batches; the plan catalog; launch accounting; and that
entry points refuse to run on the CPU unasked.

Tolerances after each step: loss rtol 1e-5 (float32 forward in another
summation order); theta within 1e-3 * max|theta_t - theta_0| + 4 ulp of
max|theta| -- the coordinates inherit the gradient's relative error
(about 1e-5, test_torch_model.py), adam's normalization amplifies small
coordinates' relative error, and the differences compound over steps.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import compartments as ref_comp
from repro.data import synthetic as ref_data
from repro.models import get_model as ref_model
from repro.optim import subspace as ref_subspace
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.data import synthetic
from repro_torch.kernels import rbd_step
from repro_torch.launch import train as launcher
from repro_torch.models.registry import get_model, params_from_reference
from repro_torch.optim import subspace
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

EPS32 = 2.0 ** -23
# the stateful optimizers run in tests/test_torch_steps.py (one reference
# compile each, about 11 s, so the files stay balanced across workers)
OPTIMIZERS = [("sgd", 0.5)]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


@pytest.mark.parametrize("optimizer,lr", OPTIMIZERS)
def test_three_fused_packed_steps_match_reference(optimizer, lr):
    run_three_steps_against_reference(optimizer, lr)


def run_three_steps_against_reference(optimizer, lr, prng="threefry"):
    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    rmodel = ref_model(rcfg)
    rtcfg = RefTrainConfig(model=rcfg, rbd=RefRBDConfig(
        total_dim=128, backend="jnp", packed="on", prng_impl=prng),
        learning_rate=lr, optimizer=optimizer)
    r_init, r_step, r_opt = ref_step.make_train_step(
        rmodel, rtcfg, return_optimizer=True)
    assert r_opt.plan_execution().strategy == "fused_packed"
    r_step = jax.jit(r_step)
    rstate = r_init(jax.random.PRNGKey(0))
    params = rmodel.init(jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    named = {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=128,
                                                backend="cuda",
                                                prng_impl=prng),
                       learning_rate=lr, optimizer=optimizer)
    init_state, train_step, sub_opt = steplib.make_train_step(
        get_model(cfg), tcfg, device="cpu", return_optimizer=True)
    assert sub_opt.plan_execution() == r_opt.plan_execution()._replace(
        overlap_exchange=sub_opt.plan_execution().overlap_exchange,
        overlap_reason=sub_opt.plan_execution().overlap_reason)
    state = init_state(params=params_from_reference(named, device="cpu"))
    theta0 = np.asarray(rstate.params)
    np.testing.assert_array_equal(state.params.numpy(), theta0)

    data = ref_data.lm_batches(0, 2, 16, rcfg.vocab)
    rbd_step.reset_counts()
    for i in range(3):
        batch = next(data)
        rstate, rmetrics = r_step(rstate, batch)
        state, metrics = train_step(state, _torch_batch(batch))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rmetrics["loss"]), rtol=1e-5)
        want = np.asarray(rstate.params)
        tol = (1e-3 * np.abs(want - theta0).max()
               + 4 * EPS32 * np.abs(want).max())
        np.testing.assert_allclose(state.params.numpy(), want, rtol=0,
                                   atol=tol, err_msg=f"step {i}")
        np.testing.assert_allclose(float(metrics["update_norm"]),
                                   float(rmetrics["update_norm"]),
                                   rtol=1e-3)
    # two kernel-wrapper calls per step; on the CPU none of them launches
    assert rbd_step.CALLS["project_packed"] == 3
    assert rbd_step.CALLS["reconstruct_apply_packed"] == 3
    assert sum(rbd_step.LAUNCHES.values()) == 0


FLAG_CASES = [
    dict(use_packed=True),
    dict(use_packed=True, normalization="exact"),
    dict(use_packed=True, normalization="none", optimizer="adam"),
    dict(use_packed=True, axis_name="data"),
    dict(use_packed=True, axis_name="data", overlap="off"),
    dict(use_packed=True, prng_impl="hw"),
    dict(use_packed=True, model_sharded=True),
    dict(use_packed=False),
    dict(use_packed=True, normalization="orthonormal"),
    dict(use_packed=True, mode="independent_bases", axis_name="data"),
    dict(use_packed=True, basis="trajectory_pca"),
    dict(rbd_enabled=False),
]


@pytest.mark.parametrize("flags", FLAG_CASES,
                         ids=[str(i) for i in range(len(FLAG_CASES))])
@pytest.mark.parametrize("backend", ["kernels", "plain"])
def test_plan_from_flags_same_strategy_and_reasons(flags, backend):
    port = subspace.plan_from_flags(
        backend={"kernels": "cuda", "plain": "torch"}[backend], **flags)
    ref = ref_subspace.plan_from_flags(
        backend={"kernels": "pallas", "plain": "jnp"}[backend], **flags)

    assert port == ref


def test_unported_routes_raise_naming_roadmap():
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    # pjit-style parameter sharding (model-sharded parameters without a
    # declared model axis) plans the reference's fused_per_leaf with its
    # reason, and runs: the optimizer and the launcher's --mode pjit
    sub = steplib.make_subspace_optimizer(model, TrainConfig(
        model=cfg, rbd=RBDConfig(total_dim=64, backend="cuda")))
    eplan = dataclasses.replace(sub, model_sharded=True).check_supported()
    want = ref_subspace.plan_from_flags(use_packed=True, backend="pallas",
                                        model_sharded=True)
    assert (eplan.strategy, eplan.reason) == ("fused_per_leaf", want.reason)
    res = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--mode",
                         "pjit", "--device", "cpu", "--rbd-backend", "cuda",
                         "--rbd-dim", "32", "--batch", "2", "--seq", "8",
                         "--steps", "1"])
    assert res.sub_opt.plan_execution()[:3] == want[:3]
    assert len(res.losses) == 1 and np.isfinite(res.losses[0])
    # several ranks come from torchrun, which sets the world size
    with pytest.raises(ValueError, match="world size"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--data", "2",
                       "--device", "cpu", "--rbd-backend", "cuda"])


def test_launcher_cpu_two_calls_per_step(capsys):
    rbd_step.reset_counts()
    res = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--mode",
                         "sharedseed", "--data", "1", "--rbd-backend",
                         "cuda", "--rbd-dim", "64", "--batch", "2", "--seq",
                         "8", "--steps", "2", "--lr", "0.5", "--device",
                         "cpu"])
    out = capsys.readouterr().out
    assert "update path: fused_packed -- packed two-launch step" in out
    assert "step 1 loss=" in out
    assert rbd_step.CALLS["project_packed"] == 2
    assert rbd_step.CALLS["reconstruct_apply_packed"] == 2
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert float(res.state.params.double().sum()) != res.theta_init_sum


@pytest.mark.parametrize("rbd_mode,norm", [("shared_basis", "rsqrt_dim"),
                                           ("independent_bases", "exact")])
def test_launcher_prints_the_references_plan_block(capsys, rbd_mode, norm):
    """``--mode sharedseed --data 1`` exchanges over a one-rank data group,
    as the reference's shard_map over one device does, so the printed
    plan block -- exchange schedule included -- is the reference's
    (its launcher passes axis_name="data", k_workers=data)."""
    res = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--data", "1",
                         "--rbd-mode", rbd_mode, "--normalization", norm,
                         "--rbd-backend", "cuda", "--rbd-dim", "64",
                         "--batch", "2", "--seq", "8", "--steps", "1",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    ref = ref_subspace.plan_from_flags(
        use_packed=True, normalization=norm, backend="pallas",
        mode=rbd_mode, axis_name="data", k_workers=1)
    for line in (f"update path: {ref.strategy} -- {ref.reason}",
                 f"basis: {ref.basis} -- {ref.basis_reason}",
                 f"prng impl: {ref.prng_impl} -- {ref.prng_reason}",
                 f"exchange schedule: {ref.overlap_exchange} -- "
                 f"{ref.overlap_reason}"):
        assert line in out.splitlines()
    kind = "all_gather" if rbd_mode == "independent_bases" else "all_reduce"
    assert res.collectives[kind] == 1


def test_entry_points_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=64,
                                                backend="cuda"))
    for call in (lambda: model.init(0),
                 lambda: steplib.make_train_step(model, tcfg),
                 lambda: synthetic.lm_batches(0, 2, 8, cfg.vocab),
                 lambda: params_from_reference({"a": np.zeros(2)}),
                 lambda: launcher.main(["--arch", "qwen2-0.5b",
                                        "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("redraw,steps_fpd", [(True, 0), (False, 0),
                                              (True, 3)])
def test_step_seed_schedule_matches_reference(redraw, steps_fpd):
    """RBD redraw, FPD and the FPD -> RBD switch give the reference's
    per-step seeds bit for bit."""
    from repro.core.rbd import RandomBasesTransform as RefTransform
    from repro_torch.core import rng
    from repro_torch.core.rbd import RandomBasesTransform

    ref = RefTransform(plan=None, base_seed=7, redraw=redraw,
                       steps_fpd=steps_fpd)
    port = RandomBasesTransform(plan=None, base_seed=7, redraw=redraw,
                                steps_fpd=steps_fpd)
    for step in range(6):
        assert int(np.asarray(ref.step_seed(np.uint32(step)))) == int(
            rng.to_uint32(port.step_seed(step)))


@pytest.mark.parametrize("policy", ["reset", "carry"])
def test_fpd_switch_policy(policy):
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    rbd = RBDConfig(total_dim=64, backend="cuda", steps_fpd=2,
                    switch_policy=policy)
    sub = steplib.make_subspace_optimizer(
        model, TrainConfig(model=cfg, rbd=rbd, optimizer="momentum"))
    state = torch.ones(sub.transform.plan.packed().d_packed)
    assert torch.equal(sub._switch_opt_state(state, 1), state)
    switched = sub._switch_opt_state(state, 2)
    assert torch.equal(switched, torch.zeros_like(state) if policy == "reset"
                       else state)


def test_apply_updates_rounds_once_like_reference():
    """bf16 parameters: subtract in float32, round once (the reference's
    contract); float32 parameters unchanged in dtype."""
    import jax.numpy as jnp

    from repro.optim import transforms as ref_opt
    from repro_torch.optim import transforms as opt

    rs = np.random.default_rng(0)
    p = rs.standard_normal(257).astype(np.float32)
    u = (rs.standard_normal(257) * 1e-3).astype(np.float32)
    want = ref_opt.apply_updates([jnp.asarray(p, jnp.bfloat16),
                                  jnp.asarray(p)], [jnp.asarray(u)] * 2,
                                 0.3)
    got = opt.apply_updates([torch.from_numpy(p).to(torch.bfloat16),
                             torch.from_numpy(p)], [torch.from_numpy(u)] * 2,
                            0.3)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(
        got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(float(opt.global_norm(got)),
                               float(ref_opt.global_norm(want)), rtol=1e-6)


def test_default_backend_runs_the_kernels_on_a_card():
    """``--rbd-backend auto`` (the default) is ``cuda`` for a card device
    and ``torch`` for the CPU; an explicit backend is kept."""
    assert launcher.resolve_backend("auto", "cuda") == "cuda"
    assert launcher.resolve_backend("auto", torch.device("cuda", 1)) == "cuda"
    assert launcher.resolve_backend("auto", "cpu") == "torch"
    assert launcher.resolve_backend("torch", "cuda") == "torch"
    assert launcher.resolve_backend("cuda", "cpu") == "cuda"
    sig = launcher.run_training.__kwdefaults__
    assert sig["rbd_backend"] == "auto" and sig["device"] == "cuda"


def test_sgd_baseline_on_one_rank_issues_no_collective():
    """``--mode sgd --data 1`` runs with axis_name=None, as the
    reference's launcher does: no gradient all-reduce, no loss mean."""
    res = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--mode", "sgd",
                         "--data", "1", "--batch", "2", "--seq", "8",
                         "--steps", "2", "--device", "cpu"])
    assert res.sub_opt.axis_name is None
    assert res.collectives == dict.fromkeys(res.collectives, 0)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))


def test_model_flag_needs_the_world_size():
    with pytest.raises(ValueError, match="world size"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--model", "2",
                       "--device", "cpu", "--rbd-backend", "cuda"])


def _direct_theta(**opt):
    """Two steps from a TrainConfig built directly (no launcher), on the
    launcher's seed, batches and plan."""
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=64,
                                                backend="cuda"),
                       learning_rate=0.02, batch_size=2, seq_len=8, **opt)
    init_state, train_step = steplib.make_train_step(get_model(cfg), tcfg,
                                                     device="cpu")
    state = init_state(tcfg.seed)
    data = synthetic.lm_batches(tcfg.seed, 2, 8, cfg.vocab, device="cpu")
    for _ in range(2):
        state, _ = train_step(state, next(data))
    return state.params


@pytest.mark.parametrize("flags,opt", [
    (["--optimizer", "momentum", "--nesterov", "--momentum-beta", "0.8"],
     dict(optimizer="momentum", nesterov=True, momentum_beta=0.8)),
    (["--optimizer", "adam", "--adam-b1", "0.8", "--adam-b2", "0.99",
      "--adam-eps", "1e-6"],
     dict(optimizer="adam", adam_b1=0.8, adam_b2=0.99, adam_eps=1e-6)),
], ids=["momentum", "adam"])
def test_launcher_optimizer_flags_reach_train_config(flags, opt):
    """The reference's --momentum-beta/--nesterov/--adam-b1/--adam-b2/
    --adam-eps reach TrainConfig: two launcher steps give the theta of a
    TrainConfig built with those values, and another theta without
    them."""
    base = ["--arch", "qwen2-0.5b", "--reduced", "--rbd-backend", "cuda",
            "--rbd-dim", "64", "--batch", "2", "--seq", "8", "--steps", "2",
            "--lr", "0.02", "--device", "cpu"]
    res = launcher.main(base + flags)
    assert torch.equal(res.state.params, _direct_theta(**opt))
    plain = launcher.main(base + flags[:2])
    assert not torch.equal(res.state.params, plain.state.params)
