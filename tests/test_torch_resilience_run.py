"""Resilience through the port's launcher, and across ranks.

* kill-and-resume through ``launch.train.run_training`` on the reduced
  qwen2-0.5b config (the reference's flagship chaos scenario,
  tests/test_chaos.py:66): a NaN gradient at step 1 (rejected,
  reason-coded, logged as an empty record), a kill before step 4, a
  snapshot every 2 steps and the sentinel every 2; the resumed run's
  theta, optimizer state and guard state bit-identical to the same run
  without the kill, the recovery events reason-coded, the rejected step's
  reason the reference ``loop.train`` run's, the ``resilience:`` and
  ``recovered to step`` lines printed;
* ``CounterStream.skip(n)`` equals n ``next()`` calls;
* the guard's metrics through ``make_train_step``;
* two gloo ranks (``torch.multiprocessing`` spawn, a ``FileStore`` under
  the test's temporary directory) through ``run_training``: the sentinel's
  checksum rides the one all-reduce (one collective a step);
  ``corrupt_collective`` on rank 1 at step 0 makes rank 1 alone reject
  the step, the sentinel fires at step 1 on both ranks, and
  ``on_divergence="fail"`` raises ``ReplicaDivergenceError``; under
  ``"repair"`` both ranks re-broadcast from rank 0, record
  ``REASON_RESYNC`` and end bit-identical;
* the refusal of resilience on a plan that is not the packed two-launch
  step (the model-sharded slabs are tests/test_torch_resilience_slabs.py's).

The spawned ranks import this file, so it imports jax and the reference
package only inside the test that runs the reference.
"""

import datetime
import json
import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import compartments
from repro_torch.core import resilience as res
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.data import synthetic
from repro_torch.launch import train as launcher
from repro_torch.models.registry import get_model
from repro_torch.optim import subspace
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

WORLD = 2
RUN = dict(rbd_dim=256, rbd_backend="cuda", optimizer="momentum", lr=0.5,
           batch=2, seq=16, device="cpu")
CHAOS = res.FaultPlan((res.FaultEvent(1, "nan_grad"),
                       res.FaultEvent(4, "kill")))


def _cfg():
    return get_config("qwen2-0.5b").reduced(compute_dtype="float32")


def _rcfg(directory, fault_plan):
    return res.ResilienceConfig(directory=str(directory), snapshot_every=2,
                                guard=res.GuardConfig(), sentinel_every=2,
                                fault_plan=fault_plan)


def _leaves(tree):
    return res._tree_leaves(tree)


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """The three launcher runs of the kill-and-resume scenario."""
    d = tmp_path_factory.mktemp("chaos")
    ref = launcher.run_training(_cfg(), steps=6, **RUN,
                                resilience=_rcfg(d / "ref",
                                                 CHAOS.without("kill")))
    with pytest.raises(res.SimulatedWorkerKill, match="kills step 4"):
        launcher.run_training(_cfg(), steps=6, **RUN,
                              resilience=_rcfg(d / "run", CHAOS))
    resumed = launcher.run_training(_cfg(), steps=6, **RUN,
                                    resilience=_rcfg(d / "run",
                                                     CHAOS.without("kill")),
                                    resume=True)
    return ref, resumed


def test_kill_and_resume_through_the_launcher_bit_exact(chaos):
    ref, resumed = chaos
    assert ref.state.step == resumed.state.step == 6
    assert torch.equal(ref.state.params, resumed.state.params)
    _assert_states_equal(ref.state.opt_state, resumed.state.opt_state)
    _assert_states_equal(ref.state.guard, resumed.state.guard)
    assert int(resumed.state.guard.nonfinite_count) == 1
    # the newest snapshot (step 4, written after step 3) and nothing to
    # replay; the data stream skipped the 4 consumed batches
    assert resumed.recovery["snapshot_step"] == 4
    assert resumed.recovery["replayed"] == 0
    assert len(resumed.losses) == 2 and ref.losses[4:] == resumed.losses
    for run in (ref, resumed):
        for ev in run.monitor.events:
            assert "unknown" not in res.reason_name(ev.reason)
    assert [(e.step, e.reason) for e in ref.monitor.events] == [
        (1, res.REASON_NONFINITE_LOCAL)]
    assert resumed.monitor.events == []


def test_resume_replays_the_log_past_the_snapshot(tmp_path):
    """Snapshot every 3: the crash before step 4 leaves snapshot 3 and
    record 3 -- recovery replays one record (one apply, no projection)."""
    cfg = dict(snapshot_every=3, guard=res.GuardConfig(), sentinel_every=2)
    ref = launcher.run_training(_cfg(), steps=5, **RUN,
                                resilience=res.ResilienceConfig(
                                    fault_plan=CHAOS.without("kill"), **cfg))
    with pytest.raises(res.SimulatedWorkerKill):
        launcher.run_training(_cfg(), steps=5, **RUN,
                              resilience=res.ResilienceConfig(
                                  directory=str(tmp_path), fault_plan=CHAOS,
                                  **cfg))
    resumed = launcher.run_training(
        _cfg(), steps=5, **RUN, resume=True,
        resilience=res.ResilienceConfig(directory=str(tmp_path),
                                        fault_plan=CHAOS.without("kill"),
                                        **cfg))
    assert (resumed.recovery["snapshot_step"],
            resumed.recovery["replayed"]) == (3, 1)
    assert resumed.recovery["launches"]["project_packed"] == 0
    assert torch.equal(ref.state.params, resumed.state.params)
    _assert_states_equal(ref.state.opt_state, resumed.state.opt_state)
    _assert_states_equal(ref.state.guard, resumed.state.guard)


def test_rejected_step_reason_is_the_reference_loops(chaos, tmp_path):
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import RBDConfig as RefRBD
    from repro.configs.base import TrainConfig as RefTrain
    from repro.core import resilience as ref_res
    from repro.data import synthetic as ref_synthetic
    from repro.models import get_model as ref_get_model
    from repro.train import loop

    cfg = ref_get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tcfg = RefTrain(model=cfg, optimizer="momentum",
                    rbd=RefRBD(total_dim=256, backend="jnp", packed="on"),
                    learning_rate=0.5, steps=6, batch_size=2, seq_len=16)
    plan = ref_res.FaultPlan((ref_res.FaultEvent(1, "nan_grad"),))
    _, _, mon = loop.train(
        ref_get_model(cfg), tcfg,
        ref_synthetic.lm_batches(0, 2, 16, cfg.vocab),
        resilience=ref_res.ResilienceConfig(
            directory=str(tmp_path), snapshot_every=2,
            guard=ref_res.GuardConfig(), sentinel_every=2, fault_plan=plan),
        verbose=False)
    ref, _ = chaos
    assert [(e.step, e.reason) for e in ref.monitor.events] == \
        [(e.step, e.reason) for e in mon.events]


def test_launcher_prints_the_resilience_lines(tmp_path, capsys):
    args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--rbd-backend", "cuda", "--rbd-dim", "128", "--batch", "2",
            "--seq", "8", "--guard", "--sentinel-every", "2",
            "--resilience-dir", str(tmp_path / "res"), "--snapshot-every",
            "1"]
    launcher.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert ("resilience: guard=on sentinel_every=2 replay_log=on "
            "snapshot_every=1 on_divergence=fail") in out
    res_run = launcher.main(args + ["--steps", "3", "--resume",
                                    "--checkpoint-dir",
                                    str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "recovered to step 2 (snapshot 2, replayed 0 records)" in out
    assert "checkpoint saved to" in out and res_run.state.step == 3
    # --checkpoint-dir keeps the parameters as the reference's tree
    meta = json.load(open(tmp_path / "ckpt" / "ckpt_00000003.json"))
    assert ".params::embed" in meta["keys"]
    assert ".guard::.lr_scale" in meta["keys"]


def test_counter_stream_skip_equals_next_calls():
    a = synthetic.lm_batches(3, 2, 8, 64, device="cpu")
    b = synthetic.lm_batches(3, 2, 8, 64, device="cpu")
    for _ in range(5):
        next(a)
    assert b.skip(5) is b and b.step == a.step == 5
    x, y = next(a), next(b)
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert res.skip_batches(b, 0) is b and b.step == 6
    with pytest.raises(ValueError, match="< 0"):
        b.skip(-1)


def test_guard_metrics_surface_through_train_step():
    cfg = _cfg()
    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, optimizer="momentum",
                       rbd=RBDConfig(total_dim=128, backend="cuda"),
                       learning_rate=0.5, steps=1, batch_size=2, seq_len=16)
    batch = next(synthetic.lm_batches(0, 2, 16, cfg.vocab, device="cpu"))
    init_p, step_p = steplib.make_train_step(model, tcfg, device="cpu")
    state_p = init_p(0)
    assert state_p.guard == ()
    init_g, step_g = steplib.make_train_step(
        model, tcfg, device="cpu",
        resilience=res.ResilienceConfig(guard=res.GuardConfig()))
    state_g = init_g(0)
    assert isinstance(state_g.guard, res.GuardState)
    state_g, metrics = step_g(state_g, batch)
    assert int(metrics["guard_reason"]) == res.REASON_OK
    assert float(metrics["guard_lr_scale"]) == 1.0
    assert int(metrics["guard_count"]) == 0
    assert "replay_coords" not in metrics
    state_p, metrics_p = step_p(state_p, batch)
    assert "guard_reason" not in metrics_p
    assert torch.equal(state_g.params, state_p.params)


def test_resilience_needs_the_packed_two_launch_step():
    plan = compartments.make_plan(
        {"w": (48, 20), "s": ()}, 16, normalization="orthonormal")
    sub = subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=1, backend="cuda"),
        use_packed=True, optimizer="momentum", guard=res.GuardConfig())
    assert sub.plan_execution().strategy != "fused_packed"
    params = {"w": torch.ones(48, 20), "s": torch.ones(())}
    with pytest.raises(ValueError, match="packed two-launch"):
        sub.step(params, params, sub.init_rbd_state(), (), ())
    with pytest.raises(ValueError, match="packed two-launch"):
        launcher.run_training(_cfg(), steps=1, **dict(RUN, rbd_backend="torch"),
                              resilience=res.ResilienceConfig(
                                  guard=res.GuardConfig()))


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------


def _rank_run(rank, on_divergence, fault_plan, steps=3):
    rcfg = res.ResilienceConfig(guard=res.GuardConfig(), sentinel_every=1,
                                on_divergence=on_divergence,
                                fault_plan=fault_plan)
    try:
        out = launcher.run_training(_cfg(), data=WORLD, steps=steps,
                                    **dict(RUN, batch=4), resilience=rcfg)
    except res.ReplicaDivergenceError as e:
        return {"raised": str(e)}
    return {"theta": out.state.params, "opt": out.state.opt_state,
            "guard": tuple(out.state.guard), "collectives": out.collectives,
            "events": [tuple(e) for e in out.monitor.events]}


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        corrupt = res.FaultPlan.single(0, "corrupt_collective", worker=1)
        out = {"healthy": _rank_run(rank, "fail", None),
               "fail": _rank_run(rank, "fail", corrupt),
               "repair": _rank_run(rank, "repair", corrupt)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo_res")
    ctx = mp.start_processes(_rank_main, args=(str(d / "store"), str(d)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError("the gloo ranks did not finish in 300 s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_rider_keeps_one_collective_a_step(ranks):
    for r in range(WORLD):
        h = ranks[r]["healthy"]
        assert h["collectives"]["all_reduce"] == 3
        assert h["collectives"]["all_gather"] == 0
        assert h["collectives"]["resync"] == 0
        assert h["events"] == []
    assert torch.equal(ranks[0]["healthy"]["theta"],
                       ranks[1]["healthy"]["theta"])


def test_corrupted_exchange_trips_the_sentinel(ranks):
    for r in range(WORLD):
        assert "replica divergence detected at step 1" in \
            ranks[r]["fail"]["raised"]


def test_repair_resyncs_the_ranks(ranks):
    a, b = ranks[0]["repair"], ranks[1]["repair"]
    assert torch.equal(a["theta"], b["theta"])
    _assert_states_equal(a["opt"], b["opt"])
    _assert_states_equal(a["guard"], b["guard"])
    # rank 1 alone rejected step 0; both saw the divergence at step 1 and
    # re-broadcast the state (params, momentum, the guard's 3 scalars)
    assert (0, res.REASON_NONFINITE_EXCHANGE) in \
        [ev[:2] for ev in b["events"]]
    for run in (a, b):
        reasons = [ev[:2] for ev in run["events"]]
        assert (1, res.REASON_REPLICA_DIVERGENCE) in reasons
        assert (1, res.REASON_RESYNC) in reasons
        assert run["collectives"]["resync"] == 5
        assert run["collectives"]["all_reduce"] == 3
