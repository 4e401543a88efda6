"""Resilience on the model-sharded slabs: the guard, the sentinel, the
replay log, snapshots and fault injection on the slab step, over gloo
ranks (``torch.multiprocessing`` spawn, a ``FileStore`` under the test's
temporary directory) through the launcher's ``run_training`` on reduced
qwen2-0.5b in f32 (rbd-dim 64, seq 8, the packed kernels' plain versions).

Two worlds, spawned together, each running its scenarios in turn:

* data 1 x model 2, the guard with a NaN gradient at step 1, sgd and
  adam: the reason codes and losses those of the port's unsharded guarded
  run in this process, the replay log's coordinates within 1e-5 of its
  largest, theta within rtol 1e-4, atol 1e-5 x (max|theta| + 1) (the
  tolerance of test_torch_sharded_ranks.py), the padding exactly 0;
  killed before step 4 and resumed: the slabs bit for bit the
  uninterrupted run's, one writer, the snapshot's ``params`` the
  (q_padded,) buffer under the unsharded snapshot's keys, two
  kernel-wrapper calls, one model-group all-reduce and one data exchange
  a live step, one slab apply a replayed record; ``step_shards_in_turn``
  in this process bit for bit the ranks;
* data 2 x model 2: independent bases under the guard against the
  unsharded data-2 run of the first world; a divergence planted in one
  slab of one data rank, under ``repair`` and under ``fail``: all four
  ranks detect it at the same step and resync, or all four raise; a
  ``corrupt_collective`` event on data rank 1.

The spawned ranks import this file, so it imports neither jax nor the
reference package.
"""

import contextlib
import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import distributed
from repro_torch.core import resilience as res
from repro_torch.data import synthetic
from repro_torch.kernels import rbd_step
from repro_torch.launch import train as launcher
from repro_torch.models.registry import get_model
from repro_torch.train import step as steplib

torch.set_num_threads(1)

STEPS = 5
RUN = dict(rbd_dim=64, seq=8, rbd_backend="cuda", device="cpu")
LR = {"sgd": 0.5, "adam": 0.02}
NAN = res.FaultEvent(1, "nan_grad")
KILL = res.FaultEvent(4, "kill")
PLANT = (3, 1)            # (global rank, step): data 1, model 1
SPAWN_TIMEOUT_S = 240     # both worlds, scenarios in turn; gloo's own 120


def _cfg():
    return get_config("qwen2-0.5b").reduced(compute_dtype="float32")


def _rcfg(directory=None, faults=(NAN,), sentinel_every=2,
          on_divergence="fail"):
    return res.ResilienceConfig(
        directory=None if directory is None else str(directory),
        snapshot_every=3, guard=res.GuardConfig(),
        sentinel_every=sentinel_every, on_divergence=on_divergence,
        fault_plan=res.FaultPlan(tuple(faults)))


def _run(rcfg, *, optimizer="sgd", steps=STEPS, resume=False, **kw):
    """One launcher run; what the tests read of it."""
    rbd_step.reset_counts()
    try:
        out = launcher.run_training(
            _cfg(), **{**RUN, "lr": LR[optimizer], "batch": 2, **kw},
            optimizer=optimizer, steps=steps, resilience=rcfg,
            resume=resume)
    except (res.ReplicaDivergenceError, res.SimulatedWorkerKill) as e:
        return {"raised": f"{type(e).__name__}: {e}"}
    return {"params": out.state.params.detach().clone(),
            "losses": out.losses, "collectives": out.collectives,
            "snapshot_gathers": distributed.SNAPSHOT_COLLECTIVES["all_gather"],
            "calls": {k: v for k, v in rbd_step.CALLS.items() if v},
            "events": [tuple(e)[:2] for e in out.monitor.events],
            "writer": out.monitor.writer,
            "recovery": (None if out.recovery is None else
                         {k: out.recovery[k]
                          for k in ("snapshot_step", "replayed")}),
            "q_packed": out.sub_opt.transform.plan.packed().q_packed,
            "q_padded": (out.sub_opt.sharded_layout().q_padded
                         if out.sub_opt.model_axis is not None else None)}


@contextlib.contextmanager
def _planted(rank, step):
    """The launcher's train step, with ``rank``'s slab scaled by 1 +
    2**-10 just before step ``step``: a divergence in one slab of one data
    rank."""
    make = steplib.make_train_step

    def planted_make(*args, **kwargs):
        init, train_step, *rest = make(*args, **kwargs)

        def train_planted(state, batch):
            if dist.get_rank() == rank and state.step == step:
                with torch.no_grad():
                    state.params.mul_(1.0 + 2.0 ** -10)
            return train_step(state, batch)

        return (init, train_planted, *rest)

    steplib.make_train_step = planted_make
    try:
        yield
    finally:
        steplib.make_train_step = make


def _world2(d):
    out = {}
    for opt in ("sgd", "adam"):
        out[opt] = _run(_rcfg(d / f"pair-{opt}"), optimizer=opt, model=2)
    out["killed"] = _run(_rcfg(d / "kill", (NAN, KILL)), optimizer="adam",
                         model=2)
    out["resumed"] = _run(_rcfg(d / "kill"), optimizer="adam", model=2,
                          resume=True)
    out["data2-independent"] = _run(
        _rcfg(), data=2, batch=4, steps=3, rbd_mode="independent_bases",
        normalization="exact")
    return out


def _world4(d):
    grid = dict(data=2, model=2, batch=4, steps=3)
    out = {"independent": _run(_rcfg(), rbd_mode="independent_bases",
                               normalization="exact", **grid)}
    for mode in ("repair", "fail"):
        with _planted(*PLANT):
            out[f"plant-{mode}"] = _run(
                _rcfg(faults=(), sentinel_every=1, on_divergence=mode),
                **grid)
    out["corrupt"] = _run(
        _rcfg(faults=(res.FaultEvent(0, "corrupt_collective", 1),),
              sentinel_every=1, on_divergence="repair"), **grid)
    return out


def _rank_main(rank, world, store_path, out_dir):
    import pathlib

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        d = pathlib.Path(out_dir)
        out = _world2(d) if world == 2 else _world4(d)
        torch.save(out, d / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    dirs, ctxs = {}, {}
    for world in (2, 4):
        d = dirs[world] = tmp_path_factory.mktemp(f"slabs{world}")
        ctxs[world] = mp.start_processes(
            _rank_main, args=(world, str(d / "store"), str(d)),
            nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for world, ctx in ctxs.items():
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for c in ctxs.values():
                    for p in c.processes:
                        p.terminate()
                raise TimeoutError(f"the {world} gloo ranks did not finish "
                                   f"in {SPAWN_TIMEOUT_S} s")
    return {w: ([torch.load(dirs[w] / f"rank{r}.pt", weights_only=False)
                 for r in range(w)], dirs[w]) for w in (2, 4)}


def _gathered(results, name, group):
    full = torch.cat([results[r][name]["params"] for r in group]).numpy()
    q = results[group[0]][name]["q_packed"]
    return full[:q], full[q:]


def _assert_theta_close(got, want):
    scale = float(np.abs(want).max()) + 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def _log(directory):
    _, records, truncated = res.ReplayLog.read(
        os.path.join(directory, "replay.log"))
    assert not truncated
    return records


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_guarded_slabs_match_the_unsharded_guarded_run(worlds, optimizer,
                                                       tmp_path):
    ranks, d = worlds[2]
    want = _run(_rcfg(tmp_path), optimizer=optimizer)
    got, tail = _gathered(ranks, optimizer, [0, 1])
    _assert_theta_close(got, want["params"].numpy())
    assert (tail == 0).all()
    for r in (0, 1):
        run = ranks[r][optimizer]
        assert run["events"] == want["events"] == [
            (1, res.REASON_NONFINITE_LOCAL)]
        np.testing.assert_allclose(run["losses"], want["losses"], rtol=1e-5)
    mine, theirs = _log(d / f"pair-{optimizer}"), _log(tmp_path)
    assert [(r.step, r.reason) for r in mine] == \
        [(r.step, r.reason) for r in theirs] == \
        [(i, res.REASON_NONFINITE_LOCAL if i == 1 else res.REASON_OK)
         for i in range(STEPS)]
    for a, b in zip(mine, theirs):
        if b.coords is None:
            assert a.coords is None
            continue
        np.testing.assert_allclose(a.coords, b.coords, rtol=0,
                                   atol=1e-5 * float(np.abs(b.coords).max()))


def test_kill_and_resume_on_the_slabs_is_bit_exact(worlds, tmp_path):
    ranks, d = worlds[2]
    assert [ranks[r]["adam"]["writer"] for r in (0, 1)] == [True, False]
    for r in (0, 1):
        straight, resumed = ranks[r]["adam"], ranks[r]["resumed"]
        assert "kill" in ranks[r]["killed"]["raised"]
        assert resumed["recovery"] == {"snapshot_step": 3, "replayed": 1}
        assert torch.equal(resumed["params"], straight["params"])
        # a live step: two wrapper calls, one completion, one exchange
        assert straight["calls"] == {"project_packed_sharded": STEPS,
                                     "reconstruct_apply_packed_sharded":
                                         STEPS}
        assert straight["collectives"]["model_all_reduce"] == STEPS
        assert straight["collectives"]["all_reduce"] == STEPS
        assert straight["snapshot_gathers"] == 1
        # the resumed run: the replayed record is one slab apply
        assert resumed["calls"] == {"project_packed_sharded": 1,
                                    "reconstruct_apply_packed_sharded": 2}
        assert resumed["collectives"]["model_all_reduce"] == 1
        assert resumed["collectives"]["all_reduce"] == 1
    # the snapshot: the whole padded buffer under the unsharded keys
    _run(_rcfg(tmp_path), optimizer="adam", steps=3)
    sharded = np.load(d / "kill" / "snapshots" / "ckpt_00000003.npz")
    plain = np.load(tmp_path / "snapshots" / "ckpt_00000003.npz")
    assert sorted(sharded.files) == sorted(plain.files)
    assert sharded[".params"].shape == (ranks[0]["adam"]["q_padded"],)
    full = torch.cat([ranks[0]["adam"]["params"],
                      ranks[1]["adam"]["params"]])
    assert full.shape == sharded[".params"].shape
    assert sorted(os.listdir(d / "kill" / "snapshots")) == [
        "ckpt_00000003.json", "ckpt_00000003.npz"]


def test_shards_in_turn_equal_the_ranks(worlds):
    """``step_shards_in_turn`` with the guard, the fault plan and the
    sentinel, in one process: the slabs of the 2-rank run bit for bit."""
    ranks, _ = worlds[2]
    cfg = _cfg()
    net = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=64,
                                                backend="cuda"),
                       learning_rate=LR["sgd"], optimizer="sgd",
                       steps=STEPS, batch_size=2, seq_len=8)
    sub = dataclasses.replace(steplib.make_subspace_optimizer(
        net, tcfg, model_sharded=True, model_axis="model", model_shards=2,
        device="cpu", resilience=_rcfg(sentinel_every=1)),
        capture_coords=True)
    loss_fn = steplib.make_loss_fn(net, cfg.router_aux_coef)
    padded = sub.padded_params(net.init(tcfg.seed, device="cpu"))
    slabs = [sub.slab_of(padded, s).clone() for s in range(2)]
    rbd, opt, guard = (sub.init_rbd_state(), sub.init_opt_state(
        device="cpu"), res.guard_init())
    stream = synthetic.lm_batches(tcfg.seed, 2, 8, cfg.vocab, device="cpu")
    reasons = []
    for _ in range(STEPS):
        full = torch.cat(slabs).requires_grad_(True)
        loss, _ = loss_fn(sub.materialize_params(full), next(stream))
        (g,) = torch.autograd.grad(loss, full)
        rbd_step.reset_counts()
        with torch.no_grad():
            slabs, rbd, opt, aux = sub.step_shards_in_turn(
                slabs, [sub.slab_of(g, s) for s in range(2)], rbd, opt,
                guard)
        assert rbd_step.CALLS["project_packed_sharded"] == 2
        assert rbd_step.CALLS["reconstruct_apply_packed_sharded"] == 2
        guard = aux.guard
        reasons.append(int(aux.reason))
        assert not bool(aux.diverged)
        assert aux.coords.shape == (sub.transform.plan.packed().d_packed,)
    assert reasons == [0, res.REASON_NONFINITE_LOCAL, 0, 0, 0]
    assert int(guard.nonfinite_count) == 1
    for r in (0, 1):
        assert torch.equal(slabs[r], ranks[r]["sgd"]["params"])


def test_sentinel_words_fold_the_unsharded_rider():
    """The slab rule: the m slabs' words, summed, fold to the rider of the
    whole buffer (sgd) or of the replicated state (adam), and a one-ulp
    flip in one slab changes the fold."""
    from repro_torch.optim.transforms import AdamState

    rs = np.random.default_rng(3)
    full = torch.from_numpy(rs.standard_normal(1000).astype(np.float32))
    adam = AdamState(count=torch.tensor(3, dtype=torch.int32),
                     mu=torch.from_numpy(rs.standard_normal(16).astype(
                         np.float32)),
                     nu=torch.from_numpy(rs.random(16).astype(np.float32)))
    for m in (2, 3, 4):
        padded = torch.cat([full, full.new_zeros((-len(full)) % m)])
        slabs = list(padded.view(m, -1))
        for state in ((), adam):
            words = sum(res.sentinel_words(state, s) for s in slabs)
            assert float(res.sentinel_rider_of_words(words, m, state)) == \
                float(res.sentinel_rider(state, full))
        flipped = [s.clone() for s in slabs]
        flipped[-1].view(torch.int32)[0] ^= 1
        words = sum(res.sentinel_words((), s) for s in flipped)
        assert float(res.sentinel_rider_of_words(words, m, ())) != \
            float(res.sentinel_rider((), full))


def test_two_by_two_independent_bases_under_the_guard(worlds):
    """Each data rank's model group concatenates to the unsharded data-2
    run's theta; the reasons by data index are that run's."""
    four, _ = worlds[4]
    pair, _ = worlds[2]
    for d_idx, group in enumerate(([0, 1], [2, 3])):
        want = pair[0 + d_idx]["data2-independent"]
        got, tail = _gathered(four, "independent", group)
        _assert_theta_close(got, want["params"].numpy())
        assert (tail == 0).all()
        for r in group:
            assert four[r]["independent"]["events"] == want["events"]
            assert four[r]["independent"]["calls"][
                "reconstruct_apply_packed_workers_sharded"] == 3
    assert four[0]["independent"]["events"] == [
        (1, res.REASON_NONFINITE_LOCAL)]
    assert four[2]["independent"]["events"] == [
        (1, res.REASON_NONFINITE_EXCHANGE)]


def _assert_resynced(four, name):
    for r in range(4):
        assert "raised" not in four[r][name], four[r][name]
        assert (1, res.REASON_REPLICA_DIVERGENCE) in four[r][name]["events"]
        assert (1, res.REASON_RESYNC) in four[r][name]["events"]
        assert four[r][name]["collectives"]["model_all_reduce"] == 3
        assert four[r][name]["collectives"]["all_reduce"] == 3
    # the data groups (0, 2) and (1, 3) agree again, bit for bit
    for a, b in ((0, 2), (1, 3)):
        assert torch.equal(four[a][name]["params"], four[b][name]["params"])


def test_planted_slab_divergence_repaired_on_every_rank(worlds):
    four, _ = worlds[4]
    _assert_resynced(four, "plant-repair")


def test_planted_slab_divergence_raises_on_every_rank(worlds):
    four, _ = worlds[4]
    for r in range(4):
        assert "replica divergence detected at step 1" in \
            four[r]["plant-fail"]["raised"]


def test_corrupt_collective_on_a_data_rank_of_the_slabs(worlds):
    four, _ = worlds[4]
    for r in (2, 3):
        assert (0, res.REASON_NONFINITE_EXCHANGE) in \
            four[r]["corrupt"]["events"]
    for r in (0, 1):
        assert (0, res.REASON_NONFINITE_EXCHANGE) not in \
            four[r]["corrupt"]["events"]
    _assert_resynced(four, "corrupt")
