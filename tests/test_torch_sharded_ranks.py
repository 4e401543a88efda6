"""The model-sharded packed step over real process groups: gloo ranks
(``torch.multiprocessing`` spawn, a ``FileStore`` under the test's
temporary directory), each running the launcher's ``run_training`` on
reduced qwen2-0.5b with ``--model M``.

* data 1 x model 2, sgd and momentum under rsqrt_dim and exact, against
  the port's single-rank ``fused_packed`` run in this process: theta
  within rtol 1e-4, atol 1e-5 of (max|theta| + 1) -- the reference's
  tolerance for its sharded step against the plain one
  (tests/test_sharded_packed_mesh.py) -- and the same losses;
* data 1 x model 3 (momentum, exact) against the single rank likewise:
  the slab gradient of a model group of 3 (the reference rescales by 1/3
  after its all-gather's transpose; the port takes its slab of one
  gradient);
* data 2 x model 2, independent bases, against the unsharded data 2 run
  on two ranks;
* on every rank: one completion all-reduce over the model group, one
  forward all-gather and two kernel-wrapper calls (the slab projection
  and the slab apply) per step.

The spawned ranks import this file, so it imports neither jax nor the
reference package.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.kernels import rbd_step
from repro_torch.launch import train as launcher

torch.set_num_threads(1)

STEPS = 2
KW = dict(rbd_dim=64, seq=8, steps=STEPS, lr=0.5, rbd_backend="cuda",
          device="cpu")
# (name, optimizer, normalization)
PAIR_SCENARIOS = [("sgd-rsqrt", "sgd", "rsqrt_dim"),
                  ("sgd-exact", "sgd", "exact"),
                  ("momentum-rsqrt", "momentum", "rsqrt_dim"),
                  ("momentum-exact", "momentum", "exact")]


def _cfg():
    return get_config("qwen2-0.5b").reduced(compute_dtype="float32")


def _run(**kw):
    """One launcher run; returns what the tests read (this rank's
    stored params, losses, collectives, wrapper calls)."""
    rbd_step.reset_counts()
    res = launcher.run_training(_cfg(), **{**KW, **kw})
    return {"params": res.state.params.detach().clone(),
            "losses": res.losses, "collectives": res.collectives,
            "calls": {k: v for k, v in rbd_step.CALLS.items() if v},
            "strategy": res.sub_opt.plan_execution().strategy,
            "q_packed": res.sub_opt.transform.plan.packed().q_packed}


def _scenarios(world):
    if world == 2:
        out = {name: _run(model=2, batch=2, optimizer=opt,
                          normalization=norm)
               for name, opt, norm in PAIR_SCENARIOS}
        out["data2-independent"] = _run(
            data=2, batch=4, rbd_mode="independent_bases",
            normalization="exact")
        return out
    if world == 3:
        return {"m3-momentum-exact": _run(model=3, batch=2,
                                          optimizer="momentum",
                                          normalization="exact")}
    return {"2x2-independent": _run(data=2, model=2, batch=4,
                                    rbd_mode="independent_bases",
                                    normalization="exact")}


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(_scenarios(world), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path_factory, world):
    d = tmp_path_factory.mktemp(f"gloo{world}")
    ctx = mp.start_processes(_rank_main, args=(world, str(d / "store"),
                                               str(d)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the {world} gloo ranks did not finish")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: _spawn(tmp_path_factory, w) for w in (2, 3, 4)}


def _single(optimizer, norm):
    return _run(batch=2, optimizer=optimizer, normalization=norm)


def _assert_theta_close(got, want):
    scale = float(np.abs(want).max()) + 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def _gathered(results, name, ranks_of_group):
    """The model group's slabs concatenated, and the padding tail."""
    full = torch.cat([results[r][name]["params"]
                      for r in ranks_of_group]).numpy()
    q = results[ranks_of_group[0]][name]["q_packed"]
    return full[:q], full[q:]


def _assert_counts(res, m):
    assert res["strategy"] == "fused_packed"
    assert res["collectives"]["model_all_reduce"] == STEPS
    assert res["collectives"]["model_all_gather"] == STEPS
    assert res["collectives"]["grad_all_reduce"] == 0
    assert sum(res["calls"].values()) == 2 * STEPS
    assert res["calls"]["project_packed_sharded"] == STEPS


@pytest.mark.parametrize("name,optimizer,norm", PAIR_SCENARIOS)
def test_model_pair_matches_single_rank(ranks, name, optimizer, norm):
    got, tail = _gathered(ranks[2], name, [0, 1])
    want = _single(optimizer, norm)
    _assert_theta_close(got, want["params"].numpy())
    assert (tail == 0).all()
    np.testing.assert_allclose(ranks[2][0][name]["losses"], want["losses"],
                               rtol=1e-5)
    for r in (0, 1):
        res = ranks[2][r][name]
        _assert_counts(res, 2)
        assert res["calls"]["reconstruct_apply_packed_sharded"] == STEPS
        assert res["collectives"]["all_reduce"] == STEPS
        assert res["losses"] == ranks[2][0][name]["losses"]


def test_model_group_of_three_matches_single_rank(ranks):
    name = "m3-momentum-exact"
    got, tail = _gathered(ranks[3], name, [0, 1, 2])
    want = _single("momentum", "exact")
    _assert_theta_close(got, want["params"].numpy())
    assert (tail == 0).all()
    for r in range(3):
        _assert_counts(ranks[3][r][name], 3)


def test_two_by_two_independent_bases_match_unsharded_data_pair(ranks):
    """Ranks 0-1 and 2-3 are the model groups of data ranks 0 and 1:
    each group's slabs concatenate to the unsharded data-2 run's theta
    (the same on both data ranks)."""
    name = "2x2-independent"
    want = ranks[2][0]["data2-independent"]
    assert torch.equal(want["params"],
                       ranks[2][1]["data2-independent"]["params"])
    for group in ([0, 1], [2, 3]):
        got, tail = _gathered(ranks[4], name, group)
        _assert_theta_close(got, want["params"].numpy())
        assert (tail == 0).all()
    for r in range(4):
        res = ranks[4][r][name]
        _assert_counts(res, 2)
        assert res["calls"]["reconstruct_apply_packed_workers_sharded"] \
            == STEPS
        assert res["collectives"]["all_gather"] == STEPS
    np.testing.assert_allclose(ranks[4][0][name]["losses"], want["losses"],
                               rtol=1e-5)
