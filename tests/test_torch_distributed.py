"""The port's coordinate exchange over a real process group: two ranks on
gloo (``torch.multiprocessing`` spawn, a ``FileStore`` under the test's
temporary directory, so parallel test runs never share a port).

One spawn runs every scenario on both ranks and writes each rank's
results; the tests read them:

* independent bases on 2 ranks (one all-gather per step) against the
  port's own K=2 sequential simulation on the same per-worker gradients:
  bit-exact (same projections, same gathered bits, same optimizer and
  apply);
* shared basis on 2 ranks (one all-reduce mean per step) against the
  single worker on the mean gradient: close, not bit-exact -- the mean
  of two projections is rounded differently from the projection of the
  mean: theta within 1e-5 of the cumulative update + 4 ulp;
* ``issue_early`` against ``overlap="off"``: bit-exact (the same
  collective on the same payload, issued earlier);
* exactly one coordinate collective per optimizer step, the ranks' theta
  bit-identical (replicated), and the same through ``train_step`` with
  gradient accumulation;
* the per-leaf strategies (packing off, weight decay, RBD off) on
  parameter maps: the shared basis (``fused_per_leaf``; ``full_space``
  under weight decay) against the single worker on the mean gradient
  (the tolerance above), the per-leaf independent bases (``full_space``,
  Algorithm 1) against a K=2 sequential run in-process (bit-exact: the
  same projections, gathered bits, reconstructions and sums) and against
  the reference's own per-leaf step (``independent_bases_update``, weight
  decay and the full-space optimizer) under ``jax.vmap`` over the K=2
  workers (theta within 1e-4 of the cumulative update + 2 ulp), the SGD
  baseline's gradient mean against the single worker on the mean
  gradient (bit-exact: a + b then / 2 either way); one collective per
  step, every leaf's coordinates in one buffer.

The spawned ranks import this file, so it imports jax and the reference
package only inside the one test that runs the reference.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import compartments, distributed, projector
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.kernels import rbd_step
from repro_torch.optim import subspace
from repro_torch.optim import transforms as opt

torch.set_num_threads(1)

WORLD = 2
STEPS = 2
SHAPES = {"w": (64, 32), "layers/k": (3, 40, 10), "s": (), "odd": (7, 73),
          "long": (700,)}
# (name, mode, optimizer, normalization)
SCENARIOS = [
    ("ind-sgd-rsqrt", "independent_bases", "sgd", "rsqrt_dim"),
    ("ind-momentum-exact", "independent_bases", "momentum", "exact"),
    ("shared-sgd-rsqrt", "shared_basis", "sgd", "rsqrt_dim"),
    ("shared-adam-exact", "shared_basis", "adam", "exact"),
]
LR = {"sgd": 0.3, "momentum": 0.2, "adam": 0.02}
EPS32 = 2.0 ** -23
NO_COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "scalar": 0,
                  "grad_all_reduce": 0, "model_all_reduce": 0,
                  "model_all_gather": 0, "resync": 0,
                  "basis_grad_all_reduce": 0, "leaf_all_gather": 0,
                  "model_scalar": 0}
# per-leaf scenarios: (name, mode, optimizer, normalization, weight
# decay, RBD on); a plain leaf, a stacked leaf and a scalar compartment
LEAF_SHAPES = {"w": (64, 32), "layers/k": (3, 40, 10), "s": ()}
LEAF_SCENARIOS = [
    ("leaf-shared-momentum-rsqrt", "shared_basis", "momentum", "rsqrt_dim",
     0.0, True),
    ("leaf-shared-wd-adam-exact", "shared_basis", "adam", "exact", 0.01,
     True),
    ("leaf-ind-sgd-exact", "independent_bases", "sgd", "exact", 0.0, True),
    ("leaf-ind-momentum-wd-rsqrt", "independent_bases", "momentum",
     "rsqrt_dim", 0.01, True),
    ("leaf-sgd-baseline", "shared_basis", "momentum", "rsqrt_dim", 0.0,
     False),
]


def _plan(norm):
    return compartments.make_plan(
        SHAPES, 96, is_stacked=lambda n: n.startswith("layers"),
        normalization=norm)


def _inputs(layout):
    """theta0 and every worker's gradient of every step (all ranks make
    all of them, so rank 0 can run the simulation)."""
    rs = np.random.default_rng(0)
    valid = layout.param_valid.astype(bool)
    theta0 = np.where(valid, rs.standard_normal(layout.q_packed), 0)
    grads = np.where(valid, rs.standard_normal(
        (STEPS, WORLD, layout.q_packed)), 0)
    return (torch.from_numpy(theta0.astype(np.float32)),
            torch.from_numpy(grads.astype(np.float32)))


def _sub(mode, optimizer, norm, **kw):
    return subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(_plan(norm), base_seed=5,
                                       backend="cuda"),
        optimizer=optimizer, learning_rate=LR[optimizer], use_packed=True,
        mode=mode, **kw)


def _drive(sub, theta, grads):
    """STEPS optimizer steps; returns theta and the collectives of each
    step."""
    st_r, st_o = sub.init_rbd_state(), sub.init_opt_state(device="cpu")
    counts = []
    for g in grads:
        distributed.reset_counts()
        theta, st_r, st_o, _ = sub.step(theta, g, st_r, st_o)
        counts.append(dict(distributed.COLLECTIVES))
    return theta, counts


def _leaf_sub(mode, optimizer, norm, wd, enabled, **kw):
    plan = compartments.make_plan(
        LEAF_SHAPES, 48, is_stacked=lambda n: n.startswith("layers"),
        normalization=norm)
    transform = (RandomBasesTransform(plan, base_seed=5, backend="cuda")
                 if enabled else None)
    return subspace.SubspaceOptimizer(
        transform=transform, optimizer=optimizer,
        learning_rate=LR[optimizer], weight_decay=wd, mode=mode, **kw)


def _leaf_inputs():
    """theta0 and every worker's gradient map of every step."""
    rs = np.random.default_rng(1)
    theta0 = {k: torch.from_numpy(rs.standard_normal(s).astype(np.float32))
              for k, s in LEAF_SHAPES.items()}
    grads = [[{k: torch.from_numpy(rs.standard_normal(s).astype(np.float32))
               for k, s in LEAF_SHAPES.items()} for _ in range(WORLD)]
             for _ in range(STEPS)]
    return theta0, grads


def _drive_leaf(sub, theta, grads):
    st_r, st_o = sub.init_rbd_state(), sub.init_opt_state(theta)
    counts = []
    for g in grads:
        distributed.reset_counts()
        theta, st_r, st_o, _ = sub.step(theta, g, st_r, st_o)
        counts.append(dict(distributed.COLLECTIVES))
    return theta, counts


def _independent_sequential(sub, theta, grads):
    """Per-leaf Algorithm 1 for K=WORLD workers in one process: worker k
    projects its gradient on its own basis, every worker's update is
    reconstructed in turn and averaged, then weight decay, the optimizer
    and the apply -- what each rank of the group computes."""
    t = sub.transform
    st_o = sub.init_opt_state(theta)
    for step, workers in enumerate(grads):
        seeds = projector.worker_base_seeds(t.step_seed(step), WORLD)
        coords = [projector.project(workers[k], t.plan, seeds[k],
                                    backend=t.backend)
                  for k in range(WORLD)]
        total = None
        for k in range(WORLD):
            upd = projector.reconstruct(coords[k], t.plan, seeds[k],
                                        workers[k], backend=t.backend)
            total = upd if total is None else {n: total[n] + upd[n]
                                               for n in total}
        upd = {n: x / WORLD for n, x in total.items()}
        if sub.weight_decay:
            upd = {n: u + sub.weight_decay * theta[n] for n, u in upd.items()}
        upd, st_o = sub._optimizer().update(upd, st_o)
        theta = opt.apply_updates(theta, upd, sub.learning_rate)
    return theta


def _per_leaf_scenarios(rank):
    theta0, grads = _leaf_inputs()
    out = {"theta0": theta0}
    for name, mode, optimizer, norm, wd, enabled in LEAF_SCENARIOS:
        sub = _leaf_sub(mode, optimizer, norm, wd, enabled,
                        axis_name="data", k_workers=WORLD)
        res = {"strategy": sub.plan_execution().strategy}
        res["theta"], res["counts"] = _drive_leaf(
            sub, theta0, [g[rank] for g in grads])
        if rank == 0 and mode == "independent_bases":
            res["reference"] = _independent_sequential(
                _leaf_sub(mode, optimizer, norm, wd, enabled), theta0, grads)
        elif rank == 0:
            mean = [{k: torch.stack([w[k] for w in g]).mean(0)
                     for k in LEAF_SHAPES} for g in grads]
            res["reference"], _ = _drive_leaf(
                _leaf_sub(mode, optimizer, norm, wd, enabled), theta0, mean)
        out[name] = res
    return out


def _train_step_scenario(rank):
    """Two ranks through ``train_step`` with two accumulated microbatches
    each, independent bases."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(
        total_dim=64, backend="cuda", mode="independent_bases"),
        learning_rate=0.5, batch_size=4, seq_len=8, grad_accum_steps=2)
    init_state, train_step = steplib.make_train_step(
        get_model(cfg), tcfg, axis_name="data", k_workers=WORLD,
        device="cpu")
    state = init_state(0)
    stream = synthetic.lm_batches(0, 4, 8, cfg.vocab, device="cpu")
    losses, counts, calls = [], [], []
    for _ in range(STEPS):
        batch = steplib.stack_microbatches([next(stream), next(stream)])
        distributed.reset_counts()
        rbd_step.reset_counts()
        state, metrics = train_step(
            state, mesh.shard_batch(batch, rank, WORLD, axis=1))
        losses.append(float(metrics["loss"]))
        counts.append(dict(distributed.COLLECTIVES))
        calls.append(dict(rbd_step.CALLS))
    return {"theta": state.params, "losses": losses, "counts": counts,
            "calls": calls}


def _primitives(rank):
    """The synchronous exchange helpers on rank-dependent buffers, and
    what rank 0 computes locally for them."""
    layout = _plan("exact").packed()
    _, grads = _inputs(layout)
    t = RandomBasesTransform(_plan("exact"), base_seed=4, backend="cuda")
    c = torch.arange(6, dtype=torch.float32) * (rank + 1)
    q = torch.full((6,), 2.0 * (rank + 1))
    res = {"pmean": distributed.shared_basis_packed_exchange(c, q, "data"),
           "pmean_widened": distributed.shared_basis_packed_exchange(
               c, q, "data", widened=True),
           "gathered": distributed.independent_bases_coords(
               t, grads[0, rank], t.init(), "data", return_norms=True)}
    if rank == 0:
        wseeds = projector.worker_base_seeds(t.step_seed(0), WORLD)
        local = [projector.project_packed(
            grads[0, k], t.plan, wseeds[k], backend="cuda", layout=layout,
            prepacked=True, return_norms=True) for k in range(WORLD)]
        res["local"] = (torch.stack([x for x, _ in local]),
                        torch.stack([y for _, y in local]))
    return res


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        for name, mode, optimizer, norm in SCENARIOS:
            layout = _plan(norm).packed()
            theta0, grads = _inputs(layout)
            res = {}
            for overlap in ("auto", "off"):
                sub = _sub(mode, optimizer, norm, axis_name="data",
                           k_workers=WORLD, overlap=overlap)
                res[overlap], res[f"counts_{overlap}"] = _drive(
                    sub, theta0, grads[:, rank])
                res[f"schedule_{overlap}"] = \
                    sub.plan_execution().overlap_exchange
            if rank == 0 and mode == "independent_bases":
                sim = _sub(mode, optimizer, norm, k_workers=WORLD)
                res["reference"], _ = _drive(sim, theta0, grads)
            elif rank == 0:
                single = _sub(mode, optimizer, norm)
                res["reference"], _ = _drive(single, theta0,
                                             grads.mean(dim=1))
            res["theta0"] = theta0
            out[name] = res
        t = RandomBasesTransform(_plan("rsqrt_dim"), base_seed=3)
        out["worker_seed"] = (
            distributed.worker_seed(t, t.init(), "data"),
            projector.worker_base_seeds(t.step_seed(0), WORLD)[rank])
        out["primitives"] = _primitives(rank)
        out["train_step"] = _train_step_scenario(rank)
        out["per_leaf"] = _per_leaf_scenarios(rank)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
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


@pytest.mark.parametrize("name", [s[0] for s in SCENARIOS
                                  if s[1] == "independent_bases"])
def test_independent_bases_two_ranks_equal_k2_simulation(ranks, name):
    want = ranks[0][name]["reference"]
    for r in range(WORLD):
        assert torch.equal(ranks[r][name]["auto"], want), f"rank {r}"


@pytest.mark.parametrize("name", [s[0] for s in SCENARIOS
                                  if s[1] == "shared_basis"])
def test_shared_basis_two_ranks_match_single_worker_on_mean_gradient(
        ranks, name):
    res = ranks[0][name]
    want, theta0 = res["reference"].numpy(), res["theta0"].numpy()
    tol = (1e-5 * np.abs(want - theta0).max()
           + 4 * EPS32 * np.abs(want).max())
    np.testing.assert_allclose(res["auto"].numpy(), want, rtol=0, atol=tol)
    assert torch.equal(ranks[1][name]["auto"], res["auto"])


@pytest.mark.parametrize("name", [s[0] for s in SCENARIOS])
def test_issue_early_bit_identical_to_overlap_off(ranks, name):
    assert ranks[0][name]["schedule_auto"] == "issue_early"
    assert ranks[0][name]["schedule_off"] == "sync"
    for r in range(WORLD):
        assert torch.equal(ranks[r][name]["auto"], ranks[r][name]["off"])


@pytest.mark.parametrize("name,mode", [(s[0], s[1]) for s in SCENARIOS])
def test_one_collective_per_step(ranks, name, mode):
    kind = "all_gather" if mode == "independent_bases" else "all_reduce"
    one = {**NO_COLLECTIVES, kind: 1}
    for r in range(WORLD):
        for overlap in ("auto", "off"):
            assert ranks[r][name][f"counts_{overlap}"] == [one] * STEPS


def test_worker_seed_is_the_simulations_worker_seed(ranks):
    for r in range(WORLD):
        got, want = ranks[r]["worker_seed"]
        assert torch.equal(got, want)
    assert not torch.equal(ranks[0]["worker_seed"][0],
                           ranks[1]["worker_seed"][0])


def test_exchange_primitives(ranks):
    """shared_basis_packed_exchange: the mean over ranks, the local norms
    passed through unless widened; independent_bases_coords: the rows of
    the (K, d_packed) buffers are each rank's own-basis projection."""
    c = torch.arange(6, dtype=torch.float32)
    for r in range(WORLD):
        p = ranks[r]["primitives"]
        coords, sq = p["pmean"]
        assert torch.equal(coords, c * 1.5)
        assert torch.equal(sq, torch.full((6,), 2.0 * (r + 1)))
        coords, sq = p["pmean_widened"]
        assert torch.equal(coords, c * 1.5)
        assert torch.equal(sq, torch.full((6,), 3.0))
        g_coords, g_sq = p["gathered"]
        want_c, want_sq = ranks[0]["primitives"]["local"]
        assert g_coords.shape == (WORLD, want_c.shape[1])
        assert torch.equal(g_coords, want_c) and torch.equal(g_sq, want_sq)


def test_train_step_two_ranks_accumulated(ranks):
    """grad accumulation over two ranks: one projection, one all-gather
    and one K-worker apply per optimizer step; the loss is the ranks'
    mean (a scalar all-reduce) and theta stays replicated."""
    a, b = ranks[0]["train_step"], ranks[1]["train_step"]
    assert torch.equal(a["theta"], b["theta"])
    assert a["losses"] == b["losses"] and all(np.isfinite(a["losses"]))
    for res in (a, b):
        assert res["counts"] == [{**NO_COLLECTIVES, "all_gather": 1,
                                  "scalar": 1}] * STEPS
        for calls in res["calls"]:
            assert calls["project_packed"] == 1
            assert calls["reconstruct_apply_packed_workers"] == 1
            assert calls["reconstruct_apply_packed"] == 0


@pytest.mark.parametrize("name", [s[0] for s in LEAF_SCENARIOS
                                  if s[1] == "shared_basis"])
def test_per_leaf_shared_two_ranks_match_single_worker_on_mean_gradient(
        ranks, name):
    res = ranks[0]["per_leaf"][name]
    theta0 = ranks[0]["per_leaf"]["theta0"]
    for k, want in res["reference"].items():
        want, t0 = want.numpy(), theta0[k].numpy()
        tol = (1e-5 * np.abs(want - t0).max()
               + 4 * EPS32 * np.abs(want).max())
        np.testing.assert_allclose(res["theta"][k].numpy(), want, rtol=0,
                                   atol=tol, err_msg=k)
        assert torch.equal(ranks[1]["per_leaf"][name]["theta"][k],
                           res["theta"][k])
    if name == "leaf-sgd-baseline":
        # a + b, then / 2, on the ranks and in the mean alike
        for k, want in res["reference"].items():
            assert torch.equal(res["theta"][k], want), k


@pytest.mark.parametrize("name", [s[0] for s in LEAF_SCENARIOS
                                  if s[1] == "independent_bases"])
def test_per_leaf_independent_two_ranks_equal_k2_sequential(ranks, name):
    want = ranks[0]["per_leaf"][name]["reference"]
    for r in range(WORLD):
        got = ranks[r]["per_leaf"][name]["theta"]
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)


def _reference_independent_vmap(optimizer, norm, wd, theta0, grads):
    """The reference's per-leaf Algorithm 1 step (full_space:
    independent_bases_update, + wd * p, the full-space optimizer) for
    STEPS steps under ``jax.vmap`` over the WORLD workers' gradients, the
    vmapped axis named 'data' (its all_gather and axis_index are the
    mesh's).  Returns worker 0's parameters by leaf name."""
    # imported here: the spawned ranks import this module and need no jax
    import jax
    import jax.numpy as jnp

    from repro.core import compartments as ref_comp
    from repro.core.rbd import RandomBasesTransform as RefTransform
    from repro.optim import subspace as ref_subspace

    def nest(named):
        return {"w": jnp.asarray(named["w"].numpy()),
                "layers": {"k": jnp.asarray(named["layers/k"].numpy())},
                "s": jnp.asarray(named["s"].numpy())}

    plan = ref_comp.make_plan(
        jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), nest(theta0)),
        48, is_stacked=lambda n: n.startswith("layers"), normalization=norm)
    rsub = ref_subspace.SubspaceOptimizer(
        transform=RefTransform(plan, base_seed=5, backend="jnp"),
        optimizer=optimizer, learning_rate=LR[optimizer], weight_decay=wd,
        mode="independent_bases", axis_name="data", k_workers=WORLD)
    assert rsub.plan_execution().strategy == "full_space"
    params = nest(theta0)
    r_rbd, r_opt = rsub.init_rbd_state(params), rsub.init_opt_state(params)
    step = jax.jit(jax.vmap(rsub.step, in_axes=(None, 0, None, None),
                            axis_name="data"))
    for workers in grads:
        stacked = jax.tree_util.tree_map(
            lambda *x: jnp.stack(x), *[nest(w) for w in workers])
        out = step(params, stacked, r_rbd, r_opt)
        for leaf in jax.tree_util.tree_leaves(out[0]):
            np.testing.assert_array_equal(leaf[0], leaf[1])
        params, r_rbd, r_opt = jax.tree_util.tree_map(
            lambda x: x[0], out[:3])
    return {"w": np.asarray(params["w"]),
            "layers/k": np.asarray(params["layers"]["k"]),
            "s": np.asarray(params["s"])}


@pytest.mark.parametrize("name,optimizer,norm,wd", [
    (s[0], s[2], s[3], s[4]) for s in LEAF_SCENARIOS
    if s[1] == "independent_bases"])
def test_per_leaf_independent_two_ranks_match_reference(ranks, name,
                                                        optimizer, norm, wd):
    """The port's per-leaf Algorithm 1 on 2 gloo ranks against the
    reference's composition (mean of the K reconstructions, weight decay,
    the full-space optimizer) on the same per-worker gradients."""
    theta0, grads = _leaf_inputs()
    want = _reference_independent_vmap(optimizer, norm, wd, theta0, grads)
    for k, w in want.items():
        t0 = theta0[k].numpy()
        tol = 1e-4 * np.abs(w - t0).max() + 2 * EPS32 * np.abs(w).max()
        for r in range(WORLD):
            np.testing.assert_allclose(
                ranks[r]["per_leaf"][name]["theta"][k].numpy(), w, rtol=0,
                atol=tol, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name,mode,wd,enabled",
                         [(s[0], s[1], s[4], s[5]) for s in LEAF_SCENARIOS])
def test_per_leaf_one_collective_per_step(ranks, name, mode, wd, enabled):
    """Every leaf's coordinates travel in ONE buffer: one all-reduce
    (shared basis) or all-gather (independent bases) per step; the SGD
    baseline's one full-D gradient mean instead."""
    if not enabled:
        kind, strategy = "grad_all_reduce", "full_space"
    elif mode == "independent_bases":
        kind, strategy = "all_gather", "full_space"
    else:
        kind = "all_reduce"
        strategy = "full_space" if wd else "fused_per_leaf"
    for r in range(WORLD):
        res = ranks[r]["per_leaf"][name]
        assert res["strategy"] == strategy
        assert res["counts"] == [{**NO_COLLECTIVES, kind: 1}] * STEPS
