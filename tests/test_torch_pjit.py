"""Pjit-style parameter sharding in the port: leaf shards over a model
group (``models.registry.LeafShards``), the per-leaf kernels' shard
instances (their plain versions here), the per-leaf strategies on the
shards, and ``--mode pjit`` / ``--mode sharedseed --model M`` with an
unpackable plan.

* The shard plain versions on every shard of a leaf cut on dims 0, -1,
  -2 and MoE's -3: reconstruct and apply equal the unsharded slice bit
  for bit; the projections, summed over the shards in order, are within
  PROJ_ULPS f32 ulps of sum |g * b| (sq: of sum b * b) of the unsharded
  ones -- the same terms summed in another order.
* The projector on shards run in turn (``LeafShards.with_rank``), every
  strategy's functions, orthonormal included.
* The pjit-style step at a model group of one, on the reference's
  parameters and batches, against the reference's
  ``make_train_step(..., model_sharded=True)`` for 3 steps: the port's
  coord_unfused (torch backend) and fused_per_leaf (cuda backend, the
  kernels' plain versions) against the reference's coord_unfused (jnp
  backend); tolerances as tests/test_torch_train.py's.
* Four gloo ranks (``torch.multiprocessing`` spawn, a ``FileStore``),
  data 2 x model 2, with ``PURE_DP_MAX_PARAMS`` set to 0 in the ranks so
  that the reduced config gets the megatron layout: ``--mode pjit`` and
  ``--mode sharedseed`` with unpackable plans over {sgd, adam} x
  {rsqrt_dim, exact} and one orthonormal case, each against the port's
  single-rank run on the global batch (theta within the sharded-slab
  tolerance of tests/test_torch_sharded_ranks.py, losses rtol 1e-5), the
  collectives by group, and ``--checkpoint-dir``'s file (the whole map,
  gathered) against the single rank's.

The spawned ranks import this file, so the reference package (and jax)
is imported inside the two tests that read it, not at the top.
"""

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
from repro_torch.core import compartments, projector, rng
from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step
from repro_torch.launch import train as launcher
from repro_torch.models import registry
from repro_torch.models.registry import get_model, params_from_reference
from repro_torch.optim import subspace
from repro_torch.sharding import rules
from repro_torch.train import step as steplib

torch.set_num_threads(1)

EPS32 = 2.0 ** -23
PROJ_ULPS = 8
# (name, whole shape, sharded dim, stacked): embed (V, D) on 0, a head
# (D, V) on -1, a stacked row-parallel (L, F, D) on -2, a stacked bias on
# -1 and MoE experts (L, E, D, F) on -3
LAYOUTS = [("embed", (48, 20), 0, False), ("lm_head", (20, 48), 1, False),
           ("layers/mlp/w_down", (2, 24, 10), 1, True),
           ("layers/attn/bq", (3, 32), 1, True),
           ("layers/moe/w_up", (2, 4, 6, 5), 1, True)]


def _layout_shards(name, shape, dim, m):
    return registry.LeafShards({name: shape}, {name: dim}, m, 0)


def _basis_abs(seed, tail, dim, dist):
    """|P| of one compartment, (dim, q), generated explicitly."""
    q = int(np.prod(tail))
    return rng.generate_block(seed, 0, 0, (dim, q), dist).abs()


@pytest.mark.parametrize("dist", ["normal", "uniform", "rademacher",
                                  "sparse"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[x[0] for x in LAYOUTS])
def test_shard_plain_versions_equal_the_unsharded_slices(layout, dist):
    name, shape, dim, stacked = layout
    m, d = 4 if shape[dim] % 4 == 0 else 2, 11
    rs = np.random.default_rng(3)
    n_stack = shape[0] if stacked else 1
    tail = shape[1:] if stacked else shape
    seeds = rng.fold_seed(5, torch.arange(n_stack, dtype=torch.int32))
    g = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    th = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    sc = torch.from_numpy(rs.standard_normal((n_stack, d)).astype(
        np.float32))
    rows = (lambda x: x.reshape(n_stack, -1).contiguous())
    q = int(np.prod(tail))
    u, sq = rbd_project.project_flat_plain(seeds, rows(g), d, dist)
    delta = rbd_reconstruct.reconstruct_flat_plain(seeds, sc, q, dist)
    out = rbd_reconstruct.reconstruct_apply_flat_plain(seeds, sc, rows(th),
                                                       0.3, dist)
    shards = _layout_shards(name, shape, dim, m)
    us, sqs = torch.zeros_like(u), torch.zeros_like(sq)
    for r in range(m):
        sh = shards.with_rank(r)
        cm = sh.colmap(name, stacked)
        gl, tl = rows(sh.cut(name, g)), rows(sh.cut(name, th))
        ul, sql = rbd_project.project_flat_shard_plain(seeds, gl, d, dist,
                                                       colmap=cm)
        us += ul
        sqs += sql
        want_d = sh.cut(name, delta.reshape(shape))
        got_d = rbd_reconstruct.reconstruct_flat_shard_plain(
            seeds, sc, gl.shape[1], dist, colmap=cm)
        assert torch.equal(got_d.reshape(want_d.shape), want_d)
        want_o = sh.cut(name, out.reshape(shape))
        got_o = rbd_reconstruct.reconstruct_apply_flat_shard_plain(
            seeds, sc, tl, 0.3, dist, colmap=cm)
        assert torch.equal(got_o.reshape(want_o.shape), want_o)
    for s in range(n_stack):
        b = _basis_abs(int(rng.as_u32(seeds[s])), tail, d, dist)
        gb = b @ g.reshape(n_stack, -1)[s].abs()
        assert ((us[s] - u[s]).abs() <= PROJ_ULPS * EPS32 * gb).all()
        bb = (b * b).sum(1)
        assert ((sqs[s] - sq[s]).abs() <= PROJ_ULPS * EPS32 * bb).all()


def test_shard_instances_refuse_tile_keyed_impls_and_bad_maps():
    seeds = torch.zeros(1, dtype=torch.int32)
    g = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="threefry"):
        rbd_project.project_flat_shard(seeds, g, 8, colmap=(4, 8, 0),
                                       prng="hw_emulated")
    with pytest.raises(ValueError, match="does not fit"):
        rbd_project.project_flat_shard(seeds, g, 8, colmap=(3, 8, 0))
    shards = registry.LeafShards({"layers/w": (4, 6)}, {"layers/w": 0}, 2, 0)
    with pytest.raises(ValueError, match="layer"):
        shards.colmap("layers/w", True)


def _tiny_plan(normalization):
    shapes = {"embed": (24, 8), "layers/attn/wq": (2, 8, 16),
              "layers/ln1": (2, 8), "layers/mlp/w_down": (2, 16, 8)}
    plan = compartments.make_plan(
        shapes, 40, normalization=normalization,
        is_stacked=lambda n: n.startswith("layers/"))
    dims = {"embed": 0, "layers/attn/wq": 2, "layers/mlp/w_down": 1}
    return shapes, plan, dims


@pytest.mark.parametrize("normalization,backend", [
    ("rsqrt_dim", "cuda"), ("exact", "cuda"), ("exact", "torch"),
    ("orthonormal", "torch")])
def test_projector_on_shards_in_turn(normalization, backend):
    """The projector's functions on m = 2 shards run in turn: the summed
    partials normalize to the unsharded coordinates (replicated leaves
    projected once, by their rank), and every shard's update and fused
    apply is the slice of the unsharded one: bit for bit on the cuda
    backend (the shard instances' plain versions against the per-leaf
    kernels'), to rounding on the torch backend (whose unsharded form
    sums a compartment's rows tensor-shaped, in an order that depends on
    the shape) and under orthonormal (per-shard products)."""
    shapes, plan, dims = _tiny_plan(normalization)
    rs = np.random.default_rng(1)
    grads = {k: torch.from_numpy(rs.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    theta = {k: torch.from_numpy(rs.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    seed = rng.fold_seed(9)
    coords, norms = projector.project(grads, plan, seed, backend=backend,
                                      return_norms=True)
    upd = projector.reconstruct(coords, plan, seed, grads, backend=backend,
                                row_sq=norms)
    new = projector.reconstruct_apply(coords, plan, seed, theta, 0.25,
                                      backend=backend, row_sq=norms)
    shards = registry.LeafShards(shapes, dims, 2, 0)
    parts = [projector.project_partials(
        registry.shard_params(grads, shards.with_rank(r)), plan, seed,
        backend=backend, shards=shards.with_rank(r)) for r in range(2)]
    u = [a + b for a, b in zip(parts[0][0], parts[1][0])]
    sq = [a + b for a, b in zip(parts[0][1], parts[1][1])]
    exact = normalization == "exact"
    got = [projector._norm_scales(plan, lp, u[i], sq[i] if exact else None)
           for i, lp in enumerate(plan.leaves)]
    for a, b, lp in zip(got, coords, plan.leaves):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()),
                                   err_msg=lp.name)
    # the updates on each shard from the unsharded coordinates and norms
    for r in range(2):
        sh = shards.with_rank(r)
        local = registry.shard_params(theta, sh)
        d = projector.reconstruct(coords, plan, seed, local,
                                  backend=backend, row_sq=norms, shards=sh)
        a = projector.reconstruct_apply(coords, plan, seed, local, 0.25,
                                        backend=backend, row_sq=norms,
                                        shards=sh)
        for k in shapes:
            want_d, want_a = sh.cut(k, upd[k]), sh.cut(k, new[k])
            if backend == "cuda":
                assert torch.equal(d[k], want_d), k
                assert torch.equal(a[k], want_a), k
            else:
                tol = 1e-6 * float(want_d.abs().max())
                np.testing.assert_allclose(d[k].numpy(), want_d.numpy(),
                                           rtol=0, atol=tol, err_msg=k)
                np.testing.assert_allclose(a[k].numpy(), want_a.numpy(),
                                           rtol=0, atol=tol, err_msg=k)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def test_pjit_step_at_a_model_group_of_one_matches_reference():
    """Three steps of the reference's pjit-style step (``model_sharded=
    True``, no model axis: coord_unfused on the jnp backend) against the
    port's, on both its backends, from the reference's parameters and
    batches.  One global compartment: the reference's per-leaf step
    compiles in about 7 s against 20 s with one a layer; the layer plans
    run in the gloo ranks below, and tests/test_torch_per_leaf_steps.py
    holds them against the reference."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.configs.base import RBDConfig as RefRBDConfig
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.core import compartments as ref_comp
    from repro.data import synthetic as ref_data
    from repro.models import get_model as ref_model
    from repro.optim import subspace as ref_subspace
    from repro.train import step as ref_step

    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    rmodel = ref_model(rcfg)
    rtcfg = RefTrainConfig(model=rcfg, rbd=RefRBDConfig(
        total_dim=8, backend="jnp", packed="on", granularity="global"),
        learning_rate=0.5)
    r_init, r_step, r_opt = ref_step.make_train_step(
        rmodel, rtcfg, model_sharded=True, return_optimizer=True)
    r_step = jax.jit(r_step)
    rstate = r_init(jax.random.PRNGKey(0))
    params = rmodel.init(jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    names = [ref_comp._leaf_name(p) for p, _ in flat]
    theta0 = {n: np.asarray(x) for n, (_, x) in zip(names, flat)}
    data = ref_data.lm_batches(0, 2, 16, rcfg.vocab)
    batches = [next(data) for _ in range(3)]
    want_losses = []
    for b in batches:
        rstate, rmetrics = r_step(rstate, b)
        want_losses.append(float(rmetrics["loss"]))
    want = {n: np.asarray(x) for n, x in
            zip(names, jax.tree_util.tree_leaves(rstate.params))}
    rplan = r_opt.plan_execution()
    assert rplan.strategy == "coord_unfused"

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    rbd_step.reset_counts()
    for backend, strategy in (("torch", "coord_unfused"),
                              ("cuda", "fused_per_leaf")):
        tcfg = TrainConfig(model=cfg, rbd=RBDConfig(
            total_dim=8, backend=backend, packed="on",
            granularity="global"),
            learning_rate=0.5)
        init_state, train_step, sub = steplib.make_train_step(
            get_model(cfg), tcfg, model_sharded=True, device="cpu",
            return_optimizer=True)
        eplan = sub.plan_execution()
        ref_plan = ref_subspace.plan_from_flags(
            use_packed=True, model_sharded=True,
            backend={"torch": "jnp", "cuda": "pallas"}[backend])
        assert (eplan.strategy, eplan.reason) == (strategy, ref_plan.reason)
        state = init_state(params=params_from_reference(theta0,
                                                        device="cpu"))
        for b, want_loss in zip(batches, want_losses):
            state, metrics = train_step(state, _torch_batch(b))
            np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                       rtol=1e-5)
        for k in want:
            tol = (1e-3 * np.abs(want[k] - theta0[k]).max()
                   + 4 * EPS32 * np.abs(want[k]).max())
            np.testing.assert_allclose(state.params[k].numpy(), want[k],
                                       rtol=0, atol=tol, err_msg=k)
    assert rbd_step.CALLS["project_flat"] == 3 * len(sub.transform.plan.leaves)
    assert sum(rbd_step.LAUNCHES.values()) == 0


PJIT_FLAGS = [dict(use_packed=True, model_sharded=True, **kw) for kw in (
    {}, dict(normalization="exact"), dict(normalization="orthonormal"),
    dict(weight_decay=0.01), dict(axis_name="data"),
    dict(mode="independent_bases", axis_name="data"),
    dict(mode="independent_bases", axis_name="data", normalization="exact"),
    dict(optimizer="adam", normalization="none"))] + [
    dict(use_packed=False, model_sharded=True, axis_name="data"),
    dict(rbd_enabled=False, model_sharded=True)]


@pytest.mark.parametrize("flags", PJIT_FLAGS,
                         ids=[str(i) for i in range(len(PJIT_FLAGS))])
def test_pjit_routes_plan_the_reference_strategies(flags):
    """``plan_from_flags`` over the pjit-style flag grid equals the
    reference's on both backends; none of these plans is packed-resident
    (the leaf shards' route)."""
    from repro.optim import subspace as ref_subspace

    for port_be, ref_be in (("cuda", "pallas"), ("torch", "jnp")):
        port = subspace.plan_from_flags(backend=port_be, **flags)
        assert port == ref_subspace.plan_from_flags(backend=ref_be, **flags)
        assert not port.packed_resident


# ---------------------------------------------------------------------------
# four gloo ranks: data 2 x model 2
# ---------------------------------------------------------------------------

RUN = dict(rbd_dim=24, seq=8, steps=2, batch=4, device="cpu")
# (name, launcher arguments)
CASES = [
    ("pjit-sgd-rsqrt", dict(mode="pjit", optimizer="sgd", lr=0.5,
                            normalization="rsqrt_dim", rbd_backend="cuda")),
    ("pjit-sgd-exact", dict(mode="pjit", optimizer="sgd", lr=0.5,
                            normalization="exact", rbd_backend="torch")),
    ("pjit-adam-rsqrt", dict(mode="pjit", optimizer="adam", lr=0.02,
                             normalization="rsqrt_dim", rbd_backend="torch")),
    ("pjit-adam-exact", dict(mode="pjit", optimizer="adam", lr=0.02,
                             normalization="exact", rbd_backend="cuda")),
    ("shared-sgd-rsqrt", dict(mode="sharedseed", optimizer="sgd", lr=0.5,
                              normalization="rsqrt_dim", rbd_backend="cuda",
                              packed="off")),
    ("shared-sgd-exact", dict(mode="sharedseed", optimizer="sgd", lr=0.5,
                              normalization="exact", rbd_backend="cuda",
                              weight_decay=0.01)),
    ("shared-adam-rsqrt", dict(mode="sharedseed", optimizer="adam", lr=0.02,
                               normalization="rsqrt_dim",
                               rbd_backend="torch")),
    ("shared-adam-exact", dict(mode="sharedseed", optimizer="adam", lr=0.02,
                               normalization="exact", rbd_backend="cuda",
                               packed="off")),
    ("pjit-orthonormal", dict(mode="pjit", optimizer="sgd", lr=0.5,
                              normalization="orthonormal",
                              rbd_backend="torch")),
]


# independent bases over the data group on leaf shards (full_space): no
# single-rank run has its K = 2 joint subspace, so its ranks are held to
# each other
IND_CASE = dict(mode="sharedseed", rbd_mode="independent_bases",
                optimizer="sgd", lr=0.5, normalization="exact",
                rbd_backend="cuda", packed="off")


def _cfg():
    return get_config("qwen2-0.5b").reduced(compute_dtype="float32")


def _one_run(**kw):
    rbd_step.reset_counts()
    res = launcher.run_training(_cfg(), **{**RUN, **kw})
    shards = res.sub_opt.leaf_shards
    params = (res.state.params if shards is None
              else registry.gather_params(res.state.params, shards))
    return {"params": {k: v.detach().clone() for k, v in params.items()},
            "losses": res.losses, "collectives": res.collectives,
            "plan": res.sub_opt.plan_execution(),
            "dims": dict(shards.dims) if shards is not None else {},
            "calls": {k: v for k, v in rbd_step.CALLS.items() if v}}


# the case whose final state is also saved with --checkpoint-dir
CKPT_CASE = "pjit-sgd-rsqrt"


def _ckpt(name, directory):
    return {"checkpoint_dir": directory} if name == CKPT_CASE else {}


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    rules.PURE_DP_MAX_PARAMS = 0   # the megatron layout at reduced size
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = {name: _one_run(data=2, model=2, **kw,
                              **_ckpt(name, os.path.join(out_dir, "ckpt")))
               for name, kw in CASES}
        out["independent"] = _one_run(data=2, model=2, **IND_CASE)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the four ranks, and on one rank in this process (run
    while the ranks work): ``(per-rank results, single-rank results)``."""
    world = 4
    d = tmp_path_factory.mktemp("gloo_pjit")
    ctx = mp.start_processes(_rank_main, args=(world, str(d / "store"),
                                               str(d)),
                             nprocs=world, join=False, start_method="spawn")
    single = {name: _one_run(**kw, **_ckpt(name, str(d / "ckpt1")))
              for name, kw in CASES}
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError("the gloo ranks did not finish")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)], single, d


def _leaf_gathers(cfg, dims):
    """Leaf all-gathers a step: the unstacked sharded leaves once a
    forward, each stacked one once a layer in the forward and again in
    the recompute."""
    stacked = sum(1 for k in dims if k.startswith("layers/"))
    return (len(dims) - stacked) + 2 * cfg.n_layers * stacked


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_gloo_ranks_match_the_single_rank_step(ranks, name, kw):
    per_rank, singles, _ = ranks
    single = singles[name]
    cfg, steps = _cfg(), RUN["steps"]
    for r, out in enumerate(per_rank):
        got = out[name]
        assert got["plan"] == single["plan"]
        assert got["dims"] and "embed" in got["dims"]
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   rtol=1e-5)
        for k, want in single["params"].items():
            w = want.numpy()
            np.testing.assert_allclose(
                got["params"][k].numpy(), w, rtol=1e-4,
                atol=1e-5 * (np.abs(w).max() + 1), err_msg=f"{name} {k}")
        c = got["collectives"]
        assert c["model_all_reduce"] == steps   # the one completion
        assert c["leaf_all_gather"] == steps * _leaf_gathers(cfg,
                                                             got["dims"])
        assert c["model_scalar"] == steps
        assert c["scalar"] == steps        # the loss mean over data
        if kw["mode"] == "pjit":
            assert (c["grad_all_reduce"], c["all_reduce"]) == (steps, 0)
        else:
            assert (c["grad_all_reduce"], c["all_reduce"]) == (0, steps)
        assert c["all_gather"] == c["model_all_gather"] == 0


def test_checkpoint_of_the_ranks_holds_the_whole_map(ranks):
    """``--checkpoint-dir`` under leaf shards: the map is gathered first,
    so the file holds the single-rank run's keys and whole shapes, its
    parameters within the gloo cases' tolerance."""
    d = ranks[2]
    got = np.load(d / "ckpt" / f"ckpt_{RUN['steps']:08d}.npz")
    want = np.load(d / "ckpt1" / f"ckpt_{RUN['steps']:08d}.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        w = want[k]
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-5 * (np.abs(w).max() + 1),
                                   err_msg=k)


def test_gloo_ranks_independent_bases_on_leaf_shards(ranks):
    """Paper Algorithm 1's independent bases over the data group, on leaf
    shards (``full_space``, the same shard primitives): every rank ends
    with the same whole map bit for bit and the same finite losses; a
    step's collectives are the coordinates' one all-gather over
    data, the projection's completion over the model group and, under
    'exact', one more completion a worker for the regenerated norms (the
    reconstruction of a worker's update has its coordinates only)."""
    per_rank = ranks[0]
    runs = [out["independent"] for out in per_rank]
    assert runs[0]["plan"].strategy == "full_space"
    for run in runs[1:]:
        assert run["losses"] == runs[0]["losses"]
        for k, v in runs[0]["params"].items():
            assert torch.equal(run["params"][k], v), k
    assert all(np.isfinite(runs[0]["losses"]))
    steps, k_workers = RUN["steps"], 2
    for run in runs:
        c = run["collectives"]
        assert (c["all_gather"], c["all_reduce"], c["grad_all_reduce"]) == (
            steps, 0, 0)
        assert c["model_all_reduce"] == steps * (1 + k_workers)
        assert c["model_scalar"] == c["scalar"] == steps
