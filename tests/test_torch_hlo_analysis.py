"""Port parity: the step's trace analysis (``repro_torch.launch.
hlo_analysis``) and the kernels as ``torch.library`` ops.

* Kernel op calls of the port's step, traced on meta tensors in a fake
  one-rank world, equal the reference's ``count_pallas_calls`` on the
  same step (reduced qwen2-0.5b, one layer) for packed sgd / momentum /
  adam, 'exact', independent bases, the per-leaf route and the guard.
* The paper's exchange contract (``assert_coordinate_exchange``) holds on
  the port's step for every listed plan, with the payload of the same
  plan -- the guarded, sentinelled slab step of a data 2 x model 2 world
  too -- and fails on a D-sized gradient mean.
* Every kernel op: the fake outputs of a meta call have the shapes and
  dtypes of the CPU plain version's; a CPU tensor dispatches no op and
  keeps its bits; an op has no CPU kernel.
* The tracer's flops equal ``FlopCounterMode``'s; an unknown c10d op
  raises; collective bytes by the reference's kinds.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as meshlib

LAYERS = 1      # one layer keeps the reference's traces short
DIM = 256


@contextlib.contextmanager
def fake_world(data=1, model=1):
    mesh = meshlib.init_fake_mesh(data, model)
    try:
        yield mesh
    finally:
        meshlib.destroy_mesh(mesh)


def _port_step(mesh, *, optimizer="sgd", packed="on",
               rbd_mode="shared_basis", normalization="rsqrt_dim",
               guard=False, sentinel_every=0, mode="sharedseed",
               dense_grad_axis=False):
    """(step, state, batch, sub_opt) of the port's step on meta tensors,
    placed on ``mesh`` as the launcher places it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import resilience
    from repro_torch.launch.train import step_route
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    cfg = get_config("qwen2-0.5b").reduced(n_layers=LAYERS,
                                          compute_dtype="float32")
    net = get_model(cfg)
    tcfg = TrainConfig(
        model=cfg, optimizer=optimizer,
        rbd=RBDConfig(enabled=mode != "sgd", total_dim=DIM, backend="cuda",
                      packed=packed, mode=rbd_mode,
                      normalization=normalization),
        learning_rate=0.5, steps=1, batch_size=2 * mesh.data_size,
        seq_len=16)
    res = None
    if guard or sentinel_every:
        res = resilience.ResilienceConfig(
            guard=resilience.GuardConfig() if guard else None,
            sentinel_every=sentinel_every)
    transform = steplib.make_transform(net, tcfg.rbd)
    route = step_route(net, tcfg, transform, mode=mode, mesh=mesh,
                       device="meta", resilience=res)
    if dense_grad_axis:
        route["dense_grad_axis"] = mesh.data_group
    init, step, sub = steplib.make_train_step(
        net, tcfg, transform, model_shards=mesh.model_size, device="meta",
        return_optimizer=True, resilience=res, **route)
    state = init(params=net.param_template())
    batch = {k: torch.empty((2, 16), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    return step, state, batch, sub


def _ref_count(case):
    """The reference's ``count_pallas_calls`` on the same step."""
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.configs.base import RBDConfig, TrainConfig
    from repro.core import resilience
    from repro.data import synthetic
    from repro.launch.hlo_analysis import count_pallas_calls
    from repro.launch.mesh import _make_mesh, shard_map_compat
    from repro.models import get_model
    from repro.train import step as steplib

    kw = dict(CASES[case])
    cfg = get_config("qwen2-0.5b").reduced(n_layers=LAYERS,
                                          compute_dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(
        model=cfg, optimizer=kw.get("optimizer", "sgd"),
        rbd=RBDConfig(total_dim=DIM, backend="pallas",
                      packed=kw.get("packed", "on"),
                      mode=kw.get("rbd_mode", "shared_basis"),
                      normalization=kw.get("normalization", "rsqrt_dim")),
        learning_rate=0.5, steps=1, batch_size=2, seq_len=16)
    res = (resilience.ResilienceConfig(guard=resilience.GuardConfig())
           if kw.get("guard") else None)
    batch = next(synthetic.lm_batches(0, 2, 16, cfg.vocab))
    if kw.get("rbd_mode") != "independent_bases":
        init, step = steplib.make_train_step(model, tcfg, resilience=res)
        return count_pallas_calls(step, init(jax.random.PRNGKey(0)), batch)
    # the joint subspace needs the data axis: shard_map over one device
    init, step = steplib.make_train_step(model, tcfg, axis_name="data",
                                         k_workers=1)
    state = init(jax.random.PRNGKey(0))
    repl = jax.tree_util.tree_map(lambda _: P(), state)
    fn = shard_map_compat(
        step, mesh=_make_mesh((1,), ("data",)),
        in_specs=(repl, {"tokens": P("data"), "labels": P("data")}),
        out_specs=(repl, {"ce": P(), "aux": P(), "loss": P(),
                          "update_norm": P()}),
        manual_axes=("data",))
    return count_pallas_calls(fn, state, batch)


CASES = {
    "sgd": {},
    "momentum": {"optimizer": "momentum"},
    "adam": {"optimizer": "adam"},
    "exact": {"normalization": "exact"},
    "independent_bases": {"rbd_mode": "independent_bases"},
    "per_leaf": {"packed": "off"},
    "guard": {"guard": True},
}


# the cases traced here; tests/test_torch_dryrun.py takes the others
# (each reference trace costs ~5 s: its Threefry seeds traced op by op)
HERE = ("sgd", "exact", "independent_bases", "per_leaf")


@pytest.mark.parametrize("case", HERE)
def test_kernel_calls_equal_reference_pallas_calls(case):
    check_kernel_calls(case)


def check_kernel_calls(case):
    """The port's kernel op calls on ``CASES[case]`` equal the
    reference's ``count_pallas_calls`` on the same step."""
    with fake_world() as mesh:
        step, state, batch, sub = _port_step(mesh, **CASES[case])
        got = hlo_analysis.count_kernel_calls(step, state, batch)
    want = _ref_count(case)
    assert got == want, (case, got, want)
    if case != "per_leaf":
        assert got == 2
    else:
        assert got == 2 * len(sub.transform.plan.leaves)


def _contract(mesh, kinds, *, widened=False, extra=0, model_axis=False,
              **kw):
    step, state, batch, sub = _port_step(mesh, **kw)
    plan = sub.transform.plan
    d = plan.packed().d_packed
    hlo_analysis.assert_coordinate_exchange(
        step, state, batch, payload=d, n_params=plan.total_params,
        kinds=kinds, n_launches=2, widened=widened, extra=extra,
        model_axis=(2 * d if widened else d) if model_axis else None)


KINDS = {"shared_basis": ("pmean", "psum"),
         "independent_bases": ("all_gather",)}


@pytest.mark.parametrize("rbd_mode", list(KINDS))
@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_exchange_contract(optimizer, rbd_mode):
    with fake_world(data=4) as mesh:
        _contract(mesh, KINDS[rbd_mode], optimizer=optimizer,
                  rbd_mode=rbd_mode)


@pytest.mark.parametrize("rbd_mode", list(KINDS))
def test_exchange_contract_widened_exact(rbd_mode):
    with fake_world(data=4) as mesh:
        _contract(mesh, KINDS[rbd_mode], widened=True,
                  normalization="exact", rbd_mode=rbd_mode)


@pytest.mark.parametrize("rbd_mode", list(KINDS))
def test_exchange_contract_sentinel_rider(rbd_mode):
    with fake_world(data=4) as mesh:
        _contract(mesh, KINDS[rbd_mode], extra=1, optimizer="adam",
                  rbd_mode=rbd_mode, guard=True, sentinel_every=2)


@pytest.mark.parametrize("rbd_mode", list(KINDS))
@pytest.mark.parametrize("normalization", ["none", "exact"])
def test_exchange_contract_model_axis_completion(normalization, rbd_mode):
    """Packed slabs over a fake model group of 2 (data 2): the optimizer
    step on a slab -- as the reference holds it, ``sub.step`` on a slab
    and its gradient, the forward's slab all-gather aside -- has one
    completion psum over the model group and one data-axis exchange."""
    with fake_world(data=2, model=2) as mesh:
        _, state, _, sub = _port_step(mesh, optimizer="momentum",
                                      normalization=normalization,
                                      rbd_mode=rbd_mode)
        plan = sub.transform.plan
        d = plan.packed().d_packed
        widened = normalization == "exact"

        def opt_step(slab, g_slab):
            with torch.no_grad():
                return sub.step(slab, g_slab, state.rbd_state,
                                state.opt_state)[0]

        hlo_analysis.assert_coordinate_exchange(
            opt_step, state.params, torch.empty_like(state.params),
            payload=d, n_params=plan.total_params, kinds=KINDS[rbd_mode],
            n_launches=2, widened=widened,
            model_axis=2 * d if widened else d)


@pytest.mark.parametrize("planted", [False, True])
def test_guarded_slab_step_contract(planted):
    """The slab step with the guard and the sentinel on a fake data 2 x
    model 2 world: two kernel op calls, one completion psum over the model
    group (the d coordinates and the sentinel's two words) and one data
    exchange widened by the rider's scalar -- and a D-sized mean planted
    in the step fails the contract."""
    from repro_torch.core import distributed

    with fake_world(data=2, model=2) as mesh:
        _, state, _, sub = _port_step(mesh, optimizer="adam", guard=True,
                                      sentinel_every=2)
        plan = sub.transform.plan
        d = plan.packed().d_packed
        assert sub.guard is not None and sub.model_axis is not None

        def opt_step(slab, g_slab):
            with torch.no_grad():
                if planted:
                    distributed.grad_mean(
                        {"w": torch.empty(plan.total_params, device="meta")},
                        mesh.data_group)
                return sub.step(slab, g_slab, state.rbd_state,
                                state.opt_state, state.guard)[0]

        check = contextlib.nullcontext() if not planted else \
            pytest.raises(AssertionError)
        with check:
            hlo_analysis.assert_coordinate_exchange(
                opt_step, state.params, torch.empty_like(state.params),
                payload=d, n_params=plan.total_params, n_launches=2,
                extra=1, model_axis=d + 2)


def test_exchange_contract_fails_on_d_sized_grad_mean():
    """--mode sgd: the full-D gradient mean is what the contract
    forbids; planted beside the per-leaf coordinate exchange it fails
    too."""
    with fake_world(data=4) as mesh:
        _, _, _, sub = _port_step(mesh)
        plan = sub.transform.plan
        d, n_params = plan.packed().d_packed, plan.total_params
        step, state, batch, _ = _port_step(mesh, mode="sgd")
        sites = hlo_analysis.collective_sites(step, state, batch)
        assert ("psum", n_params) in sites
        step, state, batch, _ = _port_step(mesh, mode="sgd")
        with pytest.raises(AssertionError):
            hlo_analysis.assert_coordinate_exchange(
                step, state, batch, payload=d, n_params=n_params,
                n_launches=None)
        # planted: the dense gradient's mean before the per-leaf sketch
        step, state, batch, sub = _port_step(mesh, packed="off",
                                             dense_grad_axis=True)
        with pytest.raises(AssertionError, match="non-scalar"):
            hlo_analysis.assert_coordinate_exchange(
                step, state, batch, payload=sub.transform.plan.total_dim,
                n_params=n_params, n_launches=None)


def test_trace_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode

    with fake_world() as mesh:
        step, state, batch, _ = _port_step(mesh, optimizer="adam")
        tr = hlo_analysis.trace(step, state, batch)
        step, state, batch, _ = _port_step(mesh, optimizer="adam")
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
    assert tr.flops == fc.get_total_flops() > 0
    assert tr.kernel_calls == ["project_packed", "reconstruct_apply_packed"]
    assert tr.peak_bytes >= tr.argument_bytes > 0
    assert tr.bytes_accessed > 0


def test_collectives_by_kind_and_unknown_op_raises():
    with fake_world(data=4, model=2) as mesh:
        x = torch.empty(10, device="meta")

        def fn():
            dist.all_reduce(x, group=mesh.model_group)
            buf = torch.empty(4, 10, device="meta")
            dist.all_gather(list(buf.unbind(0)), x, group=mesh.data_group)
            dist.broadcast(x, src=0)

        tr = hlo_analysis.trace(fn)
        assert hlo_analysis._sites(tr) == [("psum", 10), ("all_gather", 10),
                                           ("all_gather", 10)]
        assert hlo_analysis.collective_bytes(tr) == {"all-reduce": 40.0,
                                                     "all-gather": 200.0}
        assert [c.group_size for c in tr.collectives] == [2, 4, 8]
        # ranks 0, 1 share a node; ranks 0, 2, 4, 6 and the world of 8 too
        assert not any(c.crosses_nodes for c in tr.collectives)
        with pytest.raises(NotImplementedError, match="C10D_OPS"):
            hlo_analysis.trace(lambda: dist.barrier())


# ---------------------------------------------------------------------------
# the kernels as torch.library ops
# ---------------------------------------------------------------------------


def _small_plan():
    from repro_torch.core import compartments

    shapes = {"w": (64, 32), "layers/k": (3, 40, 10), "s": (),
              "odd": (7, 73), "long": (700,)}
    return compartments.make_plan(
        shapes, 96, granularity="layer",
        is_stacked=lambda n: n.startswith("layers"))


def _op_cases():
    """(name, fn(device) -> outputs) of every kernel op, called through
    its wrapper at a small size on ``device``."""
    from repro_torch.core import compartments, projector, rng
    from repro_torch.kernels import (flash_attention, rbd_project,
                                     rbd_reconstruct, rbd_step)

    plan = _small_plan()
    lay = plan.packed()
    sl = compartments.sharded_packed_layout(lay, 2)
    seeds = projector.segment_seeds(plan, rng.fold_seed(7))
    wseeds = torch.cat([seeds, seeds + 1])
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    g, theta = rand(lay.q_packed), rand(lay.q_packed)
    scale, scale2 = rand(lay.d_packed), rand(2, lay.d_packed)
    g_slab, t_slab = rand(sl.q_slab), rand(sl.q_slab)
    fseeds = rng.fold_seed(3, torch.arange(3, dtype=torch.int32))
    fg, fscale = rand(3, 400), rand(3, 12)
    colmap = (100, 400, 200)
    q, k, v = rand(1, 70, 4, 32), rand(1, 70, 2, 32), rand(1, 70, 2, 32)

    def on(dev, *ts):
        return [t.to(dev) for t in ts]

    return {
        "project_packed": lambda d: rbd_step.project_packed(
            seeds, *on(d, g), lay),
        "reconstruct_apply_packed": lambda d: rbd_step.
        reconstruct_apply_packed(seeds, *on(d, scale, theta), lay),
        "reconstruct_apply_packed_workers": lambda d: rbd_step.
        reconstruct_apply_packed_workers(wseeds, *on(d, scale2, theta), lay),
        "reconstruct_apply_packed_adapters": lambda d: rbd_step.
        reconstruct_apply_packed_adapters(wseeds, *on(d, scale2, theta),
                                          lay),
        "project_packed_sharded": lambda d: rbd_step.project_packed_sharded(
            seeds, *on(d, g_slab), sl, 1),
        "reconstruct_apply_packed_sharded": lambda d: rbd_step.
        reconstruct_apply_packed_sharded(seeds, *on(d, scale, t_slab), sl,
                                         1),
        "reconstruct_apply_packed_workers_sharded": lambda d: rbd_step.
        reconstruct_apply_packed_workers_sharded(
            wseeds, *on(d, scale2, t_slab), sl, 0),
        "project_flat": lambda d: rbd_project.project_flat(
            fseeds, *on(d, fg), 12),
        "reconstruct_flat": lambda d: rbd_reconstruct.reconstruct_flat(
            fseeds, *on(d, fscale), 400),
        "reconstruct_apply_flat": lambda d: rbd_reconstruct.
        reconstruct_apply_flat(fseeds, *on(d, fscale, fg), 0.5),
        "project_flat_shard": lambda d: rbd_project.project_flat_shard(
            fseeds, *on(d, fg), 12, colmap=colmap),
        "reconstruct_flat_shard": lambda d: rbd_reconstruct.
        reconstruct_flat_shard(fseeds, *on(d, fscale), 400, colmap=colmap),
        "reconstruct_apply_flat_shard": lambda d: rbd_reconstruct.
        reconstruct_apply_flat_shard(fseeds, *on(d, fscale, fg), 0.5,
                                     colmap=colmap),
        "flash_attention": lambda d: flash_attention.flash_attention(
            *on(d, q, k, v)),
    }


def test_every_kernel_is_a_registered_op():
    from repro_torch.kernels import rbd_step

    ops = {n for n in rbd_step.KERNELS if n != "generate_tile"}
    assert ops == set(_op_cases())
    for name in ops:
        op = getattr(torch.ops.repro_torch, name).default
        assert op.namespace == "repro_torch"


@pytest.mark.parametrize("name", sorted(
    ["project_packed", "reconstruct_apply_packed",
     "reconstruct_apply_packed_workers", "reconstruct_apply_packed_adapters",
     "project_packed_sharded", "reconstruct_apply_packed_sharded",
     "reconstruct_apply_packed_workers_sharded", "project_flat",
     "reconstruct_flat", "reconstruct_apply_flat", "project_flat_shard",
     "reconstruct_flat_shard", "reconstruct_apply_flat_shard",
     "flash_attention"]))
def test_op_fake_outputs_match_plain_and_cpu_keeps_its_bits(name):
    from repro_torch.kernels import rbd_step

    call = _op_cases()[name]
    with torch.no_grad():
        cpu = hlo_analysis.trace(call, "cpu")
        again = call("cpu")
        meta = hlo_analysis.trace(call, "meta")
    # the CPU path runs the plain version: no op, the same bits twice
    assert cpu.kernel_calls == []
    outs = hlo_analysis._tensors(cpu.result)
    for a, b in zip(outs, hlo_analysis._tensors(again)):
        assert torch.equal(a, b)
    # a meta tensor reaches the op once; its fake outputs are shaped and
    # typed as the plain version's
    assert meta.kernel_calls == [name]
    fakes = hlo_analysis._tensors(meta.result)
    assert len(fakes) == len(outs)
    for f, o in zip(fakes, outs):
        assert f.device.type == "meta"
        assert (tuple(f.shape), f.dtype) == (tuple(o.shape), o.dtype)
    # the op has a CUDA kernel and a fake one, none for the CPU: a CPU
    # tensor that reached it would raise, never fall back
    assert rbd_step.LAUNCHES[name] == 0
    op = getattr(torch.ops.repro_torch, name).default
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(
        op.name(), "CPU")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CUDA")
    assert np.isfinite(sum(float(o.double().sum()) for o in outs))
