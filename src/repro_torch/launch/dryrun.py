"""Multi-pod dry run: trace every (arch x input-shape x mesh) combination
of the port's step, without a card (port of ``repro.launch.dryrun``).

The reference forces 512 fake XLA host devices and lowers and compiles
each step on a 16x16 (or 2x16x16) mesh.  Torch has no ahead-of-time
compiler that places arguments on 512 devices, so here ONE rank's real
step code runs on ``meta`` tensors (shapes and dtypes, no data, no
allocation) in a fake world: a default process group of 256 (or 512)
ranks on the ``"fake"`` backend (``launch.mesh.init_fake_mesh``), whose
collectives move nothing, with the ``(data, model)`` groups
``launch.mesh.init_mesh`` builds.  ``2x16x16`` maps pod x data onto a
32-rank data axis.  Every hand-written kernel is one ``repro_torch`` op
whose fake implementation gives its outputs' shapes, so the step runs to
its end and :mod:`repro_torch.launch.hlo_analysis` sees each kernel call
and each collective with its payload.  The step is placed as the
launcher places it (``launch.train.step_route``): ``sharding.rules``
decides the batch axes (the pure_dp layout below 1.2e9 parameters puts
the batch over data x model), and a model group cuts the parameters into
packed slabs or leaf shards.  Nothing touches the CUDA runtime.

Fake CUDA tensors (``FakeTensorMode``) cannot stand in for the card on a
CPU-only build: autograd reads the device's stream when it records a
leaf, and without the CUDA library that aborts the process.  ``meta`` is
the device here; a wrapper hands a meta tensor to its kernel's op as it
hands a CUDA tensor, and the decisions that look for a CUDA device see
none, as the reference's dry run sees no TPU (``hw`` resolves to
``hw_emulated`` with the reference's reason; ROADMAP Queue C 29).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k [--multi-pod] [--mode rbd|sgd|sharedseed] \\
      [--rbd-mode shared_basis|independent_bases] [--packed auto|on|off] \\
      [--normalization rsqrt_dim|exact|none|orthonormal] \\
      [--prng-impl threefry|hw|hw_emulated] [--out reports/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, RBDConfig, TrainConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.hlo_analysis import collective_bytes
from repro_torch.models import registry
from repro_torch.models.registry import get_model
from repro_torch.sharding import rules
from repro_torch.train import step as train_step_lib

# Per-card constants of the roofline terms: datasheet figures of the
# NVIDIA H100 80GB HBM3 (SXM5) at 700 W, not measurements.
PEAK_FLOPS = 989e12      # bf16 dense, FLOP/s
HBM_BW = 3.35e12         # HBM3, bytes/s
NVLINK_BW = 450e9        # NVLink 4, bytes/s a direction, inside one node
NET_BW = 50e9            # 400 Gb/s NDR InfiniBand, bytes/s, across nodes
HARDWARE = "NVIDIA H100 80GB HBM3, 700 W (datasheet)"
DEVICE = "meta"
# the rank whose step is traced
RANK = 0


def production_mesh(multi_pod: bool = False) -> dict[str, int]:
    """The reference's production mesh as ``{axis: size}``: 16x16, or
    2x16x16 with a ``pod`` axis."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def model_flops(cfg, shape: InputShape) -> float:
    """6*N*D rule (N = active params), D = tokens processed per step."""
    m = get_model(cfg)
    n_params = 0
    for name, dims in m.param_shapes().items():
        size = int(np.prod(dims, dtype=np.int64))
        if cfg.is_moe and "moe/" in name and "router" not in name:
            n_params += size // cfg.n_experts * cfg.top_k
        else:
            n_params += size
    if shape.kind == "decode":
        tokens = shape.global_batch  # one token per sequence
    else:
        tokens = shape.global_batch * shape.seq_len
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_params * tokens


def should_skip(cfg, shape: InputShape) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention architecture: long_500k requires "
                "sub-quadratic sequence mixing (DESIGN.md)")
    if shape.name == "long_500k" and cfg.is_encoder_decoder:
        return "whisper decoder max context is 448 by design"
    return None


# --------------------------------------------------------------------------
# this rank's arguments
# --------------------------------------------------------------------------


def _meta(dims, dtype) -> torch.Tensor:
    return torch.empty(tuple(dims), dtype=dtype, device=DEVICE)


def _batch_index(axes: tuple, mesh_dims: dict) -> int:
    """This rank's index along the flattened (row-major) ``axes``."""
    names = list(mesh_dims)
    coords, r = {}, dist.get_rank()
    for a in reversed(names):
        coords[a] = r % mesh_dims[a]
        r //= mesh_dims[a]
    idx = 0
    for a in axes:
        idx = idx * mesh_dims[a] + coords[a]
    return idx


def _cut_batch(x: torch.Tensor, spec, mesh_dims: dict,
               axis: int = 0) -> torch.Tensor:
    """``x`` cut along ``axis`` by the batch entry of ``spec`` (a
    ``rules`` spec whose entry ``axis`` names the batch axes, or ``()``:
    replicated)."""
    if not spec or spec[axis] is None:
        return x
    axes = spec[axis] if isinstance(spec[axis], tuple) else (spec[axis],)
    n = int(np.prod([mesh_dims[a] for a in axes]))
    i = _batch_index(axes, mesh_dims)
    size = x.shape[axis] // n
    return x.narrow(axis, i * size, size)


def _batch(model, shape: InputShape, mesh_dims, layout, n_accum=1):
    """This rank's batch of ``shape``: the global batch cut by
    ``rules.batch_specs`` (a leading (N,) microbatch axis under
    accumulation, the batch axis then the second)."""
    specs = model.batch_specs(shape)
    cut = rules.batch_specs({k: d for k, (d, _) in specs.items()},
                            mesh_dims, layout)
    out = {}
    for name, (dims, dtype) in specs.items():
        x = _cut_batch(_meta(dims, dtype), cut[name], mesh_dims)
        if n_accum > 1:
            x = x.unsqueeze(0).expand((n_accum,) + tuple(x.shape))
        out[name] = x.contiguous()
    return out


def _mesh_axes(mesh_dims: dict, layout: str) -> tuple[int, int]:
    """``(data, model)`` of the port's mesh for ``layout``: the batch
    axes are the data axis (all ranks under pure_dp, whose batch spans
    data x model), the rest the model axis."""
    n = int(np.prod(list(mesh_dims.values())))
    baxes = rules.batch_axes(mesh_dims, layout)
    data = int(np.prod([mesh_dims[a] for a in baxes]))
    return data, n // data


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------


def build_train_inputs(model, shape: InputShape, mode: str, mesh=None,
                       rbd_mode: str = "shared_basis",
                       packed: str = "auto",
                       normalization: str = "rsqrt_dim",
                       prng_impl: str = "threefry",
                       basis: str = "random",
                       guard: bool = False,
                       grad_accum_steps: int = 1,
                       mesh_dims=None):
    """(step_fn, args) of this rank's train step on ``mesh`` (a fake
    :class:`repro_torch.launch.mesh.Mesh`; ``mesh_dims`` the production
    mesh it stands for).

    ``mode='sharedseed'`` is the paper's Algorithm 1 over the batch axes:
    each rank projects its gradient and only d-sized coordinates cross
    the wire (``rbd_mode``: one packed pmean, or one all-gather into the
    K*d joint subspace).  ``mode='rbd'`` is the reference's pjit-style
    RBD (the launcher's ``--mode pjit``: parameters cut over the model
    group, the dense gradient averaged over data), ``mode='sgd'`` the
    same with RBD off.  Prints the optimizer's ``plan_execution()`` reason
    codes so the dry run never silently takes an unexpected path."""
    from repro_torch.launch.train import step_route

    cfg = model.cfg
    rbd_cfg = RBDConfig(enabled=(mode != "sgd"), mode=rbd_mode,
                        packed=packed, normalization=normalization,
                        prng_impl=prng_impl, basis=basis, backend="cuda")
    n_accum = max(1, int(grad_accum_steps))
    if mode != "sharedseed" and n_accum > 1:
        print("      grad accumulation: only the sharedseed step stacks "
              "microbatches; ignoring --grad-accum-steps here")
        n_accum = 1
    tcfg = TrainConfig(model=cfg, rbd=rbd_cfg, learning_rate=0.125,
                       grad_accum_steps=n_accum)
    transform = train_step_lib.make_transform(model, rbd_cfg)
    resilience = None
    if guard:
        from repro_torch.core.resilience import GuardConfig, ResilienceConfig

        resilience = ResilienceConfig(guard=GuardConfig())
    route = step_route(model, tcfg, transform,
                       mode="pjit" if mode == "rbd" else mode, mesh=mesh,
                       device=DEVICE, resilience=resilience)
    init_fn, step_fn, sub_opt = train_step_lib.make_train_step(
        model, tcfg, transform, model_shards=mesh.model_size, device=DEVICE,
        return_optimizer=True, resilience=resilience, **route)
    _print_update_path(sub_opt, n_accum)
    state = init_fn(params=model.param_template())
    layout = rules.layout_policy(model.param_shapes(), cfg)
    batch = _batch(model, shape, mesh_dims or {"data": mesh.data_size,
                                               "model": mesh.model_size},
                   layout, n_accum)
    return step_fn, (state, batch)


def _print_update_path(sub_opt, n_accum: int = 1):
    ep = sub_opt.plan_execution()
    fused = "fused" if ep.fused else "UNFUSED"
    print(f"      update path [{fused}]: {ep.strategy} -- {ep.reason}")
    if sub_opt.transform is not None:
        print(f"      basis: {ep.basis} -- {ep.basis_reason}")
        print(f"      prng impl: {ep.prng_impl} -- {ep.prng_reason}")
    if sub_opt.resilience_active:
        print("      resilience: "
              f"guard={'on' if sub_opt.guard is not None else 'off'} "
              f"sentinel_every={sub_opt.sentinel_every} "
              f"capture={'on' if sub_opt.capture_coords else 'off'} -- "
              "guarded step keeps two launches and one collective")
    if sub_opt.transform is not None and ep.strategy == "fused_packed":
        # full exchange schedule: what crosses the wire, where it is
        # issued and awaited, and how accumulation amortizes it --
        # misrouted configs diagnose here without a card
        plan = sub_opt.transform.plan
        d = plan.packed().d_packed
        exact = plan.normalization == "exact"
        kind = "all_gather" if sub_opt.joint_subspace else "pmean"
        body = (f"(2*{d},) coords+row-norms (widened 'exact')"
                if exact else f"({d},) coords")
        riders = 1 if sub_opt.sentinel_every else 0
        if ep.overlap_exchange == "issue_early":
            issue = "at sketch, right after the projection launch"
            wait = "at apply, just before the reconstruct-apply launch"
        elif ep.overlap_exchange == "sync":
            issue = "at finish (synchronous reference schedule)"
            wait = "immediately after issue"
        else:
            issue = wait = "n/a (no collective in the program)"
        print(f"      exchange schedule [{ep.overlap_exchange}]: "
              f"{ep.overlap_reason}")
        print(f"        payload: one {kind} of {body} "
              f"+ {riders} rider scalar(s)")
        if sub_opt.model_axis is not None:
            # the port's model axis is a process group; the reference
            # names its mesh axis 'model'
            print(f"        model completion: one psum of {body} over "
                  "'model' (slab-partial projection; theta never crosses "
                  "the wire)")
        print(f"        issue point: {issue}")
        print(f"        wait point:  {wait}")
        print(f"        accumulation: {n_accum} microbatch(es) per "
              f"optimizer step -> 1 exchange per optimizer step"
              + (f" (not {n_accum})" if n_accum > 1 else ""))


def _params(model, mesh, shards: bool):
    """The parameter map on the dry run's device; this rank's leaf shards
    when ``shards`` and the model group cuts any leaf."""
    params = model.param_template()
    if shards and mesh.model_size > 1:
        ls = registry.leaf_shards(model, mesh.model_size, mesh.model_index,
                                  mesh.model_group)
        if ls.dims:
            return registry.shard_params(params, ls), ls
    return params, None


def build_prefill_inputs(model, shape: InputShape, mesh=None,
                         mesh_dims=None):
    """The forward pass on this rank's batch (the reference's choice: the
    model's forward, not the flash kernel).  Parameters cut over a model
    group are leaf shards, gathered leaf by leaf in the forward."""
    params, shards = _params(model, mesh, shards=True)
    layout = rules.layout_policy(model.param_shapes(), model.cfg)
    batch = _batch(model, shape, mesh_dims, layout)

    def prefill_fn(params, batch):
        with torch.no_grad():
            logits, aux = model.forward(params, batch, shards=shards)
        return logits

    return prefill_fn, (params, batch)


def build_decode_inputs(model, shape: InputShape, mesh=None,
                        mesh_dims=None):
    """One decode step against a ``seq_len`` cache -- the canonical
    "decode at full context" roofline point.  The cache and the token are
    cut by ``rules.cache_specs``' batch axes; the model-axis entries (kv
    heads, recurrent heads) are not cut: the port has no tensor-parallel
    compute (ROADMAP Queue A 23), so each rank of a model group runs its
    batch slice with the whole parameters."""
    params = model.param_template()
    b = shape.global_batch
    cache = model.init_cache(b, shape.seq_len, device=DEVICE)
    specs = rules.cache_specs(cache, mesh_dims)
    cache = {k: _cut_batch(v, specs[k], mesh_dims, axis=1)
             if v.dim() >= 2 else v for k, v in cache.items()}
    baxes = rules.batch_axes(mesh_dims)
    bsize = int(np.prod([mesh_dims[a] for a in baxes]))
    token = _meta((b, 1), torch.int64)
    if b % bsize == 0:
        token = _cut_batch(token, (baxes if len(baxes) > 1 else baxes[0],),
                           mesh_dims)

    def serve_step(params, cache, token):
        with torch.no_grad():
            return model.decode_step(params, cache, token)

    return serve_step, (params, cache, token)


def shardings_for(model, shape: InputShape, mesh_dims, *,
                  packed: bool = False) -> dict:
    """The ``sharding.rules`` spec of every argument of ``shape``'s step,
    by role, of the GLOBAL shapes (the reference's ``shardings_for``):
    the parameters by ``param_specs`` (``packed``: the packed theta's
    slab spec, under the megatron layout), a batch by ``batch_specs``, a
    cache by ``cache_specs``, the optimizer state replicated.  The
    builders above hand the step this rank's cut of each argument;
    ``run_one`` records these specs."""
    cfg = model.cfg
    shapes = model.param_shapes()
    layout = rules.layout_policy(shapes, cfg)
    if packed:
        params = {"<packed>": rules.packed_slab_spec()
                  if layout == "megatron" else ()}
    else:
        params = rules.param_specs(shapes, mesh_dims, cfg)
    out = {"params": params}
    dims = {k: d for k, (d, _) in model.batch_specs(shape).items()}
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 device=DEVICE)
        out["cache"] = rules.cache_specs(cache, mesh_dims)
        out["token"] = rules.batch_specs(dims, mesh_dims, layout)
    else:
        out["batch"] = rules.batch_specs(dims, mesh_dims, layout)
    return out


def _spec_summary(specs: dict) -> dict[str, str]:
    """Per role: how many of its leaves are cut over which axes."""
    out = {}
    for role, spec in specs.items():
        cut: dict[str, int] = {}
        for s in spec.values():
            for entry in s:
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                key = "x".join(axes)
                cut[key] = cut.get(key, 0) + 1
        out[role] = f"{len(spec)} leaves: " + (", ".join(
            f"{n} over {k}" for k, n in sorted(cut.items()))
            or "replicated")
    return out


# --------------------------------------------------------------------------
# one combination
# --------------------------------------------------------------------------


def roofline(tr: hlo_analysis.Trace) -> dict[str, float]:
    """The three roofline terms of a trace on the card's datasheet
    constants: flops over the bf16 peak, bytes over HBM, each
    collective's result bytes over NVLink (a group inside one node) or
    the network (a group across nodes)."""
    t_coll = sum(c.result_bytes / (NET_BW if c.crosses_nodes else NVLINK_BW)
                 for c in tr.collectives)
    return {"t_compute": tr.flops / PEAK_FLOPS,
            "t_memory": tr.bytes_accessed / HBM_BW,
            "t_collective": t_coll}


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mode: str = "rbd", rbd_mode: str = "shared_basis",
            packed: str = "auto", normalization: str = "rsqrt_dim",
            prng_impl: str = "threefry", basis: str = "random",
            guard: bool = False,
            grad_accum_steps: int = 1,
            out_dir: str = "reports/dryrun",
            save: bool = True) -> dict[str, Any]:
    """Trace rank 0's step of one combination and return (and save) its
    record, with the reference's keys.  ``trace_s`` takes the place of
    ``lower_s`` / ``compile_s``; ``hlo_loops`` is empty: there is no HLO,
    and a Python loop runs every trip, so no site is weighted by a trip
    count (ROADMAP Queue C 25-26; the roofline's constants C 28, the
    placement C 30, the memory C 31)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    skip = should_skip(cfg, shape)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    result: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag, "mode": mode,
        "rbd_mode": rbd_mode,
    }
    if skip:
        result["skipped"] = skip
        _save(result, out_dir, save)
        return result

    model = get_model(cfg)
    mesh_dims = production_mesh(multi_pod)
    n_dev = int(np.prod(list(mesh_dims.values())))
    layout = rules.layout_policy(model.param_shapes(), cfg)
    if shape.kind == "decode":
        data, model_n = _mesh_axes(mesh_dims, "megatron")
    else:
        data, model_n = _mesh_axes(mesh_dims, layout)
    t0 = time.time()
    mesh = meshlib.init_fake_mesh(data, model_n, rank=RANK, device=DEVICE)
    try:
        if shape.kind == "train":
            fn, args = build_train_inputs(
                model, shape, mode, mesh, rbd_mode=rbd_mode, packed=packed,
                normalization=normalization, prng_impl=prng_impl,
                basis=basis, guard=guard,
                grad_accum_steps=grad_accum_steps, mesh_dims=mesh_dims)
        elif shape.kind == "prefill":
            fn, args = build_prefill_inputs(model, shape, mesh, mesh_dims)
        else:
            fn, args = build_decode_inputs(model, shape, mesh, mesh_dims)
        packed_params = (shape.kind == "train"
                         and not isinstance(args[0].params, dict))
        specs = _spec_summary(shardings_for(model, shape, mesh_dims,
                                            packed=packed_params))
        t_build = time.time() - t0
        tr = hlo_analysis.trace(fn, *args)
    finally:
        meshlib.destroy_mesh(mesh)
    del args, fn

    coll = collective_bytes(tr)
    coll_dev = sum(coll.values())
    mf = model_flops(cfg, shape)
    terms = roofline(tr)
    kernels: dict[str, int] = {}
    for k in tr.kernel_calls:
        kernels[k] = kernels.get(k, 0) + 1
    result.update(
        devices=n_dev,
        rank=RANK,
        mesh_axes={"data": data, "model": model_n},
        arg_specs=specs,
        device=DEVICE,
        hardware=HARDWARE,
        build_s=round(t_build, 1),
        trace_s=round(tr.seconds, 1),
        n_ops=tr.n_ops,
        flops_per_device=float(tr.flops),
        bytes_per_device=float(tr.bytes_accessed),
        collective_bytes_per_device=coll_dev,
        collectives=coll,
        collective_sites=hlo_analysis._sites(tr),
        kernel_calls=kernels,
        hlo_loops=[],
        model_flops_global=mf,
        useful_flops_ratio=(mf / (tr.flops * n_dev) if tr.flops else None),
        memory_analysis={
            "argument_size_in_bytes": tr.argument_bytes,
            "output_size_in_bytes": tr.output_bytes,
            "temp_size_in_bytes": tr.temp_bytes,
        },
        **terms,
    )
    result["bottleneck"] = max(
        ("compute", "memory", "collective"),
        key=lambda k: result[f"t_{k}"])
    _save(result, out_dir, save)
    return result


def _tag(result) -> str:
    tag = (f"{result['arch']}_{result['shape']}_{result['mesh']}"
           f"_{result['mode']}")
    if result.get("rbd_mode", "shared_basis") != "shared_basis":
        tag += "_" + result["rbd_mode"]
    return tag


def _save(result, out_dir, save):
    if not save:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, _tag(result) + ".json"), "w") as f:
        json.dump(result, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="rbd",
                    choices=["rbd", "sgd", "sharedseed"])
    ap.add_argument("--rbd-mode", default="shared_basis",
                    choices=["shared_basis", "independent_bases"],
                    help="sharedseed exchange: one packed-coordinate "
                         "pmean, or one all-gather into the K*d joint "
                         "subspace (Algorithm 1)")
    ap.add_argument("--packed", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--normalization", default="rsqrt_dim",
                    choices=["rsqrt_dim", "exact", "none", "orthonormal"],
                    help="basis-row normalization; 'exact' keeps the "
                         "packed two-launch step with ONE widened "
                         "coords+norms collective (the printed plan "
                         "reason shows the routing)")
    ap.add_argument("--prng-impl", default="threefry",
                    choices=["threefry", "hw", "hw_emulated"],
                    help="basis-generation PRNG backend (hw degrades to "
                         "hw_emulated off the card with a printed reason)")
    ap.add_argument("--basis", default="random",
                    choices=["random", "trajectory_pca",
                             "gradient_informed"],
                    help="BasisSpec: per-step random redraw (paper "
                         "default) or a materialized resident basis; "
                         "the printed plan block shows the effective "
                         "spec and its reason-coded routing")
    ap.add_argument("--basis-refresh-every", type=int, default=0,
                    help="materialized-basis refresh cadence (steps); "
                         "trace-only here -- shown for the cost model, "
                         "the dry run never executes a refresh")
    ap.add_argument("--guard", action="store_true",
                    help="trace the non-finite-guarded step and print "
                         "the resilience plan (the guard must keep the "
                         "packed step at two launches + one collective)")
    ap.add_argument("--grad-accum-steps", type=int, default=1,
                    help="microbatches per optimizer step (sharedseed): "
                         "the printed exchange schedule shows the "
                         "accumulation factor and the 1-exchange-per-"
                         "optimizer-step amortization")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                combos.append((arch, shape, args.multi_pod))
    else:
        combos.append((args.arch, args.shape, args.multi_pod))

    failures = []
    t_all = time.time()
    for arch, shape, mp in combos:
        try:
            r = run_one(arch, shape, multi_pod=mp, mode=args.mode,
                        rbd_mode=args.rbd_mode, packed=args.packed,
                        normalization=args.normalization,
                        prng_impl=args.prng_impl, basis=args.basis,
                        guard=args.guard,
                        grad_accum_steps=args.grad_accum_steps,
                        out_dir=args.out)
            if "skipped" in r:
                print(f"SKIP  {arch:24s} {shape:12s} {r['skipped'][:50]}",
                      flush=True)
            else:
                print(f"OK    {arch:24s} {shape:12s} mesh={r['mesh']} "
                      f"trace={r['trace_s']}s "
                      f"bottleneck={r['bottleneck']} "
                      f"Tc={r['t_compute']:.3f}s Tm={r['t_memory']:.3f}s "
                      f"Tcoll={r['t_collective']:.4f}s", flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append((arch, shape, repr(e)[:200]))
            print(f"FAIL  {arch:24s} {shape:12s} {repr(e)[:160]}",
                  flush=True)
    print(f"dry run: {len(combos)} combination(s) in "
          f"{time.time() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures")


if __name__ == "__main__":
    main()
