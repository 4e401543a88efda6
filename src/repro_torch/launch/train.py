"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --mode sharedseed --data 1 --rbd-backend cuda --rbd-dim 1024 \\
        --batch 8 --seq 128 --steps 3

    # K = 2 workers on the CPU (gloo), the paper's independent bases:
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen2-0.5b --reduced --device cpu --data 2 \\
        --rbd-mode independent_bases --rbd-backend cuda --rbd-dim 128 \\
        --batch 4 --seq 16 --steps 3

    # model-sharded slabs on the CPU: 2 ranks of one model group (the
    # packed kernels' plain versions: on the CPU the default backend is
    # the unpacked torch one)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --device cpu --model 2 --rbd-backend cuda

    # pjit-style parameter sharding: leaf shards over a model group of 2
    # (the megatron layout above 1.2e9 parameters; a reduced config is
    # pure data parallel, nothing cut), the per-leaf strategies on them
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --device cpu --mode pjit --model 2
    # ... and under --mode sharedseed with a plan that cannot stay packed
    ... --mode sharedseed --model 2 --rbd-backend cuda --packed off

    # the per-leaf strategies: packing off (one launch per leaf), weight
    # decay (full_space), the paper's SGD baseline (RBD off)
    ... --rbd-backend cuda --packed off
    ... --rbd-backend cuda --weight-decay 0.01
    ... --mode sgd

    # the tile-keyed PRNG of the packed step on the CPU (the plain
    # versions; ``hw`` resolves to hw_emulated off a card, as the
    # reference's does off a TPU)
    ... --device cpu --rbd-backend cuda --prng-impl hw_emulated

    # resilience: the non-finite guard, the divergence sentinel, the
    # coordinate replay log with a snapshot every 50 steps; --resume
    # restores the newest snapshot and replays the log before training
    ... --rbd-backend cuda --guard --sentinel-every 2 \
        --resilience-dir runs/res --snapshot-every 50 [--resume]
    # ... and on the model-sharded slabs
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --device cpu --model 2 --rbd-backend cuda \
        --guard --sentinel-every 2 --resilience-dir runs/res2 [--resume]

    # the basis layer: a materialized basis refreshed from the trajectory
    # (or the gradient history) every 3 steps, L-BFGS in its coordinates
    ... --device cpu --rbd-backend cuda --basis trajectory_pca \
        --coord-optimizer lbfgs --basis-refresh-every 3 --steps 6

Flag names are the reference's for what the port runs: ``--mode
sharedseed`` (the paper's Algorithm 1) over ``--data K`` ranks, each
taking its shard of the global batch, with one coordinate collective per
optimizer step -- an all-reduce mean (``--rbd-mode shared_basis``) or an
all-gather into the K*d joint subspace (``--rbd-mode
independent_bases``) -- and the packed two-launch step (``--rbd-backend
cuda``, where the reference says ``pallas``) or, with ``--packed off``,
``--weight-decay`` or the default ``--rbd-backend torch``, the per-leaf
strategies.  ``--mode sgd`` is the paper's baseline: RBD off, the full-D
gradient averaged over the data group (one all-reduce per step, also on
one rank: the port always runs the data group), a full-space optimizer.
``--data`` x ``--model`` must equal the world size ``torchrun`` gives;
``--data 1`` runs a one-rank group without ``torchrun``.  ``--mode pjit``
is the reference's pjit-style parameter sharding: the parameters are cut
over the model group by ``sharding.rules.param_specs`` (leaf shards,
``models.registry.LeafShards``), no coordinate exchange runs over data,
each data rank takes its slice of the global batch and the dense
gradient is averaged over the data group (``distributed.grad_mean``, the
collective XLA inserts), and the update runs the per-leaf strategies on
the shards; ``--mode sharedseed --model M`` with a plan that cannot stay
packed (packing off, ``orthonormal``, weight decay, independent bases
unpacked) takes the same leaf shards under the per-leaf coordinate
exchange over data.  ``--arch whisper-tiny`` raises: the launcher feeds
token batches and the encoder-decoder also needs frames (the reference's
launcher fails on the missing ``frames`` key).  Runs on the GPU (NCCL) unless ``--device cpu``
(gloo).  The resilience flags (``--guard``, ``--resilience-dir``,
``--snapshot-every``, ``--sentinel-every``, ``--on-divergence``,
``--resume``) are the reference's; they need the packed step, and run on
its model-sharded slabs too (``--model M``): one writer (data index 0,
model index 0), a snapshot of the whole (q_padded,) buffer gathered over
the writer's model group, and on ``--resume`` each rank's slab of it
with the log replayed on the slab; ``repair`` re-broadcasts over this
rank's data group.
``--checkpoint-dir`` saves the parameter map whole (gathered over the
model group first).  ``--basis trajectory_pca | gradient_informed`` plans the
materialized basis (``materialized_packed``: two matmuls a step, no kernel
launch) where a resident basis can exist, refreshed by
``train.loop.BasisCollector`` every ``--basis-refresh-every`` steps;
``--coord-optimizer`` supersedes ``--optimizer`` and adds ``lbfgs`` and
``newton``, which need a basis fixed between steps (a materialized
``--basis``).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple


class RunResult(NamedTuple):
    state: Any                 # final TrainState
    losses: list[float]        # per-step loss (mean over the ranks)
    theta_init_sum: float      # float64 sum of the initial parameters
    sub_opt: Any               # the SubspaceOptimizer
    peak_bytes: int            # torch.cuda.max_memory_allocated (0 on CPU)
    kernel_ms: dict            # per-launch ms by kernel (--kernel-times)
    collectives: dict          # collectives issued during the steps, by kind
    monitor: Any = None        # the ResilienceMonitor (resilience on)
    recovery: Any = None       # --resume: recover()'s info, plus the kernel
                               # launches of the restore and replay
    collector: Any = None      # the BasisCollector (materialized --basis)
    step_seconds: Any = None   # host wall of each step, the loss read back


def main(argv=None) -> RunResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="sharedseed",
                    choices=["pjit", "sharedseed", "sgd"])
    ap.add_argument("--rbd-mode", default="shared_basis",
                    choices=["shared_basis", "independent_bases"])
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks (the paper's K workers under "
                         "--mode sharedseed); must equal the world size")
    ap.add_argument("--model", type=int, default=1,
                    help="model mesh axis size; under --mode sharedseed "
                         "with the packed step this shards the packed "
                         "theta buffer into per-device slabs (the step "
                         "stays two launches, coordinates gain one "
                         "d-sized psum over 'model'); under --mode pjit, "
                         "or with a plan that cannot stay packed, it cuts "
                         "the parameter leaves by sharding.rules")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split over the --data ranks")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum-steps", type=int, default=1,
                    help="microbatches per optimizer step; gradients "
                         "accumulate on the packed (q_packed,) buffer and "
                         "the step performs ONE coordinate exchange per "
                         "optimizer step instead of N")
    ap.add_argument("--lr", type=float, default=0.125)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam"],
                    help="coordinate-space optimizer; state lives on the "
                         "packed (d,) buffer, still two launches per step "
                         "(on the parameters under full_space)")
    ap.add_argument("--coord-optimizer", default=None,
                    choices=["sgd", "momentum", "adam", "lbfgs", "newton"],
                    help="coordinate-space optimizer, superseding "
                         "--optimizer; lbfgs/newton run second-order "
                         "updates on the (d,) coordinate buffer and "
                         "require a basis FIXED between steps (a "
                         "materialized --basis, or FPD)")
    ap.add_argument("--weight-decay", type=float, default=0.0,
                    help="couples the update to the full-space parameters: "
                         "plans the full_space strategy")
    ap.add_argument("--momentum-beta", type=float, default=0.9,
                    help="--optimizer momentum: decay of the velocity")
    ap.add_argument("--nesterov", action="store_true",
                    help="--optimizer momentum: Nesterov's look-ahead")
    ap.add_argument("--adam-b1", type=float, default=0.9,
                    help="--optimizer adam: first-moment decay")
    ap.add_argument("--adam-b2", type=float, default=0.999,
                    help="--optimizer adam: second-moment decay")
    ap.add_argument("--adam-eps", type=float, default=1e-8,
                    help="--optimizer adam: denominator epsilon")
    ap.add_argument("--rbd-dim", type=int, default=1024)
    ap.add_argument("--normalization", default="rsqrt_dim",
                    choices=["rsqrt_dim", "exact", "none", "orthonormal"])
    ap.add_argument("--rbd-backend", default="auto",
                    choices=["auto", "torch", "cuda"],
                    help="cuda: the hand-written Hopper kernels; torch: "
                         "their plain PyTorch versions; auto: cuda on a "
                         "card, torch on the CPU")
    ap.add_argument("--packed", default="auto",
                    choices=["auto", "on", "off"],
                    help="packed two-launch step (auto: on for cuda)")
    ap.add_argument("--prng-impl", default="threefry",
                    choices=["threefry", "hw", "hw_emulated"],
                    help="basis-generation PRNG backend: bit-stable "
                         "Threefry counters, the TPU hardware PRNG "
                         "(packed megakernels, real TPU only; degrades "
                         "to the emulated stub off-TPU with a logged "
                         "reason), or the CPU-testable emulated stub.  "
                         "In this port hw is a tile-keyed Philox4x32-10 "
                         "in the CUDA kernels, on a card")
    ap.add_argument("--basis", default="random",
                    choices=["random", "trajectory_pca",
                             "gradient_informed"],
                    help="BasisSpec, one level above --prng-impl: the "
                         "paper's per-step random redraw, or a "
                         "MATERIALIZED basis stored on RBDState and "
                         "refreshed from trajectory PCA / gradient "
                         "history (degrades to random with a printed "
                         "reason where no resident basis can exist)")
    ap.add_argument("--basis-refresh-every", type=int, default=0,
                    help="materialized-basis refresh cadence in steps "
                         "(0: a default derived from the subspace dim)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time every kernel launch with CUDA events and "
                         "print launches, median ms and peak memory")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--guard", action="store_true",
                    help="non-finite step guard: a NaN/Inf step is "
                         "rejected (params and optimizer state untouched, "
                         "reason-coded) and the effective LR backs off; "
                         "detection reads only the (d,)-sized coordinate "
                         "buffers and the step stays two launches")
    ap.add_argument("--resilience-dir", default=None,
                    help="directory for the coordinate replay log + "
                         "sparse packed snapshots (micro-checkpoints); "
                         "recovery = newest intact snapshot + replay of "
                         "the logged d-dimensional updates")
    ap.add_argument("--snapshot-every", type=int, default=50,
                    help="sparse full-state snapshot period (steps)")
    ap.add_argument("--sentinel-every", type=int, default=0,
                    help="replica-divergence sentinel period (0 = off); "
                         "the checksum rides the existing coordinate "
                         "exchange as ONE extra scalar")
    ap.add_argument("--on-divergence", default="fail",
                    choices=["fail", "repair"],
                    help="divergence response: hard failure (CI) or "
                         "reason-coded re-broadcast from worker 0")
    ap.add_argument("--resume", action="store_true",
                    help="recover from --resilience-dir (snapshot + "
                         "coordinate replay) before training")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(compute_dtype="float32")
    resilience = None
    if args.guard or args.resilience_dir or args.sentinel_every:
        from repro_torch.core.resilience import GuardConfig, ResilienceConfig

        resilience = ResilienceConfig(
            directory=args.resilience_dir,
            snapshot_every=args.snapshot_every,
            guard=GuardConfig() if args.guard else None,
            sentinel_every=args.sentinel_every,
            on_divergence=args.on_divergence)
    return run_training(
        cfg, mode=args.mode, rbd_mode=args.rbd_mode, data=args.data,
        model=args.model, steps=args.steps, batch=args.batch,
        seq=args.seq, grad_accum_steps=args.grad_accum_steps, lr=args.lr,
        rbd_dim=args.rbd_dim, normalization=args.normalization,
        rbd_backend=args.rbd_backend, packed=args.packed,
        prng_impl=args.prng_impl, basis=args.basis,
        basis_refresh_every=args.basis_refresh_every,
        optimizer=(args.coord_optimizer or args.optimizer),
        weight_decay=args.weight_decay,
        momentum_beta=args.momentum_beta, nesterov=args.nesterov,
        adam_b1=args.adam_b1, adam_b2=args.adam_b2, adam_eps=args.adam_eps,
        device=args.device, kernel_times=args.kernel_times,
        resilience=resilience, resume=args.resume,
        checkpoint_dir=args.checkpoint_dir)


def resolve_backend(rbd_backend: str, device) -> str:
    """``auto`` -> ``cuda`` on a card, ``torch`` on the CPU; an explicit
    backend as it is."""
    import torch

    if rbd_backend != "auto":
        return rbd_backend
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def run_training(cfg, *, mode="sharedseed", rbd_mode="shared_basis", data=1,
                 model=1, steps=10, batch=8, seq=128, grad_accum_steps=1,
                 lr=0.125, rbd_dim=1024, normalization="rsqrt_dim",
                 rbd_backend="auto", packed="auto", prng_impl="threefry",
                 basis="random", basis_refresh_every=0, optimizer="sgd",
                 weight_decay=0.0, momentum_beta=0.9, nesterov=False,
                 adam_b1=0.9, adam_b2=0.999, adam_eps=1e-8, device="cuda",
                 kernel_times=False, resilience=None, resume=False,
                 checkpoint_dir=None) -> RunResult:
    """Train ``steps`` optimizer steps (see the module docstring).
    ``resilience``: an optional ``core.resilience.ResilienceConfig``;
    ``resume`` recovers from its directory first (the newest intact
    snapshot, then the replay log) and trains the remaining steps;
    ``checkpoint_dir`` saves the final state, the parameters as a map,
    as checkpoint ``steps``."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.registry import resolve_device

    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: the launcher feeds token batches only "
            "(data.synthetic.lm_batches) and the encoder-decoder also needs "
            "frames; train it through train.step.make_train_step with "
            "model.make_batch (ROADMAP.md Queue C 18)")
    mesh = meshlib.init_mesh(data, model, resolve_device(device))
    try:
        return _run(cfg, mode=mode, rbd_mode=rbd_mode, data=data,
                    model=model, mesh=mesh, steps=steps, batch=batch,
                    seq=seq, grad_accum_steps=grad_accum_steps, lr=lr,
                    rbd_dim=rbd_dim, normalization=normalization,
                    rbd_backend=resolve_backend(rbd_backend, mesh.device),
                    packed=packed, prng_impl=prng_impl, basis=basis,
                    basis_refresh_every=basis_refresh_every,
                    optimizer=optimizer,
                    weight_decay=weight_decay, momentum_beta=momentum_beta,
                    nesterov=nesterov, adam_b1=adam_b1, adam_b2=adam_b2,
                    adam_eps=adam_eps, device=mesh.device,
                    kernel_times=kernel_times, resilience=resilience,
                    resume=resume, checkpoint_dir=checkpoint_dir)
    finally:
        meshlib.destroy_mesh(mesh)


def step_route(net, tcfg, transform, *, mode: str, mesh, device,
               resilience=None) -> dict:
    """The parallel layout of ``--mode`` on ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`): the keyword arguments of
    ``train.step.make_train_step`` that place the step -- ``axis_name``,
    ``k_workers``, ``model_sharded``, ``model_axis``, ``leaf_shards`` and
    ``dense_grad_axis`` -- as the launcher runs it (and the dry run
    traces it)."""
    from repro_torch.models import registry
    from repro_torch.train import step as steplib

    data, model = mesh.data_size, mesh.model_size
    # sharedseed runs over the data group (as the reference's shard_map
    # does, also on one device); the SGD baseline only with several data
    # ranks, its one collective the full-D gradient mean.
    # independent_bases needs the static worker count of its joint subspace
    axis_name = ("data" if mode == "sharedseed" or (mode == "sgd"
                                                     and data > 1)
                 else None)
    k_workers = data if axis_name is not None else 1
    # --mode pjit, or a model axis: parameters sharded over the model group
    model_sharded = mode == "pjit" or model > 1
    # sharedseed + --model M > 1: probe whether the plan stays
    # packed-resident with a declared model axis (slab-sharded packed
    # theta); if it cannot, keep the pjit-style declaration: leaf shards
    model_axis = None
    if model > 1 and mode == "sharedseed":
        probe = steplib.make_subspace_optimizer(
            net, tcfg, transform, axis_name, k_workers=k_workers,
            model_sharded=True, model_axis="model", model_shards=model,
            device=device, resilience=resilience)
        if probe.plan_execution().packed_resident:
            model_axis = mesh.model_group
    if axis_name is not None:
        axis_name = mesh.data_group
    leaf_shards = None
    if model > 1 and model_axis is None:
        leaf_shards = registry.leaf_shards(net, model, mesh.model_index,
                                           mesh.model_group)
    # pjit over several data ranks: the dense gradient's mean over data
    dense_grad_axis = (mesh.data_group if mode == "pjit" and data > 1
                       else None)
    return dict(axis_name=axis_name, k_workers=k_workers,
                model_sharded=model_sharded, model_axis=model_axis,
                leaf_shards=leaf_shards, dense_grad_axis=dense_grad_axis)


def _run(cfg, *, mode, rbd_mode, data, model, mesh, steps, batch, seq,
         grad_accum_steps, lr, rbd_dim, normalization, rbd_backend, packed,
         prng_impl, basis, basis_refresh_every, optimizer, weight_decay,
         momentum_beta, nesterov, adam_b1, adam_b2, adam_eps, device,
         kernel_times, resilience, resume, checkpoint_dir) -> RunResult:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import distributed
    from repro_torch.core import resilience as res_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import registry
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib
    from repro_torch.train.loop import BasisCollector

    rank = dist.get_rank()
    net = get_model(cfg)
    rbd_cfg = RBDConfig(enabled=(mode != "sgd"), total_dim=rbd_dim,
                        mode=rbd_mode, normalization=normalization,
                        backend=rbd_backend, packed=packed,
                        prng_impl=prng_impl, basis=basis,
                        basis_refresh_every=basis_refresh_every)
    tcfg = TrainConfig(model=cfg, rbd=rbd_cfg, learning_rate=lr,
                       steps=steps, batch_size=batch, seq_len=seq,
                       grad_accum_steps=grad_accum_steps,
                       optimizer=optimizer, weight_decay=weight_decay,
                       momentum_beta=momentum_beta, nesterov=nesterov,
                       adam_b1=adam_b1, adam_b2=adam_b2, adam_eps=adam_eps)
    transform = steplib.make_transform(net, rbd_cfg)
    route = step_route(net, tcfg, transform, mode=mode, mesh=mesh,
                       device=device, resilience=resilience)
    axis_name, model_axis = route["axis_name"], route["model_axis"]
    leaf_shards = route["leaf_shards"]
    init_state, train_step, sub_opt = steplib.make_train_step(
        net, tcfg, transform, model_shards=model, device=device,
        return_optimizer=True, resilience=resilience, **route)
    eplan = sub_opt.plan_execution()
    n_accum = max(1, int(grad_accum_steps))

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    say(f"update path: {eplan.strategy} -- {eplan.reason}")
    if rbd_cfg.enabled:
        say(f"basis: {eplan.basis} -- {eplan.basis_reason}")
        say(f"prng impl: {eplan.prng_impl} -- {eplan.prng_reason}")
        say(f"exchange schedule: {eplan.overlap_exchange} -- "
            f"{eplan.overlap_reason}")
        if n_accum > 1:
            say(f"grad accumulation: {n_accum} microbatches/optimizer "
                f"step, 1 exchange per optimizer step (not {n_accum})")
    if model_axis is not None:
        slayout = sub_opt.sharded_layout()
        say(f"model-sharded slabs: {model} per model group, q_slab "
            f"{slayout.q_slab:,} (q_padded {slayout.q_padded:,}, q_packed "
            f"{slayout.base.q_packed:,}); this rank's slab "
            f"{mesh.model_index}")
    if leaf_shards is not None:
        from repro_torch.sharding import rules

        cut = ", ".join(f"{k} on {d}" for k, d in leaf_shards.dims.items())
        say(f"model-sharded leaves: "
            f"{rules.layout_policy(net.param_shapes(), cfg)} layout, "
            f"{len(leaf_shards.dims)} of {len(leaf_shards.shapes)} leaves "
            f"cut over a model group of {model} ({cut or 'none'}); this "
            f"rank's part {mesh.model_index}")
    resilient = resilience is not None and resilience.any_enabled
    if resilient:
        say("resilience: "
            f"guard={'on' if resilience.guard else 'off'} "
            f"sentinel_every={resilience.sentinel_every} "
            f"replay_log={'on' if resilience.directory else 'off'} "
            f"snapshot_every={resilience.snapshot_every} "
            f"on_divergence={resilience.on_divergence}")

    cuda = device.type == "cuda"
    state = init_state(tcfg.seed)
    theta_init_sum = params_sum(
        state.params if leaf_shards is None
        else registry.gather_params(state.params, leaf_shards))
    monitor = recovery = None
    start = 0
    if resilient:
        if resume and resilience.directory:
            before = dict(rbd_step.LAUNCHES)
            recovered, recovery = res_lib.recover(resilience, sub_opt, state)
            recovery["launches"] = {
                k: n - before.get(k, 0)
                for k, n in rbd_step.LAUNCHES.items()}
            if recovered is not None:
                state = recovered
                start = int(state.step)
                say(f"recovered to step {start} (snapshot "
                    f"{recovery['snapshot_step']}, replayed "
                    f"{recovery['replayed']} records)")
                for ev in recovery["events"]:
                    say(f"[resilience] step {ev.step}: "
                        f"{res_lib.reason_name(ev.reason)} -- {ev.detail}")
        monitor = res_lib.ResilienceMonitor(resilience, sub_opt)
    repair = (resilient and resilience.on_divergence == "repair"
              and axis_name is not None)
    # materialized BasisSpecs: the host-side snapshot ring and its periodic
    # refresh (None on the random path)
    collector = BasisCollector.build(sub_opt, tcfg)
    stream = synthetic.lm_batches(tcfg.seed, batch, seq, cfg.vocab,
                                  device=device)
    # keep the data stream step-aligned on resume: each optimizer step
    # consumed n_accum batches (an O(1) counter skip)
    stream.skip(start * n_accum)

    def fetch():
        # sharded over data, the same on every rank of a model group
        if n_accum == 1:
            return meshlib.shard_batch(next(stream), mesh.data_index, data)
        return meshlib.shard_batch(steplib.stack_microbatches(
            [next(stream) for _ in range(n_accum)]), mesh.data_index, data,
            axis=1)

    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if kernel_times:
        rbd_step.set_timing(True)
    distributed.reset_counts()
    losses, step_seconds = [], []
    t0 = time.time()
    try:
        for i in range(start, steps):
            t_step = time.perf_counter()
            if monitor is not None and monitor.should_kill(i):
                raise res_lib.SimulatedWorkerKill(f"fault plan kills step {i}")
            before = dict(rbd_step.VARIANT_LAUNCHES)
            state, metrics = train_step(state, fetch())
            if collector is not None:
                refreshes = collector.refreshes
                state = collector.observe(state, metrics, i)
                if collector.refreshes > refreshes:
                    say(f"basis refresh {collector.refreshes} after step {i} "
                        f"({collector.spec})")
            losses.append(float(metrics["loss"]))
            step_seconds.append(time.perf_counter() - t_step)
            if i == start and rbd_cfg.enabled:
                # the kernel variants (PRNG impl, double buffer) step 0 ran
                took = [k for k, n in rbd_step.VARIANT_LAUNCHES.items()
                        if n > before.get(k, 0)]
                if took:
                    say(f"prng kernels: {', '.join(took)} (launched in step "
                        f"{i})")
            if monitor is not None:
                events = monitor.observe(state, metrics)
                for ev in events:
                    say(f"[resilience] step {ev.step}: "
                        f"{res_lib.reason_name(ev.reason)} -- {ev.detail}")
                diverged = any(e.reason == res_lib.REASON_REPLICA_DIVERGENCE
                               for e in events)
                if repair and diverged:
                    # reason-coded repair: every state buffer re-broadcast
                    # from rank 0 of the data group (only on a detection;
                    # the per-step exchange stays one collective)
                    state = res_lib.resync_from_worker0(state, axis_name)
                    monitor.events.append(res_lib.RecoveryEvent(
                        i, res_lib.REASON_RESYNC,
                        "state re-broadcast from worker 0"))
                    say(f"[resilience] step {i}: resync -- state "
                        "re-broadcast from worker 0")
            say(f"step {i} loss={losses[-1]:.4f} "
                f"wall={time.time() - t0:.1f}s")
    finally:
        if monitor is not None and monitor.log is not None:
            monitor.log.close()
    collectives = dict(distributed.COLLECTIVES)
    say(f"collectives: {collectives} over {steps - start} steps (the "
        "coordinate exchange or the SGD baseline's gradient mean, plus the "
        "scalar loss mean)")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kernel_ms = {}
    if kernel_times:
        kernel_ms = rbd_step.kernel_times_ms()
        rbd_step.set_timing(False)
        for name, times in kernel_ms.items():
            if times:
                med = sorted(times)[len(times) // 2]
                say(f"kernel {name}: launches={len(times)} "
                    f"median_ms={med:.3f}")
        say(f"peak device memory: {peak / 2**30:.2f} GiB")
    if checkpoint_dir:
        from repro_torch.checkpoint import io as ckpt

        # the parameters as a map (nested at "/": the reference's tree and
        # keys), whatever the stored representation; leaf shards are
        # gathered first, by every rank of the model group
        params = sub_opt.materialize_params(state.params)
        if leaf_shards is not None:
            params = registry.gather_params(params, leaf_shards)
        if rank == 0:
            ckpt.save(checkpoint_dir, state._replace(
                params=nest_params(params)), steps)
            say(f"checkpoint saved to {checkpoint_dir}")
    return RunResult(state, losses, theta_init_sum, sub_opt, peak,
                     kernel_ms, collectives, monitor, recovery, collector,
                     step_seconds)


def nest_params(params: dict) -> dict:
    """``{"layers/attn/wq": x, ...}`` -> ``{"layers": {"attn": {"wq": x}}}``
    (the reference's parameter tree)."""
    out: dict = {}
    for name, x in params.items():
        node = out
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def params_sum(params) -> float:
    """float64 sum of the stored parameters (the packed buffer or every
    leaf of the parameter map)."""
    from repro_torch.optim.transforms import leaves

    return float(sum(x.double().sum() for x in leaves(params)))


if __name__ == "__main__":
    main()
