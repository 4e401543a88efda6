"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --mode sharedseed --data 1 --rbd-backend cuda --rbd-dim 1024 \\
        --batch 8 --seq 128 --steps 3

Flag names are the reference's for what this slice runs: one device
(``--mode sharedseed --data 1``), the shared basis, and the packed
two-launch step (``--rbd-backend cuda``, where the reference says
``pallas``).  With one device there is no coordinate exchange, so the
step runs with ``axis_name=None``.  The data-parallel exchange
(``--data N > 1``), ``--mode pjit`` and ``--mode sgd`` raise, naming
their ROADMAP item.  Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple


class RunResult(NamedTuple):
    state: Any                 # final TrainState
    losses: list[float]        # per-step loss
    theta_init_sum: float      # float64 sum of the initial packed buffer
    sub_opt: Any               # the SubspaceOptimizer
    peak_bytes: int            # torch.cuda.max_memory_allocated (0 on CPU)
    kernel_ms: dict            # per-launch ms by kernel (--kernel-times)


def main(argv=None) -> RunResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="sharedseed",
                    choices=["pjit", "sharedseed", "sgd"])
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel workers (only 1 is ported)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.125)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam"],
                    help="coordinate-space optimizer; state lives on the "
                         "packed (d,) buffer, still two launches per step")
    ap.add_argument("--rbd-dim", type=int, default=1024)
    ap.add_argument("--normalization", default="rsqrt_dim",
                    choices=["rsqrt_dim", "exact", "none", "orthonormal"])
    ap.add_argument("--rbd-backend", default="torch",
                    choices=["torch", "cuda"],
                    help="cuda: the hand-written Hopper kernels; torch: "
                         "their plain PyTorch versions")
    ap.add_argument("--packed", default="auto",
                    choices=["auto", "on", "off"],
                    help="packed two-launch step (auto: on for cuda)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time every kernel launch with CUDA events and "
                         "print launches, median ms and peak memory")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(compute_dtype="float32")
    return run_training(
        cfg, mode=args.mode, data=args.data, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, rbd_dim=args.rbd_dim,
        normalization=args.normalization, rbd_backend=args.rbd_backend,
        packed=args.packed, optimizer=args.optimizer, device=args.device,
        kernel_times=args.kernel_times)


def run_training(cfg, *, mode="sharedseed", data=1, steps=10, batch=8,
                 seq=128, lr=0.125, rbd_dim=1024, normalization="rsqrt_dim",
                 rbd_backend="torch", packed="auto", optimizer="sgd",
                 device="cuda", kernel_times=False) -> RunResult:
    import torch

    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_step
    from repro_torch.models.registry import get_model, resolve_device
    from repro_torch.train import step as steplib

    if mode != "sharedseed":
        raise NotImplementedError(
            f"--mode {mode} is not ported yet (ROADMAP.md Queue A "
            f"{'14' if mode == 'pjit' else '16'}); use --mode sharedseed")
    if data != 1:
        raise NotImplementedError(
            "--data > 1 needs the coordinate exchange over "
            "torch.distributed, not ported yet (ROADMAP.md Queue A 11)")
    device = resolve_device(device)
    model = get_model(cfg)
    rbd_cfg = RBDConfig(total_dim=rbd_dim, normalization=normalization,
                        backend=rbd_backend, packed=packed)
    tcfg = TrainConfig(model=cfg, rbd=rbd_cfg, learning_rate=lr,
                       steps=steps, batch_size=batch, seq_len=seq,
                       optimizer=optimizer)
    transform = steplib.make_transform(model, rbd_cfg)
    init_state, train_step, sub_opt = steplib.make_train_step(
        model, tcfg, transform, axis_name=None, device=device,
        return_optimizer=True)
    eplan = sub_opt.plan_execution()
    print(f"update path: {eplan.strategy} -- {eplan.reason}", flush=True)
    print(f"basis: {eplan.basis} -- {eplan.basis_reason}", flush=True)
    print(f"prng impl: {eplan.prng_impl} -- {eplan.prng_reason}",
          flush=True)
    print(f"exchange schedule: {eplan.overlap_exchange} -- "
          f"{eplan.overlap_reason}", flush=True)

    cuda = device.type == "cuda"
    state = init_state(tcfg.seed)
    theta_init_sum = float(state.params.double().sum())
    stream = synthetic.lm_batches(tcfg.seed, batch, seq, cfg.vocab,
                                  device=device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if kernel_times:
        rbd_step.set_timing(True)
    losses = []
    t0 = time.time()
    for i in range(steps):
        state, metrics = train_step(state, next(stream))
        losses.append(float(metrics["loss"]))
        print(f"step {i} loss={losses[-1]:.4f} "
              f"wall={time.time() - t0:.1f}s", flush=True)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kernel_ms = {}
    if kernel_times:
        kernel_ms = rbd_step.kernel_times_ms()
        rbd_step.set_timing(False)
        for name, times in kernel_ms.items():
            if times:
                med = sorted(times)[len(times) // 2]
                print(f"kernel {name}: launches={len(times)} "
                      f"median_ms={med:.3f}", flush=True)
        print(f"peak device memory: {peak / 2**30:.2f} GiB", flush=True)
    return RunResult(state, losses, theta_init_sum, sub_opt, peak,
                     kernel_ms)


if __name__ == "__main__":
    main()
