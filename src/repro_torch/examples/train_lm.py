"""End-to-end driver: train a ~100M-parameter LM with shared-seed RBD on
synthetic data.

A real transformer (the qwen2 family cut to 8 layers of width 512,
vocabulary 32,000, f32) with the paper's technique as the gradient
stage: data-parallel workers exchange d-dimensional coordinates instead
of D-dimensional gradients.  It prints D, d and the reduction factor and
the per-step gradient traffic of the three modes, then trains through
``repro_torch.launch.train.run_training``.

Run on one card (the packed two-launch step):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --workers 1

``--workers N`` needs a ``torchrun`` world of N ranks, as the launcher's
``--data`` does; on the CPU (gloo, the kernels' plain versions -- slow at
this size, so cut the dimensions; one step takes minutes):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
        repro_torch.examples.train_lm --device cpu --workers 4 \\
        --steps 1 --batch 4 --seq 16 --rbd-dim 64
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig
from repro_torch.core.distributed import grad_comm_bytes
from repro_torch.models.registry import get_model
from repro_torch.train.step import make_plan

COMM_MODES = ("sgd", "shared_basis", "independent_bases")
BATCH, SEQ = 16, 256   # the defaults of --batch and --seq
LR = 0.5


def qwen2_100m():
    """The ~100M-parameter member of the qwen2 family."""
    return dataclasses.replace(
        get_config("qwen2-0.5b"),
        name="qwen2-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=2, d_head=64, d_ff=2048, vocab=32_000,
        compute_dtype="float32",
    )


def preamble(cfg, rbd_dim: int, workers: int) -> dict:
    """D, the plan at ``rbd_dim`` and the three modes' traffic
    (``grad_comm_bytes``), with the lines the driver prints."""
    model = get_model(cfg)
    n_params = int(sum(np.prod(s, dtype=np.int64)
                       for s in model.param_shapes().values()))
    plan = make_plan(model, RBDConfig(total_dim=rbd_dim))
    comm = {m: grad_comm_bytes(plan, n_params, workers, m)
            for m in COMM_MODES}
    lines = [f"model D={n_params / 1e6:.1f}M params; RBD d={plan.total_dim} "
             f"({plan.reduction_factor:.0f}x reduction)"]
    lines += [f"  per-step gradient traffic [{m:18s}]: "
              f"{c['bytes_per_step'] / 1e6:10.3f} MB" for m, c in comm.items()]
    return {"n_params": n_params, "plan": plan, "comm": comm, "lines": lines}


def main(argv=None) -> dict:
    """Returns the preamble (:func:`preamble`) and the launcher's
    ``RunResult`` under ``result``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4,
                    help="data-parallel ranks; must equal the torchrun "
                         "world size")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--rbd-dim", type=int, default=4096)
    ap.add_argument("--mode", default="sharedseed",
                    choices=["sharedseed", "pjit", "sgd"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs gloo ranks "
                         "and the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.launch import train as launcher

    cfg = qwen2_100m()
    pre = preamble(cfg, args.rbd_dim, args.workers)
    if int(os.environ.get("RANK", "0")) == 0:
        print("\n".join(pre["lines"]), flush=True)
    result = launcher.run_training(
        cfg, mode=args.mode, data=args.workers, model=1, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=LR, rbd_dim=args.rbd_dim,
        device=args.device)
    return {**pre, "result": result}


if __name__ == "__main__":
    main()
