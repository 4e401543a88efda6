"""Host microseconds a kernel wrapper call in this checkout against
another checkout of the port, on one CUDA card.

    python3 tools/host_cost.py DIR

DIR is the root of the other checkout (its ``src/repro_torch``).  Each
run is a process of its own, in turns: DIR, this checkout, this
checkout, DIR.  A run times, with the stream stalled behind
``torch.cuda._sleep`` so the device's work does not hold the host, the
host's issue of one call of each wrapper: ``rbd_step.project_packed`` and
``reconstruct_apply_packed`` (in place) at qwen2-0.5b's packed layout at
rbd-dim 1024 (phase 4's step), ``rbd_project.project_flat`` and
``rbd_reconstruct.reconstruct_flat`` at the FC image model's largest
leaf (28 x 28 x 1, rbd-dim 128), and ``projector.rbd_gradient`` over all
of FC's leaves; then FC's whole step (loss, gradient, the sketch, the
update; synchronized) as phase 21 runs it.  Medians of ROUNDS rounds of
REPS calls.  Prints one JSON line a run and the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS, ROUNDS = 50, 5
SLEEP_CYCLES = 20_000_000


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig
    from repro_torch.core import compartments, projector, rng
    from repro_torch.core.rbd import RandomBasesTransform
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step
    from repro_torch.models import vision
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    def host_us(fn, reps=REPS):
        out = []
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t) / reps * 1e6)
            torch.cuda.synchronize()
        return _median(out)

    rbd_step.libraries()
    plan = steplib.make_plan(get_model(get_config("qwen2-0.5b")),
                             RBDConfig(total_dim=1024))
    lay = plan.packed()
    seeds = projector.segment_seeds(plan, rng.fold_seed(3))
    theta = torch.zeros((lay.q_packed,), device="cuda")
    scale = torch.zeros((lay.d_packed,), device="cuda")
    res = {
        "project_packed": host_us(
            lambda: rbd_step.project_packed(seeds, theta, lay), reps=10),
        "reconstruct_apply_packed": host_us(
            lambda: rbd_step.reconstruct_apply_packed(
                seeds, scale, theta, lay, out=theta), reps=10),
    }
    del theta
    init, apply = vision.get_vision_model("fc")
    shape = (28, 28, 1)
    params = init(0, shape)
    fplan = compartments.make_plan(params, 128)
    t = RandomBasesTransform(fplan, 0, backend="cuda")
    lp = max(fplan.leaves, key=lambda x: x.size)
    fseeds = projector._leaf_seeds(t.step_seed(0), lp)
    g = torch.zeros((lp.n_stack, lp.size), device="cuda")
    sc = torch.zeros((lp.n_stack, lp.dim), device="cuda")
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    res.update({
        "project_flat": host_us(
            lambda: rbd_project.project_flat(fseeds, g, lp.dim)),
        "reconstruct_flat": host_us(
            lambda: rbd_reconstruct.reconstruct_flat(fseeds, sc, lp.size)),
        "fc_rbd_gradient": host_us(
            lambda: projector.rbd_gradient(grads, fplan, t.step_seed(0),
                                           backend="cuda"), reps=10),
    })
    data = synthetic.mixture_dataset(0, 32, shape=shape, device="cuda")
    walls = []
    for step in range(30):
        x, y = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = torch.nn.functional.cross_entropy(apply(p, x), y)
        gr = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        sk = projector.rbd_gradient(gr, fplan, t.step_seed(step),
                                    backend="cuda")
        with torch.no_grad():
            params = {k: v.detach() - 0.1 * sk[k] for k, v in p.items()}
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    res["fc_step_ms"] = _median(walls[5:])
    res["fc_leaves"] = len(fplan.leaves)
    return {k: round(v, 2) if isinstance(v, float) else v
            for k, v in res.items()}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("host_cost: no CUDA card", file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    runs = [("other", other), ("this", HERE)]
    for name, root in runs + runs[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], check=True,
                             capture_output=True, text=True).stdout
        print(json.dumps({"run": name, **json.loads(out.splitlines()[-1])}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
