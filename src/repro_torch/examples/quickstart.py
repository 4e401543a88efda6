"""Quickstart: train a small model in a 400x smaller random subspace.

The paper's core move on the FC architecture (D = 101,770 parameters): a
d = 250 random basis over the whole flattened network, redrawn every step
(RBD), 'exact' normalization, plain SGD at lr 2.0 on mixture images of
28 x 28 x 1 (batch 32, noise 1.0), evaluated every 50 steps on 2,048
images.  It drives the same ``SubspaceOptimizer`` as the launcher; on the
card the step is one ``project_flat`` and one reconstruction launch
(``fused_per_leaf``; a flattened plan reconstructs, then subtracts, as
the reference's ``reconstruct_apply`` does).

Run (on the card; ``--device cpu`` runs the kernels' plain versions):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] \
        [--steps N]

``python -m repro_torch.launch.train --arch qwen2-0.5b`` runs the
scaled-up version: the packed two-launch step on a transformer.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.compartments import make_plan
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.data import synthetic
from repro_torch.launch.train import resolve_backend
from repro_torch.models import vision
from repro_torch.models.registry import resolve_device
from repro_torch.optim.subspace import SubspaceOptimizer

SHAPE = (28, 28, 1)
D_TOTAL = 250
LR = 2.0            # paper table 4: RBD lr = 2^1 for FC-MNIST
BATCH = 32
NOISE = 1.0
STEPS = 300
EVAL_EVERY = 50
EVAL_IMAGES = 2048
EVAL_SEED = 999     # the evaluation images' generator (a torch.Generator:
                    # not the reference's images, ROADMAP.md Queue C 21)


def cross_entropy(apply, params, x, y):
    logp = torch.log_softmax(apply(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None])[:, 0])


def make_step(apply, sub):
    """One quickstart step: the loss and its gradient by autograd, then
    ``sub.step`` (sketch -> coordinate optimizer -> apply)."""

    def train_step(params, rbd_state, opt_state, x, y):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = cross_entropy(apply, leaves, x, y)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        with torch.no_grad():
            params, rbd_state, opt_state, _ = sub.step(params, grads,
                                                       rbd_state, opt_state)
        return params, rbd_state, opt_state, loss.detach()

    return train_step


def main(argv=None, *, params=None, backend="auto") -> dict:
    """Run the quickstart.  ``params``: initial FC parameters (a map, e.g.
    the reference's through ``registry.params_from_reference``), else a
    fresh init from seed 0.  ``backend``: the transform's, resolved by
    ``launch.train.resolve_backend`` (auto: the kernels on a card, their
    plain versions on the CPU).  Returns ``losses`` (every step),
    ``accuracy`` ({step: validation accuracy}), the final ``params``, the
    ``plan``, the execution plan ``eplan`` and ``wall`` (seconds of the
    steps and evaluations, synchronized)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    backend = resolve_backend(backend, device)

    init, apply = vision.get_vision_model("fc")
    if params is None:
        params = init(0, SHAPE, device=device)
    params = {k: v.to(device) for k, v in params.items()}
    n_params = vision.count_params(params)
    print(f"FC model: D={n_params:,} parameters, training in d={D_TOTAL} "
          f"random dimensions ({n_params / D_TOTAL:.0f}x reduction)")

    plan = make_plan(params, D_TOTAL, granularity="global",
                     normalization="exact")
    # the one update-path abstraction: sketch -> coordinate-space
    # optimizer (sgd here) -> apply
    sub = SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=0, redraw=True,
                                       backend=backend),
        learning_rate=LR, device=device)
    eplan = sub.check_supported()
    print(f"update path: {eplan.strategy} -- {eplan.reason}")
    train_step = make_step(apply, sub)

    def accuracy(p, x, y):
        with torch.no_grad():
            return torch.mean((torch.argmax(apply(p, x), -1) == y).to(
                torch.float32))

    data = synthetic.mixture_dataset(0, BATCH, shape=SHAPE, noise=NOISE,
                                     device=device)
    xe, ye = synthetic.mixture_images(
        torch.Generator().manual_seed(EVAL_SEED), EVAL_IMAGES, shape=SHAPE,
        noise=NOISE, device=device)

    rbd_state = sub.init_rbd_state(params)
    opt_state = sub.init_opt_state(params)
    losses, accs = [], {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for step in range(args.steps):
        x, y = next(data)
        params, rbd_state, opt_state, loss = train_step(
            params, rbd_state, opt_state, x, y)
        losses.append(loss)
        if step % EVAL_EVERY == 0 or step == args.steps - 1:
            accs[step] = float(accuracy(params, xe, ye))
            print(f"step {step:4d}  loss {float(loss):.4f}  "
                  f"val acc {accs[step]:.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    print("\nThe same transform with redraw=False is Li et al.'s FPD.\n"
          "Scaling up: repro_torch.launch.train runs this update path "
          "packed (two kernel launches a step) on a transformer.")
    return {"losses": [float(x) for x in losses], "accuracy": accs,
            "params": params, "plan": plan, "eplan": eplan, "wall": wall}


if __name__ == "__main__":
    main()
