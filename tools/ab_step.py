"""Time qwen2-0.5b's packed train step and its prefill in this checkout
against another checkout of the port, on one CUDA card.

    python3 tools/ab_step.py DIR

DIR is the root of the other checkout (its ``src/repro_torch``).  Each
run is a process of its own, in turns: DIR, this checkout, this checkout
with the per-layer recompute of ``transformer.forward`` turned off, the
same again in reverse order.  A run reports, at qwen2-0.5b's full width
and depth: the import of ``torch._dynamo`` (which the first
``torch.utils.checkpoint`` call pays where nothing imported it before),
the packed step (shared basis, Threefry, rbd-dim 1024, batch 8 x 128)
the first time and its median over four more, and a bf16 prefill of
8,192 tokens through the flash kernel beside the same layers through the
blockwise function (CUDA events), with the host's time to issue the
prefill.  Prints one JSON line a run and the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, RBD_DIM, STEPS = 8, 128, 1024, 5
PREFILL_LEN = 8192


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def worker(root: str, remat: bool) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.train import step as steplib

    t = time.perf_counter()
    import torch._dynamo  # noqa: F401  (timed apart from the first step)
    t_dynamo = time.perf_counter() - t
    if not remat:
        transformer.checkpoint = lambda fn, *a, **k: fn(*a)
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=RBD_DIM,
                                                backend="cuda"),
                       learning_rate=0.1, steps=STEPS, batch_size=B,
                       seq_len=S)
    init_state, train_step = steplib.make_train_step(model, tcfg,
                                                     device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(0)
    walls = []
    for _ in range(STEPS):
        tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                               device="cuda")
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    torch.cuda.reset_peak_memory_stats()
    state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state

    params = model.init(0, device="cuda")
    cp = {k: v.to(torch.bfloat16) for k, v in params.items()}
    prompt = torch.randint(0, cfg.vocab, (1, PREFILL_LEN), generator=gen,
                           device="cuda")

    def events(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    prefill, host, flash_ms, block_ms = [], [], [], []
    with torch.no_grad():
        transformer.prefill(cfg, cp, prompt, PREFILL_LEN)
        for _ in range(3):
            t = time.perf_counter()
            prefill.append(events(lambda: transformer.prefill(
                cfg, cp, prompt, PREFILL_LEN)))
            host.append(1e3 * (time.perf_counter() - t))
            flash_ms.append(events(lambda: transformer._run_prompt(
                cfg, cp, prompt, flash.flash_attention)))
            block_ms.append(events(lambda: transformer._run_prompt(
                cfg, cp, prompt, attn.flash_attention)))
    return {"dynamo_import_s": t_dynamo, "first_step_s": walls[0],
            "step_s": _median(walls[1:]), "steps_s": walls,
            "train_peak_gib": peak, "prefill_ms": _median(prefill),
            "prefill_host_ms": _median(host),
            "layers_flash_ms": _median(flash_ms),
            "layers_blockwise_ms": _median(block_ms)}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2], sys.argv[3] == "remat")),
              flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ab_step: no CUDA card", file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    runs = [("other", other, "remat"), ("this", HERE, "remat"),
            ("this, no recompute", HERE, "none")]
    for name, root, remat in runs + runs[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root, remat], check=True,
                             capture_output=True, text=True).stdout
        print(json.dumps({"run": name, **json.loads(out.splitlines()[-1])}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
