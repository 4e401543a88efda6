"""Serve a small model to multiple tenants: continuous batching plus
per-tenant (base_seed, coords) subspace adapters.

Part 1 is single-tenant batched generation (prefill -> KV-cached decode).
Part 2 is the adapter subsystem end to end:

* two tenants' adapters are built, exported to disk (kilobytes each,
  CRC-sidecar verified) and imported back;
* a MultiTenantEngine with 2 decode slots serves three requests --
  tenant A, tenant B (sampled), and a base-model request that waits in
  the admit queue until continuous batching frees a slot;
* both tenants are personalized by ONE launch of the adapter apply
  kernel (their bases regenerate from their seeds), the deltas land in
  the LRU cache, and a second round of requests hits the cache instead
  of regenerating.

Run (on the card; ``--device cpu`` runs the kernels' plain versions;
``--arch`` any ported decoder family, at its reduced size):

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu] \
        [--arch tinyllama-1.1b]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import compartments
from repro_torch.kernels import rbd_step
from repro_torch.models.registry import get_model
from repro_torch.serve.adapters import (AdapterCache, AdapterRegistry,
                                        AdapterSpec)
from repro_torch.serve.engine import Engine, MultiTenantEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def single_tenant_demo(cfg, model, params, device):
    engine = Engine(model, params, max_len=128)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (8, 16))
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_tokens=32)
    _sync(device)
    t1 = time.perf_counter()
    print(f"generated {tuple(out.shape)} tokens in {t1 - t0:.2f}s "
          f"({out.numel() / (t1 - t0):.1f} tok/s incl. warm-up)")
    out2 = engine.generate(prompts, n_tokens=32)
    _sync(device)
    t2 = time.perf_counter()
    assert torch.equal(out, out2), "greedy decode must be deterministic"
    print(f"second batch: {out.numel() / (t2 - t1):.1f} tok/s")
    print("sample continuation:", out[0, :16].tolist())


def multi_tenant_demo(cfg, model, params, device):
    plan = compartments.make_plan(model.param_shapes(), 256,
                                  granularity="layer",
                                  is_stacked=model.is_stacked)
    layout = plan.packed()

    # two tenants: in production these coords come out of RBD
    # fine-tuning; here they are synthetic small perturbations
    rs = np.random.default_rng(0)
    registry = AdapterRegistry()
    for name, seed in (("alice", 41), ("bob", 42)):
        registry.register(AdapterSpec(
            name, seed, 0.05 * rs.normal(size=layout.d_packed)))

    # kilobyte-scale export/import roundtrip (CRC-sidecar verified)
    with tempfile.TemporaryDirectory() as d:
        paths = registry.export_all(d)
        sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
        print(f"exported adapters: {sizes} bytes on disk "
              f"(dense delta would be {4 * plan.total_params:,} bytes)")
        registry2 = AdapterRegistry()
        for name in registry.ids():
            registry2.import_adapter(d, name)

    cache = AdapterCache(budget_bytes=8 * 4 * layout.q_packed)
    engine = MultiTenantEngine(model, params, plan, registry=registry2,
                               delta_cache=cache, n_slots=2, max_len=64,
                               layout=layout)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 12))

    def submit_round():
        rids = {
            "alice": engine.submit(prompts[0], 12, adapter_id="alice"),
            "bob": engine.submit(prompts[1], 12, adapter_id="bob",
                                 temperature=0.7, seed=7),
            "base": engine.submit(prompts[2], 8),  # queued: slots full
        }
        return rids, engine.run()

    rbd_step.reset_counts()
    t0 = time.perf_counter()
    rids, results = submit_round()
    t1 = time.perf_counter()
    for who, rid in rids.items():
        print(f"  {who:>6s}: {results[rid].tolist()}")
    n_tok = sum(len(v) for v in results.values())
    print(f"round 1: {n_tok} tokens in {t1 - t0:.2f}s, "
          f"engine stats {engine.stats}")
    print(f"         cache stats {cache.stats()}")
    print(f"         adapter kernel launches "
          f"{rbd_step.LAUNCHES['reconstruct_apply_packed_adapters']} "
          f"(wrapper calls {rbd_step.CALLS['reconstruct_apply_packed_adapters']})")
    assert engine.stats["fused_launches"] == 1, \
        "both tenants must personalize in ONE fused launch"

    rids2, results2 = submit_round()
    t2 = time.perf_counter()
    for who in ("alice", "bob"):
        assert (results2[rids2[who]] == results[rids[who]]).all(), \
            "same tenant + same seed must reproduce bit for bit"
    assert engine.stats["fused_launches"] == 1, \
        "the second round must take the cache-hit path"
    print(f"round 2 (cache-hit personalization): {t2 - t1:.2f}s, "
          f"cache stats {cache.stats()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="a ported decoder family (served at its reduced "
                         "size)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced(compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device=args.device)
    device = next(iter(params.values())).device
    n = sum(x.numel() for x in params.values())
    print(f"serving {cfg.name} on {device}: D={n:,} params, "
          f"vocab={cfg.vocab}")
    with torch.no_grad():
        print("\n-- single tenant, batched prompts --")
        single_tenant_demo(cfg, model, params, device)
        print("\n-- multi-tenant: subspace adapters + continuous batching --")
        multi_tenant_demo(cfg, model, params, device)


if __name__ == "__main__":
    main()
