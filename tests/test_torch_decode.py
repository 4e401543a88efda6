"""Port parity of the decode path and the serving engines: ``prefill`` and
``decode_step`` (logits and the KV cache) on the reduced qwen2-0.5b and
tinyllama-1.1b, greedy ``Engine.generate``, sampled generation and EOS
padding, and the two-tenant ``MultiTenantEngine`` of tests/test_serve.py
-- against ``repro.models.transformer`` and ``repro.serve.engine`` with
the reference's parameters carried across (float32 compute).

Tolerances: logits and the K/V cache within 1e-5 of their largest
magnitude (float32 matmuls, RoPE cos/sin and softmax accumulate in
another order; the decode steps read the cache the prefill wrote, so the
error does not grow with the step count at this depth).  Greedy tokens are
compared exactly, after asserting that along the reference's greedy path
the top-1/top-2 logit margin exceeds that tolerance -- otherwise an
argmax could flip within it.  Sampled tokens (temperature > 0) come from
a ``torch.Generator`` and cannot equal ``jax.random``'s: they are held to
determinism only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import compartments as ref_comp
from repro.models import get_model as ref_model
from repro.models import transformer as ref_tf
from repro.serve import adapters as ref_adapters
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.core import compartments
from repro_torch.kernels import rbd_step
from repro_torch.models import transformer
from repro_torch.models.registry import get_model, params_from_reference
from repro_torch.serve.adapters import (AdapterCache, AdapterRegistry,
                                        AdapterSpec)
from repro_torch.serve.engine import Engine, MultiTenantEngine

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ARCHS = ["qwen2-0.5b", "tinyllama-1.1b"]
RTOL = 1e-5        # of the largest magnitude, logits and K/V
MAX_LEN = 24


def _setup(arch):
    cfg = ref_config(arch).reduced(compute_dtype="float32")
    model = ref_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    named = {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}
    port = get_model(get_config(arch).reduced(compute_dtype="float32"))
    return cfg, model, params, port, params_from_reference(named,
                                                           device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param, *_setup(request.param))


def _close(got, want, what):
    want = np.asarray(want)
    tol = RTOL * np.abs(want).max()
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol, f"{what}: max|d| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("window,flag", [(None, None), (3, None),
                                         (3, True), (3, False)])
def test_decode_attention_matches_reference(window, flag):
    from repro.models import attention as ref_attn
    from repro_torch.models import attention

    rs = np.random.default_rng(4)
    q = rs.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k, v = (rs.standard_normal((2, 10, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.int32(6),
                                     window=window, window_flag=flag)
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(6, dtype=torch.int32), window=window, window_flag=flag)
    assert got.shape == (2, 1, 4, 8)
    _close(got.numpy(), want, "decode attention")


def test_prefill_and_teacher_forced_decode_match(arch):
    _, cfg, _, params, port, tp = arch
    rs = np.random.default_rng(1)
    prompt = rs.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    forced = rs.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    ref_logits, ref_cache = ref_tf.prefill(cfg, params, jnp.asarray(prompt),
                                           MAX_LEN)
    empty = port.init_cache(2, MAX_LEN, device="cpu")
    assert {k: (tuple(x.shape), str(x.dtype).split(".")[-1])
            for k, x in empty.items()} == {
        k: (x.shape, str(x.dtype))
        for k, x in ref_tf.init_cache(cfg, 2, MAX_LEN).items()}
    with torch.no_grad():
        logits, cache = transformer.prefill(port.cfg, tp,
                                            torch.from_numpy(prompt),
                                            MAX_LEN)
        assert logits.shape == (2, 1, cfg.vocab)
        assert logits.dtype == torch.float32
        _close(logits.numpy(), ref_logits, "prefill logits")
        assert cache["len"].dtype == torch.int32 and int(cache["len"]) == 8
        for k in ("k", "v"):
            assert tuple(cache[k].shape) == ref_cache[k].shape == (
                cfg.n_layers, 2, MAX_LEN, cfg.n_kv_heads, cfg.d_head)
            _close(cache[k].numpy(), ref_cache[k], f"prefill cache {k}")
        for i in range(forced.shape[1]):
            tok = forced[:, i: i + 1]
            ref_logits, ref_cache = ref_tf.decode_step(
                cfg, params, ref_cache, jnp.asarray(tok))
            logits, cache = port.decode_step(tp, cache,
                                             torch.from_numpy(tok))
            _close(logits.numpy(), ref_logits, f"decode step {i} logits")
        assert int(cache["len"]) == int(ref_cache["len"]) == 14
        for k in ("k", "v"):
            _close(cache[k].numpy(), ref_cache[k], f"decoded cache {k}")


@pytest.mark.parametrize("length", [200, 129])
def test_long_prefill_matches_reference(arch, length):
    """A prompt longer than one 128-row block of the flash kernel, of a
    ragged length: the port's prefill (the flash wrapper, its plain
    version on the CPU, once per layer) against the reference's."""
    _, cfg, _, params, port, tp = arch
    max_len = length + 8
    prompt = np.random.default_rng(length).integers(
        0, cfg.vocab, (2, length)).astype(np.int32)
    ref_logits, ref_cache = ref_tf.prefill(cfg, params, jnp.asarray(prompt),
                                           max_len)
    rbd_step.reset_counts()
    with torch.no_grad():
        logits, cache = transformer.prefill(port.cfg, tp,
                                            torch.from_numpy(prompt),
                                            max_len)
    assert rbd_step.CALLS["flash_attention"] == cfg.n_layers
    _close(logits.numpy(), ref_logits, f"prefill logits, {length} tokens")
    assert int(cache["len"]) == int(ref_cache["len"]) == length
    for k in ("k", "v"):
        _close(cache[k].numpy(), ref_cache[k],
               f"prefill cache {k}, {length} tokens")


def _greedy_margin(cfg, params, prompts, tokens):
    """Smallest top-1/top-2 logit gap along the reference's greedy path
    (teacher-forced with its own tokens)."""
    logits, cache = ref_tf.prefill(cfg, params, jnp.asarray(prompts),
                                   MAX_LEN)
    gaps = []
    for i in range(tokens.shape[1]):
        top2 = np.sort(np.asarray(logits[:, -1, :]), axis=-1)[:, -2:]
        gaps.append((top2[:, 1] - top2[:, 0]).min())
        logits, cache = ref_tf.decode_step(
            cfg, params, cache, jnp.asarray(tokens[:, i: i + 1]))
    return float(min(gaps)), float(np.abs(np.asarray(logits)).max())


def test_greedy_generate_matches_reference(arch):
    _, cfg, model, params, port, tp = arch
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (4, 8))
    prompts = prompts.astype(np.int32)
    want = np.asarray(ref_engine.Engine(model, params, MAX_LEN).generate(
        jnp.asarray(prompts), 8))
    margin, scale = _greedy_margin(cfg, params, prompts, want)
    assert margin > RTOL * scale, (margin, RTOL * scale)
    with torch.no_grad():
        got = Engine(port, tp, MAX_LEN).generate(prompts, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def tiny():
    return _setup("tinyllama-1.1b")


def test_engine_generate_deterministic_and_sampled(tiny):
    """Greedy and seeded-temperature decoding are each deterministic, and
    the FIRST token goes through the temperature path too."""
    cfg, _, _, port, tp = tiny
    eng = Engine(port, tp, max_len=48)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (6, 8))
    with torch.no_grad():
        g1 = eng.generate(prompts, 6, temperature=0.0)
        g2 = eng.generate(prompts, 6, temperature=0.0)
        s1 = eng.generate(prompts, 6, temperature=4.0, seed=0)
        s2 = eng.generate(prompts, 6, temperature=4.0, seed=0)
        s3 = eng.generate(prompts, 6, temperature=4.0, seed=1)
    assert torch.equal(g1, g2) and torch.equal(s1, s2)
    assert bool((s1[:, 0] != g1[:, 0]).any())
    assert bool((s3[:, 0] != s1[:, 0]).any())


def test_engine_eos_right_padding(tiny):
    cfg, _, _, port, tp = tiny
    eng = Engine(port, tp, max_len=48)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 8))
    with torch.no_grad():
        base = eng.generate(prompts, 6).numpy()
        eos = int(base[0, 2])  # force an early EOS on row 0
        out = eng.generate(prompts, 6, eos_id=eos, pad_id=-1).numpy()
    assert out.shape == base.shape
    for row in range(out.shape[0]):
        hits = np.flatnonzero(base[row] == eos)
        if hits.size == 0:
            np.testing.assert_array_equal(out[row], base[row])
        else:
            k1 = int(hits[0]) + 1
            np.testing.assert_array_equal(out[row, :k1], base[row, :k1])
            assert np.all(out[row, k1:] == -1)
    assert np.any(out[0] == -1)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts, 48)


def test_multi_tenant_engine_end_to_end(tiny):
    """The two-tenant scenario of tests/test_serve.py through both
    engines: greedy tenant and base tokens equal the reference's, ONE
    fused launch personalizes both tenants, and a rerun hits the delta
    cache and reproduces every token."""
    cfg, ref_m, params, port, tp = tiny
    rplan = ref_comp.make_plan(params, 64, granularity="layer",
                               is_stacked=ref_m.is_stacked)
    rlay = rplan.packed(pos_block=256, dir_block=8)
    plan = compartments.make_plan(port.param_shapes(), 64,
                                  granularity="layer",
                                  is_stacked=port.is_stacked)
    lay = plan.packed(pos_block=256, dir_block=8)
    assert lay.d_packed == rlay.d_packed
    rs = np.random.default_rng(0)
    coords = [0.05 * rs.normal(size=lay.d_packed) for _ in range(2)]
    reg, rreg = AdapterRegistry(), ref_adapters.AdapterRegistry()
    for i in range(2):
        reg.register(AdapterSpec(f"tenant{i}", 100 + i, coords[i]))
        rreg.register(ref_adapters.AdapterSpec(f"tenant{i}", 100 + i,
                                               coords[i]))
    cache = AdapterCache(budget_bytes=8 * 4 * lay.q_packed)
    rcache = ref_adapters.AdapterCache(budget_bytes=8 * 4 * lay.q_packed)

    def submit(mt):
        mt.submit(np.arange(5) % cfg.vocab, 5, adapter_id="tenant0")
        mt.submit(np.arange(7) % cfg.vocab, 3, adapter_id="tenant1",
                  temperature=0.7, seed=1)
        mt.submit(np.arange(3) % cfg.vocab, 4)  # base model, queued
        return mt, mt.run()

    def run_port():
        return submit(MultiTenantEngine(
            port, tp, plan, registry=reg, delta_cache=cache, n_slots=2,
            max_len=48, layout=lay))

    _, want = submit(ref_engine.MultiTenantEngine(
        ref_m, params, rplan, registry=rreg, delta_cache=rcache, n_slots=2,
        max_len=48, layout=rlay))
    calls = rbd_step.CALLS["reconstruct_apply_packed_adapters"]
    with torch.no_grad():
        mt, res = run_port()
    assert rbd_step.CALLS["reconstruct_apply_packed_adapters"] == calls + 1
    assert sorted(len(v) for v in res.values()) == [3, 4, 5]
    np.testing.assert_array_equal(res[0], want[0])   # tenant0, greedy
    np.testing.assert_array_equal(res[2], want[2])   # base, greedy
    assert len(res[1]) == len(want[1]) == 3          # tenant1, sampled
    assert mt.stats["fused_launches"] == 1
    assert mt.stats["prefills"] == 3
    assert bool((mt._slot_thetas[0] != mt.theta).any())
    st = cache.stats()
    assert st["entries"] == 2 and st["evictions"] == 0

    with torch.no_grad():
        mt2, res2 = run_port()
    for rid in res:
        np.testing.assert_array_equal(res[rid], res2[rid])
    assert mt2.stats["fused_launches"] == 0
    assert rbd_step.CALLS["reconstruct_apply_packed_adapters"] == calls + 1
    assert cache.stats()["hits"] >= 2
