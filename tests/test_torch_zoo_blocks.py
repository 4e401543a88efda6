"""Port parity of the zoo's blocks (``repro_torch.models.moe``,
``rwkv``, ``ssm``, the flash plain version at the zoo's head sizes) against
the reference's, the MoE families' forward pass and packed step
(tests/test_torch_zoo_model.py's helpers and tolerances), and the port's
decode against its own forward for every decoder family.

Tolerances: the MoE FFN in a capacity-dropping regime (capacity factor
0.5) within 1e-5 of max|y| and the aux rtol 1e-5, with every token's
routing margin asserted above 1e-4 (tests/test_torch_zoo_model.py); the
chunked WKV within 1e-5 of max|y| and of max|state| (the reference's own
chunked-vs-sequential check allows 1e-4: the same formula in float32 in
another summation order, measured at most ~1e-6); the Mamba mix over two
segments within 1e-5 of max|y| and of max|state|; the flash plain
version against the reference's Pallas kernel in interpret mode within
1e-6 of max|out| (tests/test_torch_flash.py's float32 gate); decode
against forward within 1e-5 of max|logit| (the reference's own check,
tests/test_arch_smoke.py, allows 2e-2: one token at a time against the
whole sequence, float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_kernel
from repro.models import moe as ref_moe
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import rbd_step
from repro_torch.models import frontends, moe, rwkv, ssm, transformer
from repro_torch.models.registry import get_model
from repro_torch.core import compartments
from repro_torch.serve.adapters import AdapterRegistry
from repro_torch.serve.engine import Engine, MultiTenantEngine
from test_torch_zoo_model import (DECODERS, FORWARD_CASES, check_forward,
                                  check_init_scales, check_packed_step,
                                  routing_margin)

torch.set_num_threads(1)

RTOL = 1e-5            # of the largest magnitude
FLASH_RTOL = 1e-6
ROUTE_MARGIN = 1e-4


def _t(tree: dict, prefix: str) -> dict:
    """A reference parameter dict as the port's ``{prefix}name`` map."""
    return {prefix + k: torch.from_numpy(np.array(v)) for k, v in
            tree.items()}


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    tol = rtol * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max|d| {err:.3g} > {tol:.3g}"


def test_moe_ffn_drops_slots_as_the_reference():
    """Capacity factor 0.5: a quarter of the slots past capacity are
    dropped; the port drops the same ones."""
    d, f, e, b, s, k = 32, 48, 4, 4, 24, 2
    p = ref_moe.init_moe(jax.random.PRNGKey(3), d, f, e)
    x = np.random.default_rng(3).standard_normal((b, s, d)).astype(
        np.float32)
    kw = dict(top_k=k, capacity_factor=0.5, groups=2)
    y_ref, aux_ref = jax.jit(lambda p, x: ref_moe.moe_ffn(p, x, **kw))(
        p, jnp.asarray(x))
    tp = _t(p, "moe/")
    xt = torch.from_numpy(x)
    margin = routing_margin(tp, xt, top_k=k)
    assert float(margin.min()) > ROUTE_MARGIN
    y, aux = moe.moe_ffn(tp, xt, **kw)
    _close(y, y_ref, "moe y")
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=RTOL)
    # the regime drops: some tokens get less than their full top-k output
    full, _ = moe.moe_ffn(tp, xt, top_k=k, capacity_factor=float(e),
                          groups=2)
    dropped = (y - full).abs().amax(-1) > 1e-6
    assert 0 < int(dropped.sum()) < b * s


MOE = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")


@pytest.mark.parametrize("arch,overrides,s",
                         [c for c in FORWARD_CASES if c[0] in MOE],
                         ids=MOE)
def test_moe_forward_logits_and_aux_match_reference(arch, overrides, s):
    check_forward(arch, overrides, s)



@pytest.mark.parametrize("arch", MOE)
def test_moe_one_packed_step_matches_reference(arch):
    check_packed_step(arch)


def test_moe_init_follows_the_reference_scales_by_leaf():
    check_init_scales("mixtral-8x7b")


def _rwkv_setup(d, h, b, s, seed):
    p = ref_rwkv.init_rwkv(jax.random.PRNGKey(seed), d, h)
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    st = rs.standard_normal((b, h, d // h, d // h)).astype(np.float32)
    sh = rs.standard_normal((b, d)).astype(np.float32)
    return p, x, st, sh


@pytest.mark.parametrize("s", [64, 40])
def test_rwkv_mix_matches_reference_with_carry_in(s):
    """S = 64: the chunk-parallel WKV (two chunks of 32) from a carry-in
    state and shift; S = 40: the sequential fallback."""
    d, h, b = 64, 2, 2
    p, x, st, sh = _rwkv_setup(d, h, b, s, s)
    y_ref, (st_ref, sh_ref) = jax.jit(
        lambda p, x, st, sh: ref_rwkv.rwkv_mix(p, x, h, state=st,
                                               shift_state=sh))(
        p, jnp.asarray(x), jnp.asarray(st), jnp.asarray(sh))
    y, (st_new, sh_new) = rwkv.rwkv_mix(
        _t(p, "tmix/"), torch.from_numpy(x), h, state=torch.from_numpy(st),
        shift_state=torch.from_numpy(sh))
    _close(y, y_ref, f"rwkv y S={s}")
    _close(st_new, st_ref, f"rwkv state S={s}")
    assert torch.equal(sh_new, torch.from_numpy(x[:, -1]))
    cm = ref_rwkv.init_channel_mix(jax.random.PRNGKey(1), d, 96)
    yc_ref, _ = ref_rwkv.channel_mix(cm, jnp.asarray(x),
                                     shift_state=jnp.asarray(sh))
    yc, _ = rwkv.channel_mix(_t(cm, "cmix/"), torch.from_numpy(x),
                             shift_state=torch.from_numpy(sh))
    _close(yc, yc_ref, "channel mix")


def test_wkv_chunked_equals_sequential():
    d, h, b, s = 64, 2, 2, 96
    p, x, st, sh = _rwkv_setup(d, h, b, s, 5)
    tp = _t(p, "tmix/")
    xt = torch.from_numpy(x)
    r, k, v, _, w = rwkv._projections(tp, xt, rwkv._token_shift(
        xt, torch.from_numpy(sh)), h)
    u = tp["tmix/bonus_u"]
    y1, s1 = rwkv.wkv_chunk_parallel(r, k, v, w, u, torch.from_numpy(st))
    y2, s2 = rwkv.wkv_sequential(r, k, v, w, u, torch.from_numpy(st))
    _close(y1, y2.numpy(), "chunked vs sequential y", rtol=1e-4)
    _close(s1, s2.numpy(), "chunked vs sequential state", rtol=1e-4)


@pytest.mark.parametrize("chunk", [ssm.SCAN_CHUNK, 5])
def test_mamba_mix_carries_state_across_segments(chunk, monkeypatch):
    """Two segments (16 then 8 tokens), the state and conv_state of the
    first carried into the second, against the reference's; with the
    scan's chunk of 5 tokens the state also crosses chunks inside a
    segment."""
    monkeypatch.setattr(ssm, "SCAN_CHUNK", chunk)
    d, h, n, b = 32, 4, 8, 2
    p = ref_ssm.init_mamba(jax.random.PRNGKey(4), d, h, n)
    x = np.random.default_rng(4).standard_normal((b, 24, d)).astype(
        np.float32)
    tp = _t(p, "mamba/")
    kw = dict(n_heads=h, ssm_state=n, expand=2)
    mix = jax.jit(lambda p, x, st, cs: ref_ssm.mamba_mix(
        p, x, **kw, state=st, conv_state=cs))
    y1r, (s1r, c1r) = mix(p, jnp.asarray(x[:, :16]), None, None)
    y2r, (s2r, c2r) = mix(p, jnp.asarray(x[:, 16:]), s1r, c1r)
    y1, (s1, c1) = ssm.mamba_mix(tp, torch.from_numpy(x[:, :16]), **kw)
    y2, (s2, c2) = ssm.mamba_mix(tp, torch.from_numpy(x[:, 16:]), **kw,
                                 state=s1, conv_state=c1)
    for got, want, what in ((y1, y1r, "y1"), (y2, y2r, "y2"),
                            (s2, s2r, "state"), (c2, c2r, "conv_state")):
        _close(got, want, what)
    # one token at a time (decode) equals the segment
    st, cs, ys = s1, c1, []
    for t in range(16, 24):
        y, (st, cs) = ssm.mamba_mix(tp, torch.from_numpy(x[:, t:t + 1]),
                                    **kw, state=st, conv_state=cs)
        ys.append(y)
    _close(torch.cat(ys, 1), y2.numpy(), "decode vs segment")


@pytest.mark.parametrize("hd,heads,window", [
    (80, (4, 4), None), (80, (4, 4), 64), (256, (4, 2), None),
    (256, (4, 2), 100)])
def test_flash_plain_matches_reference_kernel_at_zoo_head_sizes(
        hd, heads, window):
    """zamba2's head size (80) and gemma3's (256): the wrapper (its plain
    version on the CPU) against the reference's Pallas kernel in interpret
    mode."""
    h, kv = heads
    rs = np.random.default_rng(hd + h)
    q = rs.standard_normal((1, 200, h, hd)).astype(np.float32)
    k, v = (rs.standard_normal((1, 200, kv, hd)).astype(np.float32)
            for _ in range(2))
    assert hd in flash.HEAD_DIMS
    want = np.asarray(ref_kernel.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_block=128, kv_block=128, interpret=True))
    with torch.no_grad():
        got = flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True, window=window)
    _close(got, want, f"hd {hd} window {window}", rtol=FLASH_RTOL)


def _decode_cfg(arch):
    cfg = get_config(arch).reduced(compute_dtype="float32")
    if cfg.is_moe:
        # capacity dropping depends on the batch's token order: decode
        # equals forward only where nothing drops
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward(arch):
    """Token by token through decode_step, and prefill of 5 then decode of
    3, against the teacher-forced forward (the VLM: text only); the
    prefill's flash launches one per attention layer and per group."""
    cfg = _decode_cfg(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 8
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s)))
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        scale = float(full.abs().max())
        cache = model.init_cache(b, s + 4, device="cpu")
        outs = []
        for i in range(s):
            logits, cache = model.decode_step(params, cache, toks[:, i:i + 1])
            outs.append(logits[:, 0])
        assert int(cache["len"]) == s
        assert float((torch.stack(outs, 1) - full).abs().max()) <= (
            RTOL * scale)
        rbd_step.reset_counts()
        logits, cache = transformer.prefill(cfg, params, toks[:, :5], s + 4)
        n_attn = (cfg.n_layers if cfg.block_kind == "attn" else 0) + (
            transformer.n_groups(cfg))
        assert rbd_step.CALLS["flash_attention"] == n_attn
        assert int(cache["len"]) == 5
        outs = [logits[:, 0]]
        for i in range(5, s):
            logits, cache = model.decode_step(params, cache, toks[:, i:i + 1])
            outs.append(logits[:, 0])
        assert rbd_step.CALLS["flash_attention"] == n_attn
    assert float((torch.stack(outs, 1) - full[:, 4:]).abs().max()) <= (
        RTOL * scale)


def test_engine_prefills_patches_then_decodes():
    """The VLM through Engine.generate: the patches prefilled before the
    prompt, the first token the argmax of forward's last position, the
    room check counting the patches."""
    cfg = get_config("llava-next-mistral-7b").reduced(
        compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    patches = frontends.vision_patches(cfg, 2, device="cpu")
    assert tuple(patches.shape) == (2, cfg.n_patches, cfg.d_model)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 6)))
    engine = Engine(model, params, max_len=cfg.n_patches + 6 + 3)
    with torch.no_grad():
        out = engine.generate(toks, 4, extra_embeds=patches)
        full, _ = model.forward(params, {"tokens": toks, "patches": patches})
    assert tuple(out.shape) == (2, 4)
    assert torch.equal(out[:, 0].long(), full[:, -1].argmax(-1))
    with pytest.raises(ValueError, match="does not fit"):
        engine.generate(toks, 5, extra_embeds=patches)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_multi_tenant_engine_serves_every_cache(arch):
    """MultiTenantEngine's B = 1 slot caches for the MoE, RWKV and hybrid
    families: each base request's greedy tokens equal Engine's on the
    same prompt."""
    cfg = _decode_cfg(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    plan = compartments.make_plan(model.param_shapes(), 64,
                                  is_stacked=model.is_stacked)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 7))
    engine = MultiTenantEngine(model, params, plan,
                               registry=AdapterRegistry(), n_slots=1,
                               max_len=16)
    with torch.no_grad():
        rids = [engine.submit(p, 6) for p in prompts]
        results = engine.run()
        want = Engine(model, params, max_len=16).generate(prompts, 6)
    for rid, row in zip(rids, want.numpy()):
        assert results[rid].tolist() == row.tolist()
