"""Decoder-only LM assembly for the dense, MoE, RWKV, Mamba-hybrid and
VLM families (port of ``repro.models.transformer``).

Parameters are a flat ``{leaf name: tensor}`` map with the reference's
names, and the per-layer leaves are stacked on a leading (L,) axis
(``layers/attn/wq`` is (L, d_model, H*hd), ``layers/moe/w_gate`` (L, E,
d_model, d_ff), ``layers/tmix/bonus_u`` (L, H, hd)), so the RBD planner
sees the same leaves, shapes and order as in the reference.  zamba2's one
parameter-shared attention block is ``shared_attn/...``, unstacked.
Compute runs in ``cfg.compute_dtype`` with the reference's casts:
parameters cast at forward entry, norms, routing, recurrences and
attention softmax in float32, logits float32.

The layers run in order; heterogeneous stacks are static per layer:
gemma3's 5 local : 1 global pattern gives layer i no window when ``(i +
1) % global_every == 0`` (the reference feeds the same pattern through
its scan as a traced flag), and the hybrid runs groups of
``hybrid_attn_every`` Mamba layers, each followed by the shared block.
``extra_embeds`` (the VLM's patches) are prepended to the token
embeddings.  With grad enabled each layer is recomputed in the backward
pass (``torch.utils.checkpoint``), as the reference's ``remat=True``
does: without it a full-depth recurrence keeps every step's state.

Decode: ``prefill`` runs the prompt and fills a cache of the reference's
layout -- ``k``/``v`` (L, B, max_len, KV, hd) for attention layers
(windowed layers keep full-length caches and mask, as in the
reference), ``rwkv`` (L, B, H, hd, hd) float32 and ``shift1``/``shift2``
(L, B, D), ``ssm`` (L, B, H, P, N) float32 and ``conv`` (L, B, W-1,
d_inner), ``shared_k``/``shared_v`` (groups, B, max_len, KV, hd), ``len``
an int32 scalar -- and ``decode_step`` appends one token.  Unlike the
reference, ``decode_step`` writes into the cache IN PLACE and returns
the same dict (no per-token copy of the cache).  The encoder-decoder
(whisper) is ``models/encdec.py``.

Attention over the prompt runs through one of two functions of the same
value.  ``prefill`` calls the flash kernel
(``kernels/flash_attention.py``, the port of the reference's Pallas
kernel; its plain version for tensors on the CPU), once per attention
layer and once per hybrid group.  ``forward``, the training path, keeps
the blockwise function of ``models/attention.py``, the counterpart of
the reference's jnp ``flash_attention`` that its models run: the
reference's kernel is forward only, so it has no gradient to give
(ROADMAP.md Queue C 2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compartments import leaf_order
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib

STACKED_PREFIXES = ("layers",)
BLOCK_KINDS = ("attn", "rwkv", "mamba")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder config; it runs through "
            "models.encdec")
    if cfg.block_kind not in BLOCK_KINDS:
        raise ValueError(f"{cfg.name}: unknown block_kind "
                         f"{cfg.block_kind!r}; expected one of {BLOCK_KINDS}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig, pre: str, lead=()) -> dict:
    d = cfg.d_model
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    out = {pre + "wq": (*lead, d, hq), pre + "wk": (*lead, d, hkv),
           pre + "wv": (*lead, d, hkv), pre + "wo": (*lead, hq, d)}
    if cfg.qkv_bias:
        out.update({pre + "bq": (*lead, hq), pre + "bk": (*lead, hkv),
                    pre + "bv": (*lead, hkv)})
    return out


def _mlp_shapes(cfg: ModelConfig, pre: str, lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    out = {pre + "w_up": (*lead, d, f), pre + "w_down": (*lead, f, d)}
    if cfg.act == "silu":
        out[pre + "w_gate"] = (*lead, d, f)
    return out


def _layer_shapes(cfg: ModelConfig) -> dict:
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    out = {"layers/ln1": (n, d)}
    if cfg.block_kind == "attn":
        out.update(_attn_shapes(cfg, "layers/attn/", (n,)))
        out["layers/ln2"] = (n, d)
        if cfg.is_moe:
            e = cfg.n_experts
            out.update({"layers/moe/router": (n, d, e),
                        "layers/moe/w_gate": (n, e, d, f),
                        "layers/moe/w_up": (n, e, d, f),
                        "layers/moe/w_down": (n, e, f, d)})
        else:
            out.update(_mlp_shapes(cfg, "layers/mlp/", (n,)))
    elif cfg.block_kind == "rwkv":
        hd = d // cfg.n_heads
        pre = "layers/tmix/"
        out.update({pre + w: (n, d, d) for w in ("wr", "wk", "wv", "wg",
                                                  "wo")})
        out.update({pre + "w_decay_a": (n, d, rwkv_lib.DECAY_LORA),
                    pre + "w_decay_b": (n, rwkv_lib.DECAY_LORA, d),
                    pre + "decay_base": (n, d),
                    pre + "bonus_u": (n, cfg.n_heads, hd)})
        out.update({f"{pre}mix_{m}": (n, d) for m in "rkvgw"})
        out.update({"layers/ln2": (n, d), "layers/cmix/wk": (n, d, f),
                    "layers/cmix/wv": (n, f, d),
                    "layers/cmix/mix_k": (n, d)})
    else:  # mamba
        di = cfg.ssm_expand * d
        h = cfg.n_heads
        pre = "layers/mamba/"
        out.update({pre + "w_in": (n, d, 2 * di + 2 * cfg.ssm_state + h),
                    pre + "conv_w": (n, cfg.conv_width, di),
                    pre + "conv_b": (n, di), pre + "a_log": (n, h),
                    pre + "dt_bias": (n, h), pre + "d_skip": (n, h, di // h),
                    pre + "w_out": (n, di, d), pre + "norm_w": (n, di)})
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Leaf name -> shape in the reference's leaf order, without
    allocating anything."""
    _check_supported(cfg)
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    shapes.update(_layer_shapes(cfg))
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    if cfg.hybrid_attn_every > 0:
        shapes["shared_attn/ln"] = (d,)
        shapes.update(_attn_shapes(cfg, "shared_attn/attn/"))
        shapes["shared_attn/ln2"] = (d,)
        shapes.update(_mlp_shapes(cfg, "shared_attn/mlp/"))
    return {k: shapes[k] for k in leaf_order(shapes)}


# the reference's init, by leaf name: dense matrices N(0, 1) / sqrt(fan-in)
# (the second-to-last axis), constants, and two special draws
_DENSE = {"wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate", "router",
          "wr", "wg", "w_decay_a", "w_decay_b", "w_in", "w_out", "conv_w",
          "lm_head"}
_FILL = {"decay_base": -6.0, "dt_bias": -4.0, "d_skip": 1.0,
         **{f"mix_{m}": 0.5 for m in "rkvgw"}}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """Random init with the reference's scales, leaf by leaf (its numbers
    differ: the reference draws from jax.random)."""
    dt = L.dtype_of(cfg.param_dtype)
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit("/", 1)[-1]
        if name == "embed":
            x = torch.randn(shape, generator=gen, device=device) * 0.02
        elif leaf == "bonus_u":
            x = torch.randn(shape, generator=gen, device=device) * 0.1
        elif leaf in _DENSE:
            x = L.dense_init(gen, shape[-2], shape[-1],
                             shape_prefix=shape[:-2], device=device)
        else:  # norms, biases, a_log start at zero; the rest are constants
            x = torch.full(shape, _FILL.get(leaf, 0.0), device=device)
        out[name] = x.to(dt)
    return out


def _layer(params: dict, i: int) -> dict:
    return {k[len("layers/"):]: v[i] for k, v in params.items()
            if k.startswith("layers/")}


def _shared(params: dict) -> dict:
    return {k[len("shared_attn/"):]: v for k, v in params.items()
            if k.startswith("shared_attn/")}


def layer_windows(cfg: ModelConfig) -> list:
    """Each layer's static attention window: ``cfg.window``, or None on a
    global layer (``(i + 1) % global_every == 0``, the reference's
    ``_global_flags``)."""
    return [None if (cfg.global_every > 0
                     and (i + 1) % cfg.global_every == 0) else cfg.window
            for i in range(cfg.n_layers)]


def n_groups(cfg: ModelConfig) -> int:
    """Hybrid groups (one shared-block application each); 0 without."""
    if cfg.hybrid_attn_every <= 0:
        return 0
    if cfg.n_layers % cfg.hybrid_attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of hybrid_attn_every "
                         f"{cfg.hybrid_attn_every}")
    return cfg.n_layers // cfg.hybrid_attn_every


# ---------------------------------------------------------------------------
# full sequence (train / prefill)
# ---------------------------------------------------------------------------


def _attn_residual(cfg: ModelConfig, p: dict, ln: str, x, positions,
                   window, attention):
    """x + attention(norm(x)) from the ``{ln}`` norm and ``attn/`` leaves
    of ``p``; returns (x, k, v), k and v post-RoPE (the cache entries)."""
    h = L.rms_norm(x, p[ln], cfg.norm_eps)
    q, k, v = attn.qkv_project(p, "attn/", h, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    ctx = attention(q, k, v, causal=True, window=window)
    return x + attn.attention_output(p["attn/wo"], ctx), k, v


def _mlp_residual(cfg: ModelConfig, p: dict, x):
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(p["mlp/w_up"], p.get("mlp/w_gate"), p["mlp/w_down"], h,
                     cfg.act)


def _ffn_residual(cfg: ModelConfig, lp: dict, x):
    """x + the attention layer's MoE or MLP; returns (x, aux or None)."""
    if not cfg.is_moe:
        return _mlp_residual(cfg, lp, x), None
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = moe_lib.moe_ffn(lp, h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             groups=cfg.moe_groups)
    return x + y, aux


def _layer_forward(cfg: ModelConfig, lp: dict, x, positions, window,
                   attention, states=None):
    """One layer over the full sequence; returns (x, aux or None, the
    layer's cache entries).  ``states``: the recurrent carries of a
    previous segment, or None."""
    states = states or {}
    if cfg.block_kind == "attn":
        x, k, v = _attn_residual(cfg, lp, "ln1", x, positions, window,
                                 attention)
        x, aux = _ffn_residual(cfg, lp, x)
        return x, aux, {"k": k, "v": v}
    if cfg.block_kind == "rwkv":
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, (s, sh1) = rwkv_lib.rwkv_mix(lp, h, cfg.n_heads,
                                        state=states.get("rwkv"),
                                        shift_state=states.get("shift1"))
        x = x + y
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, sh2 = rwkv_lib.channel_mix(lp, h, shift_state=states.get("shift2"))
        return x + y, None, {"rwkv": s, "shift1": sh1, "shift2": sh2}
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, (s, cs) = ssm_lib.mamba_mix(
        lp, h, n_heads=cfg.n_heads, ssm_state=cfg.ssm_state,
        expand=cfg.ssm_expand, state=states.get("ssm"),
        conv_state=states.get("conv"))
    return x + y, None, {"ssm": s, "conv": cs}


def _shared_forward(cfg: ModelConfig, sp: dict, x, positions, attention):
    """The hybrid's shared block; returns (x, k, v)."""
    x, k, v = _attn_residual(cfg, sp, "ln", x, positions, cfg.window,
                             attention)
    return _mlp_residual(cfg, sp, x), k, v


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, cdt: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """sqrt(d_model) in the compute dtype on ``device``, made once (a copy
    from the host at every call would wait for the device)."""
    return torch.tensor(np.sqrt(d_model), dtype=cdt, device=device)


def _embed(cfg: ModelConfig, params: dict, tokens):
    x = L.embed(params["embed"], tokens)
    return x * _embed_scale(cfg.d_model, L.dtype_of(cfg.compute_dtype),
                            x.device)


def _logits(cfg: ModelConfig, params: dict, x):
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x, tied=cfg.tie_embeddings).to(torch.float32)


def _run_prompt(cfg: ModelConfig, params: dict, tokens, attention, *,
                extra_embeds=None, remat: bool = False, shards=None):
    """Embed (patches first) and run every layer over the prompt,
    attention through ``attention``, each layer recomputed in the
    backward pass when ``remat`` and grad is on.  Returns the final normed
    hidden state, the summed aux (None for no MoE layer), each layer's
    cache entries and each group's shared (k, v).  ``shards``
    (``registry.LeafShards``): the stacked leaves are this rank's shards,
    and each layer gathers its slices inside the layer (so inside the
    recompute too), one layer's whole leaves live at a time."""
    x = _embed(cfg, params, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    remat = remat and torch.is_grad_enabled()
    windows = layer_windows(cfg)
    per_group = cfg.hybrid_attn_every if n_groups(cfg) else cfg.n_layers
    sp = _shared(params) if n_groups(cfg) else None
    aux, states, shared_kv = None, [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)

        def run(x, lp=lp, window=windows[i]):
            if shards is not None:
                lp = {k: shards.gather("layers/" + k, v, lead=1)
                      for k, v in lp.items()}
            return _layer_forward(cfg, lp, x, positions, window, attention)

        if remat:
            x, a, _ = checkpoint(run, x, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            x, a, st = run(x)
            states.append(st)
        if a is not None:
            aux = a if aux is None else aux + a
        if sp is not None and (i + 1) % per_group == 0:
            if remat:
                x = checkpoint(
                    lambda x: _shared_forward(cfg, sp, x, positions,
                                              attention)[0],
                    x, use_reentrant=False, preserve_rng_state=False)
            else:
                x, k, v = _shared_forward(cfg, sp, x, positions, attention)
                shared_kv.append((k, v))
    return (L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux, states,
            shared_kv)


def forward(cfg: ModelConfig, params: dict, tokens, *, extra_embeds=None,
            shards=None):
    """tokens: (B, S) integer, ``extra_embeds`` (B, P, D) or None ->
    (logits (B, P + S, V) float32, aux loss float32 summed over layers);
    each layer is recomputed in the backward pass when grad is on.

    ``shards`` (``registry.LeafShards``): ``params`` holds this rank's
    leaf shards under pjit-style parameter sharding.  Each is gathered
    over the model group right before its use -- ``embed``, ``lm_head``,
    ``final_norm`` and ``shared_attn/*`` once a forward, a stacked leaf
    one layer at a time -- and the backward pass keeps this rank's slice
    of each gradient.  Every rank computes the whole forward and
    backward (ROADMAP.md Queue C 24)."""
    _check_supported(cfg)
    params = L.cast_for_compute(params, L.dtype_of(cfg.compute_dtype))
    if shards is not None:
        params = {k: v if k.startswith("layers/") else shards.gather(k, v)
                  for k, v in params.items()}
    x, aux, _, _ = _run_prompt(cfg, params, tokens, attn.flash_attention,
                               extra_embeds=extra_embeds, remat=True,
                               shards=shards)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, params, x), aux


# ---------------------------------------------------------------------------
# decode: prefill a cache, then one token at a time
# ---------------------------------------------------------------------------

CACHE_KEYS = {"attn": ("k", "v"), "rwkv": ("rwkv", "shift1", "shift2"),
              "mamba": ("ssm", "conv")}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zero cache of the reference's layout (module docstring)."""
    _check_supported(cfg)
    cdt = L.dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    n, d = cfg.n_layers, cfg.d_model

    def zeros(shape, dtype=cdt):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = {"len": zeros((), torch.int32)}
    kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    if cfg.block_kind == "attn":
        cache["k"] = zeros((n, *kv_shape))
        cache["v"] = zeros((n, *kv_shape))
    elif cfg.block_kind == "rwkv":
        hd = d // cfg.n_heads
        cache["rwkv"] = zeros((n, batch, cfg.n_heads, hd, hd), f32)
        cache["shift1"] = zeros((n, batch, d))
        cache["shift2"] = zeros((n, batch, d))
    else:
        di = cfg.ssm_expand * d
        cache["ssm"] = zeros((n, batch, cfg.n_heads, di // cfg.n_heads,
                              cfg.ssm_state), f32)
        cache["conv"] = zeros((n, batch, cfg.conv_width - 1, di))
    if n_groups(cfg):
        cache["shared_k"] = zeros((n_groups(cfg), *kv_shape))
        cache["shared_v"] = zeros((n_groups(cfg), *kv_shape))
    return cache


def prefill(cfg: ModelConfig, params: dict, tokens, max_len: int, *,
            extra_embeds=None):
    """Run the prompt (B, S) (after ``extra_embeds`` (B, P, D), if given);
    returns (last-position logits (B, 1, V) float32, a cache of capacity
    ``max_len`` holding the prompt's K/V and recurrent states, ``len`` P +
    S)."""
    _check_supported(cfg)
    b, s = tokens.shape
    if extra_embeds is not None:
        s += extra_embeds.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds the cache's max_len "
                         f"{max_len}")
    params = L.cast_for_compute(params, L.dtype_of(cfg.compute_dtype))
    x, _, states, shared_kv = _run_prompt(cfg, params, tokens,
                                          flash.flash_attention,
                                          extra_embeds=extra_embeds)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for key in CACHE_KEYS[cfg.block_kind]:
        if key in ("k", "v"):
            cache[key][:, :, :s] = torch.stack([st[key] for st in states])
        else:
            cache[key].copy_(torch.stack([st[key] for st in states]))
    if shared_kv:
        cache["shared_k"][:, :, :s] = torch.stack([k for k, _ in shared_kv])
        cache["shared_v"][:, :, :s] = torch.stack([v for _, v in shared_kv])
    cache["len"].fill_(s)
    return _logits(cfg, params, x[:, -1:]), cache


def _decode_attn(cfg: ModelConfig, p: dict, ln: str, x, pos, posb, idx,
                 k_cache, v_cache, window):
    """x + one attention sublayer's decode step (``{ln}`` norm, ``attn/``
    leaves of ``p``); the token's K/V are written into ``k_cache`` /
    ``v_cache`` (B, max_len, KV, hd) in place at ``pos``."""
    h = L.rms_norm(x, p[ln], cfg.norm_eps)
    q, k, v = attn.qkv_project(p, "attn/", h, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head)
    q = attn.apply_rope(q, posb, cfg.rope_theta)
    k = attn.apply_rope(k, posb, cfg.rope_theta)
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    ctx = attn.decode_attention(q, k_cache, v_cache, pos, window=window)
    return x + attn.attention_output(p["attn/wo"], ctx)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token):
    """token: (B, 1) integer -- append one token at position
    ``cache["len"]``; returns (logits (B, 1, V) float32, cache), the cache
    updated in place.  The caller keeps ``len`` below the cache's max_len
    (the engines check it when a request is submitted): reading ``len``
    here would wait for the device every token."""
    _check_supported(cfg)
    params = L.cast_for_compute(params, L.dtype_of(cfg.compute_dtype))
    pos = cache["len"]
    x = _embed(cfg, params, token)
    posb = pos.reshape(1, 1).expand(x.shape[0], 1)
    idx = pos.reshape(1).to(torch.int64)
    windows = layer_windows(cfg)
    per_group = cfg.hybrid_attn_every if n_groups(cfg) else cfg.n_layers
    sp = _shared(params) if n_groups(cfg) else None
    # the shared block is a global layer (the reference's is_global=True)
    shared_window = None if cfg.global_every > 0 else cfg.window
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if cfg.block_kind == "attn":
            x = _decode_attn(cfg, lp, "ln1", x, pos, posb, idx,
                             cache["k"][i], cache["v"][i], windows[i])
            x, _ = _ffn_residual(cfg, lp, x)
        else:
            keys = CACHE_KEYS[cfg.block_kind]
            x, _, st = _layer_forward(
                cfg, lp, x, None, None, None,
                states={key: cache[key][i] for key in keys})
            for key in keys:
                cache[key][i].copy_(st[key])
        if sp is not None and (i + 1) % per_group == 0:
            grp = i // per_group
            x = _decode_attn(cfg, sp, "ln", x, pos, posb, idx,
                             cache["shared_k"][grp], cache["shared_v"][grp],
                             shared_window)
            x = _mlp_residual(cfg, sp, x)
    cache["len"] = pos + 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache
