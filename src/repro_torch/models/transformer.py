"""Decoder-only LM, dense ``block_kind="attn"`` path (port of
``repro.models.transformer``).

Parameters are a flat ``{leaf name: tensor}`` map with the reference's
names, and the per-layer leaves are stacked on a leading (L,) axis
(``layers/attn/wq`` is (L, d_model, H*hd)), so the RBD planner sees the
same leaves, shapes and order as in the reference.  Compute runs in
``cfg.compute_dtype`` with the reference's casts: parameters cast at
forward entry, norms and attention softmax in float32, logits float32.

Decode: ``prefill`` runs the prompt and fills a KV cache of the
reference's layout -- ``k``/``v`` (L, B, max_len, KV, hd) in the compute
dtype, ``len`` an int32 scalar -- and ``decode_step`` appends one token.
Unlike the reference, ``decode_step`` writes the new K/V into the cache
IN PLACE and returns the same dict (no per-token copy of the cache).
MoE, RWKV, Mamba and hybrid blocks (forward and caches) are not ported
yet (ROADMAP.md Queue A 18).

Attention over the prompt runs through one of two functions of the same
value.  ``prefill`` calls the flash kernel
(``kernels/flash_attention.py``, the port of the reference's Pallas
kernel; its plain version for tensors on the CPU).  ``forward``, the
training path, keeps the blockwise function of ``models/attention.py``,
the counterpart of the reference's jnp ``flash_attention`` that its models
run: the reference's kernel is forward only, so it has no gradient to
give (ROADMAP.md Queue C 2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

STACKED_PREFIXES = ("layers",)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.block_kind != "attn" or cfg.is_moe or cfg.hybrid_attn_every
            or cfg.is_encoder_decoder or cfg.n_patches
            or cfg.global_every):
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention decoder is ported "
            "(ROADMAP.md Queue A 18)")


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Leaf name -> shape, without allocating anything."""
    _check_supported(cfg)
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    shapes = {
        "embed": (cfg.vocab, d),
        "final_norm": (d,),
        "layers/ln1": (n, d),
        "layers/ln2": (n, d),
        "layers/attn/wq": (n, d, hq),
        "layers/attn/wk": (n, d, hkv),
        "layers/attn/wv": (n, d, hkv),
        "layers/attn/wo": (n, hq, d),
        "layers/mlp/w_up": (n, d, f),
        "layers/mlp/w_down": (n, f, d),
    }
    if cfg.act == "silu":
        shapes["layers/mlp/w_gate"] = (n, d, f)
    if cfg.qkv_bias:
        shapes.update({"layers/attn/bq": (n, hq), "layers/attn/bk": (n, hkv),
                       "layers/attn/bv": (n, hkv)})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """Random init with the reference's scales (its numbers differ: the
    reference draws from jax.random)."""
    dt = L.dtype_of(cfg.param_dtype)
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit("/", 1)[-1]
        if name == "embed":
            x = torch.randn(shape, generator=gen, device=device) * 0.02
        elif leaf.startswith("w") or name == "lm_head":
            x = L.dense_init(gen, shape[-2], shape[-1],
                             shape_prefix=shape[:-2], device=device)
        else:  # norms and biases start at zero
            x = torch.zeros(shape, device=device)
        out[name] = x.to(dt)
    return out


def _layer(params: dict, i: int) -> dict:
    return {k[len("layers/"):]: v[i] for k, v in params.items()
            if k.startswith("layers/")}


def _mlp_residual(cfg: ModelConfig, lp: dict, x):
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp/w_up"], lp.get("mlp/w_gate"),
                     lp["mlp/w_down"], h, cfg.act)


def _layer_forward(cfg: ModelConfig, lp: dict, x, positions, attention):
    """One layer over the full sequence, its attention through
    ``attention``; returns (x, k, v), k and v post-RoPE (the prefill's
    cache entries)."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp, "attn/", h, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    ctx = attention(q, k, v, causal=True, window=cfg.window)
    x = x + attn.attention_output(lp["attn/wo"], ctx)
    return _mlp_residual(cfg, lp, x), k, v


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


def _run_prompt(cfg: ModelConfig, params: dict, tokens, attention):
    """Embed and run every layer over the prompt, attention through
    ``attention``; returns the final normed hidden state and each layer's
    (k, v)."""
    x = _embed(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    kvs = []
    for i in range(cfg.n_layers):
        x, k, v = _layer_forward(cfg, _layer(params, i), x, positions,
                                 attention)
        kvs.append((k, v))
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), kvs


def forward(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer -> (logits (B, S, V) float32, aux loss)."""
    _check_supported(cfg)
    params = L.cast_for_compute(params, L.dtype_of(cfg.compute_dtype))
    x, _ = _run_prompt(cfg, params, tokens, attn.flash_attention)
    return (_logits(cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# decode: prefill a KV cache, then one token at a time
# ---------------------------------------------------------------------------


def _check_decode(cfg: ModelConfig) -> None:
    if cfg.block_kind != "attn" or cfg.hybrid_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.block_kind} decode caches (and hybrid shared "
            "attention caches) are not ported yet (ROADMAP.md Queue A 18)")
    _check_supported(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zero cache: ``k``/``v`` (L, batch, max_len, KV, hd) in the compute
    dtype and ``len`` an int32 scalar, the reference's layout."""
    _check_decode(cfg)
    cdt = L.dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def prefill(cfg: ModelConfig, params: dict, tokens, max_len: int):
    """Run the prompt (B, S); returns (last-position logits (B, 1, V)
    float32, a cache of capacity ``max_len`` holding the prompt's K/V)."""
    _check_decode(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds the cache's max_len "
                         f"{max_len}")
    params = L.cast_for_compute(params, L.dtype_of(cfg.compute_dtype))
    x, kvs = _run_prompt(cfg, params, tokens, flash.flash_attention)
    cache = init_cache(cfg, b, max_len, device=x.device)
    cache["k"][:, :, :s] = torch.stack([k for k, _ in kvs])
    cache["v"][:, :, :s] = torch.stack([v for _, v in kvs])
    cache["len"].fill_(s)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token):
    """token: (B, 1) integer -- append one token at position
    ``cache["len"]``; returns (logits (B, 1, V) float32, cache), the cache
    updated in place.  The caller keeps ``len`` below the cache's max_len
    (the engines check it when a request is submitted): reading ``len``
    here would wait for the device every token."""
    _check_decode(cfg)
    k_all, v_all = cache["k"], cache["v"]
    params = L.cast_for_compute(params, L.dtype_of(cfg.compute_dtype))
    pos = cache["len"]
    x = _embed(cfg, params, token)
    posb = pos.reshape(1, 1).expand(x.shape[0], 1)
    idx = pos.reshape(1).to(torch.int64)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp, "attn/", h, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.d_head)
        q = attn.apply_rope(q, posb, cfg.rope_theta)
        k = attn.apply_rope(k, posb, cfg.rope_theta)
        k_all[i].index_copy_(1, idx, k.to(k_all.dtype))
        v_all[i].index_copy_(1, idx, v.to(v_all.dtype))
        ctx = attn.decode_attention(q, k_all[i], v_all[i], pos,
                                    window=cfg.window)
        x = x + attn.attention_output(lp["attn/wo"], ctx)
        x = _mlp_residual(cfg, lp, x)
    cache["len"] = pos + 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache
