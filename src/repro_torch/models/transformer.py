"""Decoder-only LM, dense ``block_kind="attn"`` path (port of
``repro.models.transformer``).

Parameters are a flat ``{leaf name: tensor}`` map with the reference's
names, and the per-layer leaves are stacked on a leading (L,) axis
(``layers/attn/wq`` is (L, d_model, H*hd)), so the RBD planner sees the
same leaves, shapes and order as in the reference.  Compute runs in
``cfg.compute_dtype`` with the reference's casts: parameters cast at
forward entry, norms and attention softmax in float32, logits float32.
MoE, RWKV, Mamba, hybrid and decode paths are not ported yet (ROADMAP.md
Queue A 18).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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


def _layer_forward(cfg: ModelConfig, lp: dict, x, positions):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp, "attn/", h, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    ctx = attn.flash_attention(q, k, v, causal=True, window=cfg.window)
    x = x + attn.attention_output(lp["attn/wo"], ctx)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = L.mlp(lp["mlp/w_up"], lp.get("mlp/w_gate"), lp["mlp/w_down"], h,
              cfg.act)
    return x + y


def forward(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer -> (logits (B, S, V) float32, aux loss)."""
    _check_supported(cfg)
    cdt = L.dtype_of(cfg.compute_dtype)
    params = L.cast_for_compute(params, cdt)
    x = L.embed(params["embed"], tokens)
    x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cdt, device=x.device)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for i in range(cfg.n_layers):
        x = _layer_forward(cfg, _layer(params, i), x, positions)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = L.unembed(head, x, tied=cfg.tie_embeddings).to(torch.float32)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
