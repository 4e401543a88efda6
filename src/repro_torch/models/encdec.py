"""Whisper-style encoder-decoder backbone (port of
``repro.models.encdec``; arXiv:2212.04356).

The mel-spectrogram + conv feature extractor is the reference's
sanctioned stub (``frontends.audio_frames``): the encoder takes
precomputed frame embeddings (B, enc_seq, d_model).  Downstream all is
implemented: a bidirectional encoder, a causal decoder with
cross-attention, and KV-cached decode.  Positions are fixed sinusoidal
for the encoder and learned (``dec_pos``, 40,960 rows) for the decoder,
with no RoPE.

Parameters are a flat ``{leaf name: tensor}`` map with the reference's
flattened names and order (``dec_layers/cross_attn/wk``, ``dec_pos``,
``embed``, ``enc_layers/mlp/w_up``, ...); the per-layer leaves are
stacked on a leading (L,) axis, so the RBD planner sees the reference's
leaves, shapes and seeds.  Compute runs in ``cfg.compute_dtype`` with
the reference's casts: parameters cast at entry, norms and attention
softmax in float32, logits float32.

Attention runs through one of two functions of the same value.
``forward`` (the training path, under grad) keeps the blockwise function
of ``models/attention.py`` for the encoder, the decoder's self-attention
and its cross-attention, as ``transformer.forward`` does (ROADMAP.md
Queue C 2); each decoder layer is recomputed in the backward pass, as
the reference checkpoints its decoder block.  :func:`encode` takes the
attention function as an argument: :func:`prefill_cross_cache` passes
the flash kernel (``kernels/flash_attention.py``, non-causal, once per
encoder layer; its plain version for tensors on the CPU).

The cross K/V are computed as the reference computes them, at two
precisions: ``forward`` projects the encoder output with parameters
already cast to the compute dtype, while ``prefill_cross_cache``
multiplies the compute-dtype encoder output by the float32 leaves (the
reference's promotion to float32) and rounds the product into the cache
(ROADMAP.md Queue C 19).  ``decode_step`` writes the token's K/V into
the cache IN PLACE and returns the same dict, as
``transformer.decode_step`` does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compartments import leaf_order
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

STACKED_PREFIXES = ("enc_layers", "dec_layers")
DEC_POS_ROWS = 40960   # the reference's learned decoder positions


def _check_supported(cfg: ModelConfig) -> None:
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: not an encoder-decoder config; "
                         "decoder-only models run through models.transformer")


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return L.dtype_of(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig, pre: str, n: int) -> dict:
    d = cfg.d_model
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    return {pre + "wq": (n, d, hq), pre + "wk": (n, d, hkv),
            pre + "wv": (n, d, hkv), pre + "wo": (n, hq, d)}


def _mlp_shapes(cfg: ModelConfig, pre: str, n: int) -> dict:
    return {pre + "w_up": (n, cfg.d_model, cfg.d_ff),
            pre + "w_down": (n, cfg.d_ff, cfg.d_model)}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Leaf name -> shape in the reference's leaf order, without
    allocating anything."""
    _check_supported(cfg)
    d, ne, nd = cfg.d_model, cfg.n_enc_layers, cfg.n_layers
    shapes = {"embed": (cfg.vocab, d), "dec_pos": (DEC_POS_ROWS, d),
              "enc_norm": (d,), "final_norm": (d,),
              "enc_layers/ln1": (ne, d), "enc_layers/ln2": (ne, d),
              "dec_layers/ln1": (nd, d), "dec_layers/ln_x": (nd, d),
              "dec_layers/ln2": (nd, d)}
    shapes.update(_attn_shapes(cfg, "enc_layers/attn/", ne))
    shapes.update(_mlp_shapes(cfg, "enc_layers/mlp/", ne))
    shapes.update(_attn_shapes(cfg, "dec_layers/self_attn/", nd))
    shapes.update(_attn_shapes(cfg, "dec_layers/cross_attn/", nd))
    shapes.update(_mlp_shapes(cfg, "dec_layers/mlp/", nd))
    return {k: shapes[k] for k in leaf_order(shapes)}


_DENSE = {"wq", "wk", "wv", "wo", "w_up", "w_down"}
_NORMAL_SCALE = {"embed": 0.02, "dec_pos": 0.01}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """Random init with the reference's scales, leaf by leaf (its numbers
    differ: the reference draws from jax.random): dense matrices N(0, 1) /
    sqrt(fan-in), ``embed`` N(0, 1) * 0.02, ``dec_pos`` N(0, 1) * 0.01,
    norms zero."""
    dt = L.dtype_of(cfg.param_dtype)
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit("/", 1)[-1]
        if name in _NORMAL_SCALE:
            x = torch.randn(shape, generator=gen,
                            device=device) * _NORMAL_SCALE[name]
        elif leaf in _DENSE:
            x = L.dense_init(gen, shape[-2], shape[-1],
                             shape_prefix=shape[:-2], device=device)
        else:
            x = torch.zeros(shape, device=device)
        out[name] = x.to(dt)
    return out


def _layer(params: dict, prefix: str, i: int) -> dict:
    return {k[len(prefix):]: v[i] for k, v in params.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params: dict, frames,
           attention=attn.flash_attention):
    """frames: (B, S_enc, d_model) stub embeddings -> (B, S_enc, D) in the
    compute dtype; the encoder's non-causal attention through
    ``attention`` (default: the blockwise function)."""
    cdt = _cdt(cfg)
    params = L.cast_for_compute(params, cdt)
    _, s, _ = frames.shape
    x = frames.to(cdt) + L.sinusoidal_positions(s, cfg.d_model, cdt,
                                                frames.device)
    for i in range(cfg.n_enc_layers):
        lp = _layer(params, "enc_layers/", i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp, "attn/", h, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.d_head)
        ctx = attention(q, k, v, causal=False)
        x = x + attn.attention_output(lp["attn/wo"], ctx)
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(lp["mlp/w_up"], None, lp["mlp/w_down"], h, "gelu")
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_query(cfg: ModelConfig, lp: dict, x):
    """The cross-attention's queries from the ``ln_x`` norm of x.  The
    reference also projects k and v from x and drops them; they do not
    change the result, so they are not computed."""
    b, s, _ = x.shape
    h = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    return (h @ lp["cross_attn/wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)


def _cross_kv(cfg: ModelConfig, enc_out, wk, wv):
    """(B, S_enc, KV, hd) keys and values of the encoder output; the
    product's dtype is the operands' promotion, as in the reference."""
    b, se, _ = enc_out.shape
    dt = torch.promote_types(enc_out.dtype, wk.dtype)
    k = enc_out.to(dt) @ wk.to(dt)
    v = enc_out.to(dt) @ wv.to(dt)
    return (k.reshape(b, se, cfg.n_kv_heads, cfg.d_head),
            v.reshape(b, se, cfg.n_kv_heads, cfg.d_head))


def _decoder_layer(cfg: ModelConfig, lp: dict, x, enc_out):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp, "self_attn/", h, cfg.n_heads,
                               cfg.n_kv_heads, cfg.d_head)
    ctx = attn.flash_attention(q, k, v, causal=True)
    x = x + attn.attention_output(lp["self_attn/wo"], ctx)
    q = _cross_query(cfg, lp, x)
    xk, xv = _cross_kv(cfg, enc_out, lp["cross_attn/wk"],
                       lp["cross_attn/wv"])
    ctx = attn.flash_attention(q, xk, xv, causal=False)
    x = x + attn.attention_output(lp["cross_attn/wo"], ctx)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp/w_up"], None, lp["mlp/w_down"], h, "gelu")


def _logits(params: dict, x):
    return (x @ params["embed"].T.to(x.dtype)).to(torch.float32)


def forward(cfg: ModelConfig, params: dict, tokens, frames):
    """Teacher-forced decode over the full token sequence.  tokens: (B, S)
    integer; frames: (B, S_enc, d_model) -> (logits (B, S, V) float32, a
    zero aux loss); each decoder layer is recomputed in the backward pass
    when grad is on."""
    _check_supported(cfg)
    cdt = _cdt(cfg)
    params = L.cast_for_compute(params, cdt)
    enc_out = encode(cfg, params, frames)
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens).to(cdt) + params["dec_pos"][:s]
    remat = torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(params, "dec_layers/", i)
        if remat:
            x = checkpoint(_decoder_layer, cfg, lp, x, enc_out,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _decoder_layer(cfg, lp, x, enc_out)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


# ---------------------------------------------------------------------------
# decode: the cross cache from the encoder, then one token at a time
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zero cache of the reference's layout: ``k``/``v`` (L, B, max_len,
    KV, hd) for the self-attention, ``xk``/``xv`` (L, B, enc_seq, KV, hd)
    for the cross-attention, ``len`` an int32 scalar."""
    _check_supported(cfg)
    cdt = _cdt(cfg)
    kv = (cfg.n_layers, batch)
    tail = (cfg.n_kv_heads, cfg.d_head)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros((*kv, max_len, *tail), dtype=cdt, device=device),
            "v": torch.zeros((*kv, max_len, *tail), dtype=cdt, device=device),
            "xk": torch.zeros((*kv, cfg.enc_seq, *tail), dtype=cdt,
                              device=device),
            "xv": torch.zeros((*kv, cfg.enc_seq, *tail), dtype=cdt,
                              device=device)}


@torch.no_grad()
def prefill_cross_cache(cfg: ModelConfig, params: dict, cache: dict, frames,
                        attention=flash.flash_attention):
    """Run the encoder on ``frames`` (its attention through ``attention``:
    by default the flash kernel, one launch per encoder layer) and store
    every decoder layer's cross K/V in ``cache["xk"]``/``cache["xv"]``
    (replaced, so they take the frames' length); returns the cache."""
    _check_supported(cfg)
    enc_out = encode(cfg, params, frames, attention)
    xs = [_cross_kv(cfg, enc_out, params["dec_layers/cross_attn/wk"][i],
                    params["dec_layers/cross_attn/wv"][i])
          for i in range(cfg.n_layers)]
    cache["xk"] = torch.stack([k for k, _ in xs]).to(cache["xk"].dtype)
    cache["xv"] = torch.stack([v for _, v in xs]).to(cache["xv"].dtype)
    return cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token):
    """token: (B, 1) integer -- append one token at position
    ``cache["len"]`` (self-attention against the cache, cross-attention
    against every prefilled encoder position); returns (logits (B, 1, V)
    float32, cache), the cache updated in place.  The caller keeps
    ``len`` below the cache's max_len."""
    _check_supported(cfg)
    cdt = _cdt(cfg)
    params = L.cast_for_compute(params, cdt)
    pos = cache["len"]
    idx = pos.reshape(1).to(torch.int64)
    x = (L.embed(params["embed"], token).to(cdt)
         + params["dec_pos"].index_select(0, idx))
    enc_last = cfg.enc_seq - 1     # every encoder position is live
    for i in range(cfg.n_layers):
        lp = _layer(params, "dec_layers/", i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp, "self_attn/", h, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.d_head)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
        v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
        ctx = attn.decode_attention(q, k_cache, v_cache, pos)
        x = x + attn.attention_output(lp["self_attn/wo"], ctx)
        ctx = attn.decode_attention(_cross_query(cfg, lp, x), cache["xk"][i],
                                    cache["xv"][i], enc_last)
        x = x + attn.attention_output(lp["cross_attn/wo"], ctx)
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp(lp["mlp/w_up"], None, lp["mlp/w_down"], h, "gelu")
    cache["len"] = pos + 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x), cache
