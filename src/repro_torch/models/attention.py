"""Grouped-query attention with RoPE, blockwise (flash-style) softmax
for train / prefill and KV-cache decode (port of
``repro.models.attention``).

Shapes follow the reference: (B, S, H, hd) queries, (B, S, KV, hd) keys
and values with H = KV * G.  The blockwise path never materializes the
(S, S) scores: a loop over query blocks and an inner loop over KV blocks
carry the online-softmax statistics.  The reference's models call its
jnp ``flash_attention``, not its Pallas kernel, so this is plain PyTorch
(matmuls in float32).  ``decode_attention`` scores one query per row
against a (B, S_max, KV, hd) cache, also in float32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
Q_BLOCK = 512
KV_BLOCK = 1024


def rope_frequencies(d_head: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (
        theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head)
    )


@functools.lru_cache(maxsize=None)
def _device_frequencies(d_head: int, theta: float,
                        device: torch.device) -> torch.Tensor:
    """The frequencies on ``device``, copied there once: a copy from host
    memory at every call would wait for the device each time."""
    return torch.from_numpy(np.asarray(rope_frequencies(d_head, theta),
                                       np.float32)).to(device)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S) integer."""
    freqs = _device_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def qkv_project(p: dict, prefix: str, x, n_heads: int, n_kv: int,
                d_head: int):
    """q, k, v of one layer from the ``{prefix}w*``/``{prefix}b*`` leaves."""
    b, s, _ = x.shape
    q = x @ p[prefix + "wq"]
    k = x @ p[prefix + "wk"]
    v = x @ p[prefix + "wv"]
    if prefix + "bq" in p:
        q = q + p[prefix + "bq"]
        k = k + p[prefix + "bk"]
        v = v + p[prefix + "bv"]
    return (q.reshape(b, s, n_heads, d_head),
            k.reshape(b, s, n_kv, d_head),
            v.reshape(b, s, n_kv, d_head))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    q_block: int = Q_BLOCK, kv_block: int = KV_BLOCK):
    """Blockwise-softmax attention; q: (B, Sq, H, hd), k, v: (B, Sk, KV,
    hd).  ``window``: static sliding-window size."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32).reshape(b, sq, kv, g, hd)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    outs = []
    for q0 in range(0, sq, q_block):
        qblk = qf[:, q0: q0 + q_block]
        nq = qblk.shape[1]
        q_pos = torch.arange(q0, q0 + nq, device=dev) + q_offset
        m = torch.full((b, kv, g, nq), NEG_INF, device=dev)
        lse = torch.zeros((b, kv, g, nq), device=dev)
        acc = torch.zeros((b, kv, g, nq, hd), device=dev)
        for k0 in range(0, sk, kv_block):
            kblk = kf[:, k0: k0 + kv_block]
            vblk = vf[:, k0: k0 + kv_block]
            k_pos = torch.arange(k0, k0 + kblk.shape[1], device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk) * scale
            mask = torch.ones((nq, kblk.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            lse = lse * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vblk)
            m = m_new
        out = acc / torch.clamp(lse, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))        # (B, qb, KV, G, hd)
    out = torch.cat(outs, dim=1).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None, window_flag=None):
    """q: (B, 1, H, hd); caches: (B, S_max, KV, hd); ``cache_len``: int32
    scalar tensor or int -- the number of valid cache entries before this
    token, i.e. the new token's position (its own K/V are already in the
    cache at that position).  ``window``/``window_flag`` as in the
    reference: a windowed query sees positions in (len - window, len];
    ``window_flag`` False lifts the window (a global layer)."""
    b, _, h, hd = q.shape
    _, s_max, kv, _ = k_cache.shape
    g = h // kv
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, 1, kv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    pos = torch.arange(s_max, device=q.device)
    mask = pos <= cache_len
    if window is not None:
        in_win = pos > (cache_len - window)
        if window_flag is not None:
            in_win = in_win | torch.logical_not(torch.as_tensor(
                window_flag, device=q.device))
        mask = mask & in_win
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def attention_output(wo, ctx):
    b, s, h, hd = ctx.shape
    return ctx.reshape(b, s, h * hd) @ wo
