"""RWKV-6 "Finch" block: attention-free time mixing with data-dependent
per-channel decay (arXiv:2404.05892), plus the squared-ReLU channel mix
(port of ``repro.models.rwkv``).

Per head (hd = head size) the state is the (hd, hd) accumulator

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with w_t in (0, 1) made from the token through a small low-rank
bottleneck.  A sequence whose length is a multiple of ``WKV_CHUNK`` (and
longer than one chunk) runs the reference's chunk-parallel formula
(:func:`wkv_chunk_parallel`); any other length runs the sequential
recurrence -- decode is ``rwkv_mix`` on one token, the reference's
``rwkv_decode`` step.  Token shift mixes x_t with
x_{t-1}; its decode state is the previous token's input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DECAY_LORA = 64
TMIX, CMIX = "tmix/", "cmix/"   # the time and channel mixes' leaves
WKV_CHUNK = 32
_CLAMP = 60.0


def _token_shift(x, prev):
    """x: (B, S, D); prev: (B, D), the last token of the previous
    segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _projections(p, x, shifted, n_heads: int):
    b, s, d = x.shape
    hd = d // n_heads

    def mix(m):
        w = p[f"{TMIX}mix_{m}"]
        return x * w + shifted * (1.0 - w)

    r = (mix("r") @ p[TMIX + "wr"]).reshape(b, s, n_heads, hd)
    k = (mix("k") @ p[TMIX + "wk"]).reshape(b, s, n_heads, hd)
    v = (mix("v") @ p[TMIX + "wv"]).reshape(b, s, n_heads, hd)
    g = F.silu(mix("g") @ p[TMIX + "wg"])
    dec = torch.tanh(mix("w") @ p[TMIX + "w_decay_a"]) @ p[
        TMIX + "w_decay_b"]
    w = torch.exp(-torch.exp((p[TMIX + "decay_base"] + dec)
                             .to(torch.float32))).reshape(b, s, n_heads, hd)
    return r, k, v, g, w


def wkv_chunk_parallel(r, k, v, w, u, state):
    """The reference's chunkwise-parallel WKV: (B, S, H, hd) inputs with S
    a multiple of ``WKV_CHUNK``, the (B, H, hd, hd) carry.  Per chunk of
    length C, with cum_t = sum_{s<=t} log max(w_s, 1e-30):

      y_t   = (r_t e^{cum_{t-1}}) S_in
            + sum_{s<t} ((r_t e^{cum_{t-1}}) . (k_s e^{-cum_s})) v_s
            + (r_t . u . k_t) v_t
      S_out = e^{cum_{C-1}} S_in + sum_s (k_s e^{cum_{C-1} - cum_s}) v_s

    each exponent clamped at +-60 as the reference clamps it.  Returns
    (y (B, S, H, hd) float32, state)."""
    b, s, h, hd = r.shape
    c = WKV_CHUNK
    n = s // c
    f32 = torch.float32
    r, k, v, w = (a.to(f32).reshape(b, n, c, h, hd) for a in (r, k, v, w))
    cum = torch.cumsum(torch.log(torch.clamp(w, min=1e-30)), dim=2)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    ys = []
    for i in range(n):
        rc, kc, vc, cumc = r[:, i], k[:, i], v[:, i], cum[:, i]
        cum_excl = torch.cat([torch.zeros_like(cumc[:, :1]), cumc[:, :-1]],
                             dim=1)
        r_dec = rc * torch.exp(torch.clamp(cum_excl, min=-_CLAMP))
        y_in = torch.einsum("bthk,bhkv->bthv", r_dec, state)
        k_dec = kc * torch.exp(torch.clamp(-cumc, max=_CLAMP))
        att = torch.einsum("bthk,bshk->bhts", r_dec, k_dec)
        att = torch.where(mask, att, torch.zeros((), dtype=f32,
                                                 device=r.device))
        y_intra = torch.einsum("bhts,bshv->bthv", att, vc)
        bonus = torch.einsum("bthk,hk,bthk->bth", rc, u, kc)
        y_bonus = bonus[..., None] * vc
        k_tail = kc * torch.exp(cumc[:, -1:] - cumc)
        state = (torch.exp(cumc[:, -1])[:, :, :, None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_tail, vc))
        ys.append(y_in + y_intra + y_bonus)
    return torch.stack(ys, dim=1).reshape(b, s, h, hd), state


def wkv_sequential(r, k, v, w, u, state):
    """The recurrence one token at a time: (y (B, S, H, hd) float32,
    state)."""
    f32 = torch.float32
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].to(f32), v[:, t].to(f32))
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(f32),
                               state + u[None, :, :, None] * kv))
        state = w[:, t].to(f32)[..., None] * state + kv
    return torch.stack(ys, dim=1), state


def rwkv_mix(p: dict, x, n_heads: int, *, state=None, shift_state=None):
    """Full-sequence time mix.  Returns (y, (state (B, H, hd, hd) float32,
    shift_state (B, D)))."""
    b, s, d = x.shape
    hd = d // n_heads
    if shift_state is None:
        shift_state = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    if state is None:
        state = torch.zeros((b, n_heads, hd, hd), dtype=torch.float32,
                            device=x.device)
    shifted = _token_shift(x, shift_state)
    r, k, v, g, w = _projections(p, x, shifted, n_heads)
    u = p[TMIX + "bonus_u"].to(torch.float32)
    if s % WKV_CHUNK == 0 and s > WKV_CHUNK:
        y, state = wkv_chunk_parallel(r, k, v, w, u, state)
    else:
        y, state = wkv_sequential(r, k, v, w, u, state)
    y = y.reshape(b, s, d).to(x.dtype) * g
    return y @ p[TMIX + "wo"], (state, x[:, -1])


def channel_mix(p: dict, x, shift_state=None):
    """RWKV channel mix (squared-ReLU FFN with token shift).  Returns (y,
    new_shift_state)."""
    b, s, d = x.shape
    if shift_state is None:
        shift_state = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    shifted = _token_shift(x, shift_state)
    mk = p[CMIX + "mix_k"]
    xk = x * mk + shifted * (1.0 - mk)
    h = torch.square(F.relu(xk @ p[CMIX + "wk"]))
    return h @ p[CMIX + "wv"], x[:, -1]
