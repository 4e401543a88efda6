"""Mamba2-style selective state-space block for the zamba2 hybrid (port of
``repro.models.ssm``; arXiv:2411.15242, arXiv:2405.21060).

Per head the state is h in R^(P x N) (P = head channels, N = ssm_state):

    h_t = exp(-exp(a) dt_t) h_{t-1} + dt_t x_t B_t^T
    y_t = h_t C_t + D x_t

with dt_t = softplus(dt_raw + dt_bias), a causal depthwise convolution in
front, and a gated, normed output.  Training and prefill run the
recurrence one token at a time over S, as the reference's scan does (the
input terms of a chunk of ``SCAN_CHUNK`` tokens made at once, one fused
multiply-add a token in the loop, so that a long prompt holds the
chunk's states and not every token's);
decode is ``mamba_mix`` on one token (the reference's ``mamba_decode``),
carrying the state and the convolution's last ``W - 1`` inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm

PRE = "mamba/"   # the block's leaves
# tokens whose (B, T, H, P, N) input terms and states are held at once
SCAN_CHUNK = 128


def _split_proj(p, x, d_model: int, n_heads: int, ssm_state: int,
                expand: int):
    d_inner = expand * d_model
    proj = x @ p[PRE + "w_in"]
    return torch.split(proj, [d_inner, d_inner, ssm_state, ssm_state,
                              n_heads], dim=-1)


def _causal_conv(p, xs, conv_state=None):
    """Depthwise causal conv over time.  xs: (B, S, d_inner); conv_state:
    (B, W-1, d_inner), the previous segment's trailing inputs.  Returns
    (out, new conv_state)."""
    w = p[PRE + "conv_w"]
    width = w.shape[0]
    b, s, d = xs.shape
    if conv_state is None:
        conv_state = torch.zeros((b, width - 1, d), dtype=xs.dtype,
                                 device=xs.device)
    padded = torch.cat([conv_state, xs], dim=1)
    out = torch.zeros_like(xs)
    for i in range(width):
        out = out + padded[:, i:i + s] * w[i]
    return F.silu(out + p[PRE + "conv_b"]), padded[:, -(width - 1):]


def mamba_mix(p: dict, x, *, n_heads: int, ssm_state: int, expand: int = 2,
              state=None, conv_state=None):
    """Full-sequence SSD mix.  x: (B, S, D).  Returns (y, (state (B, H, P,
    N) float32, conv_state))."""
    f32 = torch.float32
    b, s, d_model = x.shape
    d_inner = expand * d_model
    hd = d_inner // n_heads

    xs, z, bmat, cmat, dt = _split_proj(p, x, d_model, n_heads, ssm_state,
                                        expand)
    xs, conv_state = _causal_conv(p, xs, conv_state)
    xs = xs.reshape(b, s, n_heads, hd)
    dt = F.softplus(dt.to(f32) + p[PRE + "dt_bias"].to(f32))  # (B, S, H)
    decay = torch.exp(-torch.exp(p[PRE + "a_log"]).to(f32)[None, None]
                      * dt)
    if state is None:
        state = torch.zeros((b, n_heads, hd, ssm_state), dtype=f32,
                            device=x.device)
    xf, bf, cf = xs.to(f32), bmat.to(f32), cmat.to(f32)
    ys = []
    for c in range(0, s, SCAN_CHUNK):
        t1 = min(c + SCAN_CHUNK, s)
        # the input term dt_t x_t B_t^T of the chunk's tokens at once; the
        # loop then costs one fused multiply-add a token
        dbx = ((dt[:, c:t1, :, None] * xf[:, c:t1])[..., None]
               * bf[:, c:t1, None, None, :])
        hs = []
        for t in range(t1 - c):
            state = torch.addcmul(dbx[:, t], decay[:, c + t, :, None, None],
                                  state)
            hs.append(state)
        ys.append(torch.einsum("bshpn,bsn->bshp", torch.stack(hs, dim=1),
                               cf[:, c:t1]))                  # (B, T, H, P)
    ys = torch.cat(ys, dim=1) + p[PRE + "d_skip"].to(f32)[None, None] * xf
    y = ys.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y, p[PRE + "norm_w"]) * F.silu(z)
    return y @ p[PRE + "w_out"], (state, conv_state)

