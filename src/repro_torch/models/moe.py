"""Mixture-of-experts FFN with top-k routing and capacity-bounded scatter
dispatch (port of ``repro.models.moe``).

The token stream is cut into ``g = gcd(groups, B)`` dispatch groups, the
reference's rule outside a mesh.  Routing runs in float32 (``x @
router``), the top-k gates are renormalised, and each (token, k) slot
takes the next free position of its expert's buffer in its group (a
per-group cumulative count); slots past the capacity ``max(ceil(T k / E
cf), k)`` are dropped: they write zeros into the buffer's last slot, as
the reference's clamped scatter does, and get no output.  The buffer is
``(G, E, C, D)``; each expert's SwiGLU is one einsum over it, and a
gather brings the slots back, weighted by their gates.  The auxiliary
load-balance loss is ``E * sum_e me_e ce_e`` (Shazeer et al.).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def moe_ffn(p: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, groups: int = 1):
    """x: (B, S, D) -> (y (B, S, D), aux scalar float32); ``p`` holds the
    ``moe/router``/``w_gate``/``w_up``/``w_down`` leaves."""
    b, s, d = x.shape
    g = math.gcd(groups, b)
    t = (b // g) * s
    router = p["moe/router"]
    e = router.shape[-1]
    xt = x.reshape(g, t, d)

    logits = xt.to(torch.float32) @ router.to(torch.float32)   # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, top_k, dim=-1)       # (G, T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss: E * sum_e f_e * p_e (global average)
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((g * t * top_k,), 1.0 / (g * t * top_k),
                   dtype=torch.float32, device=x.device))
    aux = e * torch.sum(me * ce)

    capacity = max(int(math.ceil(t * top_k / e * capacity_factor)), top_k)

    # position of each (token, k) slot within its (group, expert) buffer
    e_flat = expert_idx.reshape(g, t * top_k)                   # (G, T*k)
    oh = F.one_hot(e_flat, e)                                   # (G, T*k, E)
    pos = torch.cumsum(oh, dim=1) - oh                          # per group
    p_flat = torch.sum(pos * oh, dim=-1)                        # (G, T*k)
    keep = (p_flat < capacity)[..., None]
    p_flat = torch.clamp(p_flat, max=capacity - 1)

    x_rep = torch.repeat_interleave(xt, top_k, dim=1)           # (G, T*k, D)
    x_rep = torch.where(keep, x_rep, torch.zeros((), dtype=x_rep.dtype,
                                                 device=x.device))
    gi = torch.arange(g, device=x.device)[:, None].expand_as(e_flat)
    buf = torch.zeros((g, e, capacity, d), dtype=xt.dtype, device=x.device)
    buf = buf.index_put((gi, e_flat, p_flat), x_rep, accumulate=True)

    gate = F.silu(torch.einsum("gecd,edf->gecf", buf, p["moe/w_gate"]))
    up = torch.einsum("gecd,edf->gecf", buf, p["moe/w_up"])
    out_buf = torch.einsum("gecf,efd->gecd", gate * up, p["moe/w_down"])

    y_rep = out_buf[gi, e_flat, p_flat]                         # (G, T*k, D)
    y_rep = torch.where(keep, y_rep, torch.zeros((), dtype=y_rep.dtype,
                                                 device=x.device))
    y_rep = y_rep * gates.reshape(g, -1)[..., None].to(y_rep.dtype)
    y = y_rep.reshape(g, t, top_k, d).sum(dim=2)
    return y.reshape(b, s, d), aux

