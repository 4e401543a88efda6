"""Flash attention (forward) for the prefill, beside its plain PyTorch
version.

* :func:`flash_attention` -- one launch: causal / sliding-window GQA
  attention with an online softmax, q ``(B, Sq, H, hd)``, k and v ``(B,
  Sk, KV, hd)`` with H = KV * G, out ``(B, Sq, H, hd)`` in q's dtype
  (replaces the reference's ``repro/kernels/flash_attention.py:
  flash_attention -> _flash_kernel``).

The wrapper takes its plain version for tensors on the CPU, and only
then; for CUDA tensors it launches ``flash_attention_forward`` of
``csrc/flash_attention.cu`` or raises.  Like the reference's kernel it is
forward only: it raises when grad mode is on and an input requires grad,
rather than hand back a result that gradients cannot flow through.
Launches, calls and CUDA-event times are counted in
:mod:`repro_torch.kernels.rbd_step`'s ``LAUNCHES``/``CALLS`` under
``"flash_attention"``, and the source is built with the other kernels'.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import rbd_step

NEG_INF = -1e30
Q_BLOCK = 128
KV_BLOCK = 128
HEAD_DIMS = (16, 32, 64, 128)
# rows of a K/V tile of the CUDA kernel: the padded K/V length that a row
# with no live key averages over must be a whole number of tiles
KERNEL_TILE = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(q, k, v, window, q_block, kv_block):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError("q must be (B, Sq, H, hd) and k, v (B, Sk, KV, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = (int(x) for x in q.shape)
    bk, sk, kv, hdk = (int(x) for x in k.shape)
    if bk != b or hdk != hd or kv < 1 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         "batch and head size must agree and H be a "
                         "multiple of KV")
    if sk < 1:
        raise ValueError("k and v must hold at least one position")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q_block < 1 or kv_block < 1:
        raise ValueError(f"blocks must be >= 1, got {q_block}, {kv_block}")
    return b, sq, h, hd, sk, kv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_block: int = Q_BLOCK, kv_block: int = KV_BLOCK):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).

    ``window``: a static sliding window, applied also when not causal;
    ``q_block``/``kv_block``: the reference's blocks (the result depends
    on ``kv_block`` only for a row with no live key, which averages v
    over the padded K/V)."""
    rbd_step.CALLS["flash_attention"] += 1
    b, sq, h, hd, sk, kv = _shapes(q, k, v, window, q_block, kv_block)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward only (as the reference's Pallas "
            "kernel): call it under torch.no_grad() or with inputs that do "
            "not require grad")
    # what the kernel takes, refused alike on every device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"{name} must be float32 or bfloat16 like q, got "
                             f"{t.dtype} (q {q.dtype})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not supported: the kernel takes "
                         f"{HEAD_DIMS}")
    if kv_block % KERNEL_TILE:
        raise ValueError(f"kv_block must be a multiple of {KERNEL_TILE}, got "
                         f"{kv_block}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_block=q_block, kv_block=kv_block)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if sq == 0 or b == 0:
        return out
    sk_pad = -(-sk // kv_block) * kv_block
    lib = rbd_step.library(rbd_step.FLASH_SOURCE).lib
    with torch.cuda.device(q.device):
        rbd_step._launch(
            "flash_attention", lib.flash_attention_forward, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
            hd, b, sq, sk, h, kv, int(bool(causal)),
            0 if window is None else int(window), sk_pad,
            1.0 / math.sqrt(hd))
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None,
                          q_block: int = Q_BLOCK, kv_block: int = KV_BLOCK):
    """Plain PyTorch version of :func:`flash_attention`, on q's device:
    the Pallas kernel's function as written -- q and K/V padded to whole
    blocks, the kv blocks in order, each masked (``k_pos < Sk``, causal
    ``k_pos <= q_pos``, window ``k_pos > q_pos - window``) to the -1e30
    sentinel, f32 running max, denominator and accumulator, and ``max(l,
    1e-30)`` in the final divide.  Every query block runs at once (the
    reference's grid runs them one after another; each row's arithmetic
    is the same)."""
    b, sq, h, hd, sk, kv = _shapes(q, k, v, window, q_block, kv_block)
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    sq_p = -(-sq // q_block) * q_block
    sk_p = -(-sk // kv_block) * kv_block
    dev = q.device
    # query head h = kv * G + g reads K/V head kv: (B, KV, G, Sq_p, hd)
    qf = torch.nn.functional.pad(q.to(torch.float32),
                                 (0, 0, 0, 0, 0, sq_p - sq))
    qf = qf.reshape(b, sq_p, kv, g, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (torch.nn.functional.pad(t.to(torch.float32),
                                      (0, 0, 0, 0, 0, sk_p - sk))
              .permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    q_pos = torch.arange(sq_p, device=dev)[:, None]
    m = torch.full((b, kv, g, sq_p, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, g, sq_p, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, sk_p, kv_block):
        s = torch.matmul(qf, kf[..., k0: k0 + kv_block, :]
                         .transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + kv_block, device=dev)[None, :]
        mask = k_pos < sk
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[..., k0: k0 + kv_block, :])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq_p, h, hd)
    return out[:, :sq].to(q.dtype)
