"""Flash attention (forward) for the prefill, beside its plain PyTorch
version.

* :func:`flash_attention` -- one launch: causal / sliding-window GQA
  attention with an online softmax, q ``(B, Sq, H, hd)``, k and v ``(B,
  Sk, KV, hd)`` with H = KV * G, out ``(B, Sq, H, hd)`` in q's dtype
  (replaces the reference's ``repro/kernels/flash_attention.py:
  flash_attention -> _flash_kernel``).

Two kernels of ``csrc/flash_attention.cu`` compute it, chosen by
:func:`kernel_for` from (dtype, head size) alone, before any launch:
``"wgmma"`` (``flash_attention_forward_wgmma``: bf16 at head size 64, 80,
128 or 256, on the tensor cores, P rounded to bf16 for P V) and ``"fma"``
(``flash_attention_forward``: f32, and bf16 at head size 16 or 32, on
the CUDA cores, P in f32).  The wrapper takes the chosen kernel's plain
version for tensors on the CPU, and only then; for CUDA tensors it calls
the op ``torch.ops.repro_torch.flash_attention``, which launches the
chosen kernel or raises (a meta tensor reaches the op's fake
implementation, see :mod:`repro_torch.kernels.rbd_step`).  Like the
reference's kernel it is forward only: it raises when grad mode is on
and an input requires grad, rather than hand back a result that
gradients cannot flow through.
Launches, calls and CUDA-event times are counted in
:mod:`repro_torch.kernels.rbd_step`'s ``LAUNCHES``/``CALLS`` under
``"flash_attention"``, launches by kernel in ``VARIANT_LAUNCHES`` under
``"flash_attention[wgmma]"`` and ``"flash_attention[fma]"``, and the
source is built with the other kernels'.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import rbd_step

NEG_INF = -1e30
Q_BLOCK = 128
KV_BLOCK = 128
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# rows of a K/V tile of the CUDA-core kernel: the padded K/V length that a
# row with no live key averages over must be a whole number of tiles
KERNEL_TILE = 64
# the tensor-core kernel: bf16 at these head sizes, with K/V tiles of
# these rows (the points where its P is rounded to bf16; 64 at head size
# 256, whose 128-row K and V stages would not fit shared memory)
WGMMA_TILE = {64: 128, 80: 128, 128: 128, 256: 64}
WGMMA_HEAD_DIMS = tuple(WGMMA_TILE)
KERNELS = ("wgmma", "fma")
# the dtype P is rounded to for P V, by kernel
P_DTYPE = {"wgmma": torch.bfloat16, "fma": torch.float32}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def kernel_for(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes inputs of ``dtype`` and head size ``hd``:
    ``"wgmma"`` for bf16 at head size 64, 80, 128 or 256, else ``"fma"``
    (f32 may not run on the tensor cores: TF32 is not allowed)."""
    if dtype == torch.bfloat16 and int(hd) in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


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


def _check_takes(q, k, v, hd, kv_block) -> None:
    """What the kernels take, refused alike on every device."""
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
    _check_takes(q, k, v, hd, kv_block)
    kernel = kernel_for(q.dtype, hd)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_block=q_block, kv_block=kv_block,
                                     p_dtype=P_DTYPE[kernel])
    return _launch_kernel(q, k, v, kernel=kernel, causal=causal,
                          window=window, kv_block=kv_block)


def _launch_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   kernel: str, causal: bool = True,
                   window: Optional[int] = None, kv_block: int = KV_BLOCK):
    """One launch of the named kernel on CUDA tensors: :func:`kernel_for`'s
    choice from the wrapper; the checks name the ``"fma"`` kernel for bf16
    at the tensor-core kernel's head sizes to compare the two."""
    b, sq, h, hd, sk, kv = _shapes(q, k, v, window, Q_BLOCK, kv_block)
    _check_takes(q, k, v, hd, kv_block)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "wgmma" and kernel_for(q.dtype, hd) != "wgmma":
        raise ValueError("the wgmma kernel takes bfloat16 at head size "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device.type not in rbd_step.KERNEL_DEVICES
                or t.device != q.device):
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return _flash_attention_op(q, k, v, KERNELS.index(kernel), bool(causal),
                               0 if window is None else int(window),
                               kv_block)


@rbd_step.kernel_op("flash_attention")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kernel: int, causal: bool, window: int,
                        kv_block: int) -> torch.Tensor:
    """``kernel``: the index of the kernel in :data:`KERNELS`; ``window``
    0 for none."""
    b, sq, h, hd = (int(x) for x in q.shape)
    sk, kv = int(k.shape[1]), int(k.shape[2])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if sq == 0 or b == 0:
        return out
    sk_pad = -(-sk // kv_block) * kv_block
    lib = rbd_step.library(rbd_step.FLASH_SOURCE).lib
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (hd, b, sq, sk, h, kv, int(causal), window, sk_pad,
             1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        if KERNELS[kernel] == "wgmma":
            rbd_step._launch("flash_attention",
                             lib.flash_attention_forward_wgmma, *args,
                             *shape, key="flash_attention[wgmma]")
        else:
            rbd_step._launch("flash_attention", lib.flash_attention_forward,
                             *args, _DTYPE_CODE[q.dtype], *shape,
                             key="flash_attention[fma]")
    return out


@_flash_attention_op.register_fake
def _(q, k, v, kernel, causal, window, kv_block):
    return torch.empty_like(q)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None,
                          q_block: int = Q_BLOCK, kv_block: int = KV_BLOCK,
                          p_dtype: torch.dtype = torch.float32,
                          return_l: bool = False):
    """Plain PyTorch version of :func:`flash_attention`, on q's device:
    the Pallas kernel's function as written -- q and K/V padded to whole
    blocks, the kv blocks in order, each masked (``k_pos < Sk``, causal
    ``k_pos <= q_pos``, window ``k_pos > q_pos - window``) to the -1e30
    sentinel, f32 running max, denominator and accumulator, and ``max(l,
    1e-30)`` in the final divide.  Every query block runs at once (the
    reference's grid runs them one after another; each row's arithmetic
    is the same).

    ``p_dtype=torch.bfloat16`` is the tensor-core kernel's function: the
    kv tiles are its rows at head size hd (``WGMMA_TILE``; 128 at a head
    size it does not take), positions past the padded K/V (in the last
    tile when ``kv_block`` is not a multiple of the tile) get p = 0, and p
    is rounded to bf16 for P V while l sums the f32 p.

    ``return_l=True`` returns ``(out, l)``: l (B, Sq, H) f32 is each row's
    denominator in units of its largest p, so 1 / l is the row's largest
    attention weight (what one p rounded to the other bf16 neighbour can
    move the row by, in the checks of the tensor-core kernel)."""
    if p_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"p_dtype must be float32 or bfloat16, got "
                         f"{p_dtype}")
    b, sq, h, hd, sk, kv = _shapes(q, k, v, window, q_block, kv_block)
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    sq_p = -(-sq // q_block) * q_block
    sk_p = -(-sk // kv_block) * kv_block
    tile = kv_block if p_dtype == torch.float32 else WGMMA_TILE.get(hd, 128)
    sk_t = -(-sk_p // tile) * tile
    dev = q.device
    # query head h = kv * G + g reads K/V head kv: (B, KV, G, Sq_p, hd)
    qf = torch.nn.functional.pad(q.to(torch.float32),
                                 (0, 0, 0, 0, 0, sq_p - sq))
    qf = qf.reshape(b, sq_p, kv, g, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (torch.nn.functional.pad(t.to(torch.float32),
                                      (0, 0, 0, 0, 0, sk_t - sk))
              .permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    q_pos = torch.arange(sq_p, device=dev)[:, None]
    m = torch.full((b, kv, g, sq_p, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, g, sq_p, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, sk_t, tile):
        s = torch.matmul(qf, kf[..., k0: k0 + tile, :]
                         .transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + tile, device=dev)[None, :]
        mask = k_pos < sk
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        if k0 + tile > sk_p:
            s = torch.where(k_pos < sk_p, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if p_dtype != torch.float32:
            p = p.to(p_dtype).to(torch.float32)
        acc = acc * alpha + torch.matmul(p, vf[..., k0: k0 + tile, :])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq_p, h, hd)[:, :sq]
    if return_l:
        return out.to(q.dtype), l.permute(0, 3, 1, 2, 4).reshape(
            b, sq_p, h)[:, :sq]
    return out.to(q.dtype)
