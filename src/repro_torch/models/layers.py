"""Elementary layers: norms, MLPs, embeddings (port of
``repro.models.layers``).  Parameters are plain tensors; init functions
take an explicit ``torch.Generator``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def cast_for_compute(params: dict, cdt: torch.dtype) -> dict:
    """Cast float params to the compute dtype at forward entry (the
    master copy stays float32; norms upcast internally)."""
    return {k: (v.to(cdt) if v.is_floating_point() else v)
            for k, v in params.items()}


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               shape_prefix=(), device=None) -> torch.Tensor:
    scale = 1.0 / np.sqrt(d_in)
    return torch.randn((*shape_prefix, d_in, d_out), generator=gen,
                       device=device) * scale


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def mlp(p_up, p_gate, p_down, x, act: str = "silu"):
    """SwiGLU (act='silu') or GELU MLP; the down projection returns the
    activation dtype."""
    up = x @ p_up
    if act == "silu":
        h = F.silu(x @ p_gate) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu default
    return (h @ p_down).to(x.dtype)


def embed(table, tokens):
    return table[tokens]


def unembed(table_or_head, x, *, tied: bool):
    if tied:
        return x @ table_or_head.T
    return x @ table_or_head
