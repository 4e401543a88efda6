"""Elementary layers: norms, MLPs, embeddings (port of
``repro.models.layers``).  Parameters are plain tensors; init functions
take an explicit ``torch.Generator``."""

from __future__ import annotations

import functools

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


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


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


def from_float64(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float64 numpy array in ``dtype`` with the reference's bits:
    ``jnp.asarray(a, dtype)`` rounds to float32 first, then to a narrower
    type (so bf16 is rounded twice)."""
    return torch.from_numpy(np.asarray(a, np.float64)).to(
        torch.float32).to(dtype)


@functools.lru_cache(maxsize=None)
def sinusoidal_positions(seq: int, d_model: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings (seq, d_model),
    computed in float64 on the host as the reference does and copied to
    ``device`` once per (seq, d_model, dtype, device)."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return from_float64(out, dtype).to(device)
