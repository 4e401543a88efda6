"""The port's flash-attention wrapper (``repro_torch.kernels.flash_attention``)
on the CPU, where it runs its plain version: against the reference's Pallas
kernel in interpret mode on every case of tests/test_flash_kernel.py and on
qwen2-0.5b's head layout, against the reference's jnp oracle and the port's
blockwise function, its refusals, and that ``prefill`` (not ``forward``)
goes through it.

Tolerances: float32 outputs within 1e-6 of the reference's largest
magnitude -- the plain version keeps the Pallas kernel's blocks, masks and
operation order, so only the matmuls' summation order and exp's last bit
differ (measured about 2e-7 of it, 1-2 ulp).  bfloat16 outputs within one
bfloat16 ulp of the larger of the two values: both sides compute in
float32 from the same bfloat16 inputs and round once, so a value within a
few float32 ulp of a rounding boundary may land one bfloat16 ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_kernel
from repro.models import attention as ref_attn
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import rbd_step
from repro_torch.models import attention, transformer
from repro_torch.models.registry import get_model

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

F32_RTOL = 1e-6      # of the largest magnitude
BF16_ULPS = 1.0      # of the larger of the two values


def _qkv(seed, b, sq, sk, h, kv, hd):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((b, sq, h, hd)).astype(np.float32),
            rs.standard_normal((b, sk, kv, hd)).astype(np.float32),
            rs.standard_normal((b, sk, kv, hd)).astype(np.float32))


def _reference(q, k, v, **kw):
    return np.asarray(ref_kernel.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        **kw))


def _port(q, k, v, **kw):
    with torch.no_grad():
        return flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                     **kw).numpy()


def _close_f32(got, want, what):
    tol = F32_RTOL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max|d| {err:.3g} > {tol:.3g}"


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), for normal values."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("sq,hkv,window", [
    (256, (4, 4), None),          # MHA causal
    (256, (8, 2), None),          # GQA 4:1
    (200, (4, 1), None),          # MQA, ragged length
    (256, (4, 2), 64),            # sliding window
    (384, (2, 2), 100),           # window not a block multiple
    (200, (14, 2), None),         # qwen2-0.5b's heads, hd 64, ragged
])
def test_plain_matches_reference_kernel(sq, hkv, window):
    h, kv = hkv
    hd = 64 if h == 14 else 16
    q, k, v = _qkv(sq + h, 2, sq, sq, h, kv, hd)
    want = _reference(q, k, v, causal=True, window=window, q_block=128,
                      kv_block=128)
    got = _port(q, k, v, causal=True, window=window, q_block=128,
                kv_block=128)
    assert got.shape == want.shape == (2, sq, h, hd)
    _close_f32(got, want, f"sq {sq} heads {hkv} window {window}")


def test_plain_matches_reference_kernel_noncausal():
    q, k, v = _qkv(0, 1, 128, 256, 4, 4, 32)
    _close_f32(_port(q, k, v, causal=False),
               _reference(q, k, v, causal=False), "non-causal 128 x 256")


def test_plain_matches_reference_kernel_bf16():
    q, k, v = _qkv(3, 1, 128, 128, 4, 2, 32)
    want = np.asarray(ref_kernel.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), interpret=True))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        out = flash.flash_attention(
            *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    want = want.astype(np.float32)
    ulps = np.abs(got - want) / _bf16_ulp(np.maximum(np.abs(got),
                                                     np.abs(want)))
    assert ulps.max() <= BF16_ULPS, f"bf16: {ulps.max()} ulps"


def test_plain_block_invariance_matches_reference_kernel():
    q, k, v = _qkv(5, 1, 256, 256, 2, 2, 16)
    a = _port(q, k, v, q_block=128, kv_block=128)
    b = _port(q, k, v, q_block=64, kv_block=256)
    _close_f32(b, _reference(q, k, v, q_block=64, kv_block=256),
               "blocks 64 x 256")
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_rows_without_a_live_key_match_reference_kernel():
    """A window and Sq > Sk leave the last rows no live key: the reference
    averages v over its padded K/V there (p = 1 at every position)."""
    q, k, v = _qkv(9, 1, 300, 100, 2, 1, 16)
    for causal in (False, True):
        want = _reference(q, k, v, causal=causal, window=50)
        _close_f32(_port(q, k, v, causal=causal, window=50), want,
                   f"rows without a live key, causal={causal}")
    np.testing.assert_allclose(want[0, -1, 0], v[0, :, 0].sum(0) / 128,
                               rtol=1e-5, atol=1e-6)


def test_plain_matches_jnp_oracle_and_port_blockwise():
    q, k, v = _qkv(7, 2, 300, 300, 8, 2, 32)
    got = _port(q, k, v, causal=True, window=100)
    want = np.asarray(ref_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=100))
    _close_f32(got, want, "jnp oracle")
    blockwise = attention.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        window=100).numpy()
    _close_f32(got, blockwise, "port blockwise")


def test_wrapper_refusals():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 16, 16, 2, 1, 16))
    with pytest.raises(RuntimeError, match="forward only"):
        flash.flash_attention(q.clone().requires_grad_(), k, v)
    with torch.no_grad():   # no graph, so no gradient is lost
        flash.flash_attention(q.clone().requires_grad_(), k, v)
    q8, k8, v8 = (torch.from_numpy(x) for x in _qkv(1, 1, 16, 16, 2, 1, 8))
    with pytest.raises(ValueError, match="head size 8"):
        flash.flash_attention(q8, k8, v8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="kv_block"):
        flash.flash_attention(q, k, v, kv_block=96)
    with pytest.raises(ValueError, match="at least one position"):
        flash.flash_attention(q, k[:, :0], v[:, :0])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "tinyllama-1.1b"])
def test_prefill_goes_through_the_kernel_forward_does_not(arch):
    cfg = get_config(arch).reduced(compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (1, 20)))
    rbd_step.reset_counts()
    with torch.no_grad():
        logits, _ = transformer.prefill(cfg, params, tokens, 32)
    assert rbd_step.CALLS["flash_attention"] == cfg.n_layers
    assert sum(rbd_step.LAUNCHES.values()) == 0     # the CPU: plain version
    full, _ = transformer.forward(cfg, params, tokens)
    assert rbd_step.CALLS["flash_attention"] == cfg.n_layers
    _close_f32(logits.numpy()[:, 0], full.detach().numpy()[:, -1],
               "prefill vs forward, last position")
