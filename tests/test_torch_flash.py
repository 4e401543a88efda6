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

The plain version's ``p_dtype=torch.bfloat16`` form (the tensor-core
kernel's function: P rounded to bf16 for P V, at its tiles of 128 keys,
64 at head size 256) against
the Pallas kernel: within 2**-8 max|v| + one bfloat16 ulp of the larger
output + 1e-5 max|v|.  Rounding p to bf16 moves it by at most half a
bf16 ulp, 2**-8 of itself, and the weights p / l sum to 1, so an output
element moves by at most that part of max|v|; the ulp covers a bf16
output's own rounding, 1e-5 max|v| the f32 sums.
"""

import math

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
P_BF16_OF_V = 2.0 ** -8 + 1e-5   # P rounded to bf16: of max|v|, plus an ulp


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


# -- the tensor-core kernel's function: P rounded to bf16 for P V ------------

def _p_bf16_close(got, want, v, what):
    """Within 2**-8 max|v| + 1e-5 max|v| + one bf16 ulp of the larger
    value; returns the largest |difference| as a part of max|v|."""
    vmax = float(np.abs(np.asarray(v, np.float32)).max())
    err = np.abs(got - want)
    tol = P_BF16_OF_V * vmax + _bf16_ulp(np.maximum(np.abs(got),
                                                    np.abs(want)))
    assert (err <= tol).all(), (
        f"{what}: max|d| {err.max():.3g} ({err.max() / vmax:.3g} of max|v|)"
        f" over the tolerance")
    return float(err.max()) / vmax


def _p_bf16(q, k, v, **kw):
    with torch.no_grad():
        return flash.flash_attention_plain(
            *(torch.from_numpy(np.asarray(x)) for x in (q, k, v)),
            p_dtype=torch.bfloat16, **kw).float().numpy()


# (B, Sq, Sk, H, KV, hd, seed, kw): tests/test_flash_kernel.py's cases (its
# five parametrized ones, the non-causal one, the bf16 one, the block
# invariance one at both block pairs), qwen2-0.5b's heads at a ragged
# length, and kv_block = 64 with Sk = 150 (Sk_pad 192: the last 128-key
# tile has 64 positions past it) and rows with no live key; then zamba2's
# head size (80; 128-key tiles) and gemma3's (256; 64-key tiles), causal,
# windowed, GQA, bf16 inputs and rows with no live key
P_BF16_CASES = [
    (2, 256, 256, 4, 4, 16, 260, dict(window=None)),
    (2, 256, 256, 8, 2, 16, 264, dict(window=None)),
    (2, 200, 200, 4, 1, 16, 204, dict(window=None)),
    (2, 256, 256, 4, 2, 16, 260, dict(window=64)),
    (2, 384, 384, 2, 2, 16, 386, dict(window=100)),
    (1, 128, 256, 4, 4, 32, 0, dict(causal=False)),
    (1, 128, 128, 4, 2, 32, 3, dict(dtype="bfloat16")),
    (1, 256, 256, 2, 2, 16, 5, dict(q_block=128, kv_block=128)),
    (1, 256, 256, 2, 2, 16, 5, dict(q_block=64, kv_block=256)),
    (2, 200, 200, 14, 2, 64, 214, dict(window=None)),
    (1, 400, 150, 2, 1, 64, 11, dict(window=50, kv_block=64)),
    (1, 400, 150, 2, 1, 64, 11, dict(window=50, kv_block=64,
                                     causal=False)),
    (1, 256, 256, 4, 4, 80, 80, dict(window=None)),
    (1, 200, 200, 4, 2, 80, 81, dict(window=64)),
    (1, 128, 128, 4, 4, 80, 82, dict(dtype="bfloat16")),
    (1, 256, 256, 4, 2, 256, 256, dict(window=None)),
    (1, 200, 200, 2, 1, 256, 257, dict(window=100)),
    (1, 128, 128, 4, 2, 256, 258, dict(dtype="bfloat16")),
    (1, 256, 150, 2, 1, 256, 259, dict(window=50, kv_block=64)),
]


@pytest.mark.parametrize("case", P_BF16_CASES,
                         ids=[str(i) for i in range(len(P_BF16_CASES))])
def test_plain_p_bf16_matches_reference_kernel(case):
    b, sq, sk, h, kv, hd, seed, kw = case
    kw = dict(kw)
    dtype = kw.pop("dtype", None)
    q, k, v = _qkv(seed, b, sq, sk, h, kv, hd)
    if dtype == "bfloat16":
        want = np.asarray(ref_kernel.flash_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            interpret=True, **kw)).astype(np.float32)
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
        with torch.no_grad():
            got = flash.flash_attention_plain(
                q, k, v, p_dtype=torch.bfloat16, **kw).float().numpy()
        v = v.float().numpy()
    else:
        want = _reference(q, k, v, **kw)
        got = _p_bf16(q, k, v, **kw)
    assert got.shape == want.shape == (b, sq, h, hd)
    rel = _p_bf16_close(got, want, v, f"case {case}")
    print(f"p_dtype=bf16 plain vs the Pallas kernel, case {case[:6]} "
          f"{kw}: max|d| {rel:.3g} of max|v|")


def test_plain_p_bf16_rounds_p_and_keeps_l_from_f32():
    """One tile, one row, by hand: out = sum(bf16(p) v) / sum(p)."""
    rs = np.random.default_rng(4)
    q = rs.standard_normal((1, 1, 1, 16)).astype(np.float32)
    k = rs.standard_normal((1, 100, 1, 16)).astype(np.float32)
    v = rs.standard_normal((1, 100, 1, 16)).astype(np.float32)
    got = _p_bf16(q, k, v, causal=False)[0, 0, 0]
    s = torch.from_numpy(k[0, :, 0] @ q[0, 0, 0]) * (1.0 / 4.0)
    p = torch.exp(s - s.max())
    pb = p.to(torch.bfloat16).float()
    want = (pb @ torch.from_numpy(v[0, :, 0])) / p.sum()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
    f32 = _port(q, k, v, causal=False)[0, 0, 0]
    assert not np.array_equal(got, f32)     # the rounding is visible


def _plain_f32_before_p_dtype(q, k, v, causal=True, window=None,
                              q_block=128, kv_block=128):
    """The plain version as it stood before ``p_dtype`` (a frozen copy)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    sq_p = -(-sq // q_block) * q_block
    sk_p = -(-sk // kv_block) * kv_block
    qf = torch.nn.functional.pad(q.to(torch.float32),
                                 (0, 0, 0, 0, 0, sq_p - sq))
    qf = qf.reshape(b, sq_p, kv, g, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (torch.nn.functional.pad(t.to(torch.float32),
                                      (0, 0, 0, 0, 0, sk_p - sk))
              .permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    q_pos = torch.arange(sq_p)[:, None]
    m = torch.full((b, kv, g, sq_p, 1), flash.NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, g, sq_p, hd), dtype=torch.float32)
    for k0 in range(0, sk_p, kv_block):
        s = torch.matmul(qf, kf[..., k0: k0 + kv_block, :]
                         .transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + kv_block)[None, :]
        mask = k_pos < sk
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, flash.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[..., k0: k0 + kv_block, :])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq_p, h, hd)
    return out[:, :sq].to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [
    dict(), dict(window=50), dict(causal=False, window=30),
    dict(kv_block=64), dict(q_block=64, kv_block=256)])
def test_plain_p_f32_is_the_earlier_plain_bit_for_bit(dtype, kw):
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(12, 2, 300, 150, 4, 2, 64))
    with torch.no_grad():
        got = flash.flash_attention_plain(q, k, v, **kw)
        again = flash.flash_attention_plain(q, k, v, p_dtype=torch.float32,
                                            **kw)
    want = _plain_f32_before_p_dtype(q, k, v, **kw)
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False), dict(window=50), dict(window=50, kv_block=64)])
def test_plain_l_is_the_rows_largest_weight(p_dtype, kw):
    """``return_l``: the output is the one without it, bit for bit, and 1 /
    l is each row's largest attention weight (the softmax of the masked
    scores, taken whole); a row with no live key (with the window, q_pos >=
    Sk + window - 1) has p = 1 on each of the Sk_pad padded positions."""
    b, sq, sk, h, kv, hd = 2, 400, 150, 4, 2, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, b, sq, sk, h, kv, hd))
    with torch.no_grad():
        out, l = flash.flash_attention_plain(q, k, v, p_dtype=p_dtype,
                                             return_l=True, **kw)
        alone = flash.flash_attention_plain(q, k, v, p_dtype=p_dtype, **kw)
    assert torch.equal(out, alone)
    assert l.dtype == torch.float32 and tuple(l.shape) == (b, sq, h)
    kh = k.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kh) / math.sqrt(hd)
    q_pos, k_pos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    live = torch.ones((sq, sk), dtype=torch.bool)
    if kw.get("causal", True):
        live &= k_pos <= q_pos
    if "window" in kw:
        live &= k_pos > q_pos - kw["window"]
    w = torch.softmax(s.masked_fill(~live, -math.inf), dim=-1).amax(dim=-1)
    some = live.any(dim=-1)
    got = (1.0 / l).permute(0, 2, 1)
    torch.testing.assert_close(got[..., some], w[..., some], rtol=1e-5,
                               atol=0)
    sk_pad = -(-sk // kw.get("kv_block", flash.KV_BLOCK)) * kw.get(
        "kv_block", flash.KV_BLOCK)
    assert bool((~some).any()) == ("window" in kw)
    assert bool((l.permute(0, 2, 1)[..., ~some] == sk_pad).all())


def test_kernel_choice_is_by_dtype_and_head_size():
    """Pure Python, on the CPU: bf16 at head size 64, 80, 128 and 256 takes
    the tensor-core kernel (K/V tiles of 128 rows, 64 at 256), everything
    else the CUDA-core one, and the CPU wrapper runs the chosen kernel's
    plain version."""
    for hd in flash.HEAD_DIMS:
        assert flash.kernel_for(torch.float32, hd) == "fma"
        assert flash.kernel_for(torch.bfloat16, hd) == (
            "wgmma" if hd in (64, 80, 128, 256) else "fma")
    assert flash.WGMMA_TILE == {64: 128, 80: 128, 128: 128, 256: 64}
    assert flash.P_DTYPE == {"wgmma": torch.bfloat16, "fma": torch.float32}
    for dtype, hd in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                      (torch.bfloat16, 80), (torch.bfloat16, 256),
                      (torch.bfloat16, 32), (torch.float32, 64),
                      (torch.float32, 256)):
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in _qkv(hd, 1, 150, 150, 4, 2, hd))
        with torch.no_grad():
            got = flash.flash_attention(q, k, v, window=40)
            want = flash.flash_attention_plain(
                q, k, v, window=40,
                p_dtype=flash.P_DTYPE[flash.kernel_for(dtype, hd)])
        assert torch.equal(got, want)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 16, 16, 2, 1, 64))
    with pytest.raises(ValueError, match="wgmma kernel takes bfloat16"):
        flash._launch_kernel(q, k, v, kernel="wgmma")
    with pytest.raises(ValueError, match="kernel must be one of"):
        flash._launch_kernel(q, k, v, kernel="tf32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash._launch_kernel(q, k, v, kernel="fma")
    with pytest.raises(ValueError, match="p_dtype"):
        flash.flash_attention_plain(q, k, v, p_dtype=torch.float16)

