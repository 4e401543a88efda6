"""Port parity of the encoder-decoder (``repro_torch.models.encdec``,
whisper-tiny) against ``repro.models.encdec``: the config, every leaf at
full size (without allocating it) and the RBD plan's dims and seeds, the
layers it adds (``sinusoidal_positions``, ``layer_norm``), and at the
reduced size, in float32 and bfloat16 compute, ``encode``, ``forward``,
the cross cache of ``prefill_cross_cache`` and four ``decode_step``s
from the reference's parameters and frames carried across through numpy;
decode against the teacher-forced forward; one packed random-bases step;
the flash wrapper's plain version non-causal on a ragged K/V length
against the reference's Pallas kernel in interpret mode.

Tolerances: sinusoidal positions bit for bit.  float32 compute: encoder
outputs, cross K/V and logits within 1e-5 of their largest magnitude
(float32 matmuls and norms summed in another order; measured below 1e-6
of it); ``layer_norm`` within 1e-6 of max|out|.  bfloat16 compute: within
0.05 of the largest magnitude, the port's bf16 gate
(tests/test_torch_model.py): both sides round every layer's activations
to bf16 (8 bits), in another order (measured at most 0.011).  Decode against forward in the port
itself: 1e-5 of max|logits| in float32; in bfloat16 0.05, since the
prefill's cross K/V are the float32 product rounded once while forward's
are a bf16 product (ROADMAP.md Queue C 19).  One packed step: the loss
rtol 1e-5, theta within 1e-3 * max|theta_1 - theta_0| + 4 ulp of
max|theta| (tests/test_torch_zoo_model.py's gate).  The flash plain
version against the Pallas kernel: float32 within 1e-6 of the largest
magnitude, bfloat16 within one bf16 ulp of the larger value with P in
float32, and within 2**-8 max|v| + 1e-5 max|v| + one ulp with P rounded
to bf16 (tests/test_torch_flash.py's gates).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import InputShape as RefInputShape
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import compartments as ref_comp
from repro.kernels import flash_attention as ref_kernel
from repro.models import encdec as ref_encdec
from repro.models import frontends as ref_frontends
from repro.models import get_model as ref_model
from repro.models import layers as ref_layers
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, RBDConfig, TrainConfig
from repro_torch.core import compartments
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import rbd_step
from repro_torch.launch import train as launcher
from repro_torch.models import encdec, frontends, transformer
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model, params_from_reference
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ARCH = "whisper-tiny"
F32_RTOL = 1e-5          # of the largest magnitude
BF16_RTOL = 0.05         # of the largest magnitude
LOSS_RTOL = 1e-5
THETA_OF_UPDATE = 1e-3   # of max|theta_1 - theta_0|, plus 4 ulp of theta
EPS32 = 2.0 ** -23
DTYPES = ["float32", "bfloat16"]
B, S, N_DECODE = 2, 8, 4
RBD_DIM = 8


def _named(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_comp._leaf_name(p): x for p, x in flat}


@functools.lru_cache(maxsize=None)
def _reference():
    """(reference cfg at float32 compute, params, params as numpy by leaf
    name, frames (B, 16, 128), tokens (B, S)) at the reduced size."""
    cfg = ref_config(ARCH).reduced(compute_dtype="float32")
    params = ref_encdec.init_params(cfg, jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in _named(params).items()}
    frames = np.asarray(ref_frontends.audio_frames(cfg, B))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    return cfg, params, named, frames, tokens


def _port(dtype):
    """(port cfg, its params carried from the reference, frames, tokens)."""
    _, _, named, frames, tokens = _reference()
    cfg = get_config(ARCH).reduced(compute_dtype=dtype)
    return (cfg, params_from_reference(named, device="cpu"),
            torch.from_numpy(np.array(frames)),
            torch.from_numpy(np.array(tokens)))


def _close(got, want, rtol, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), for normal values."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _rtol(dtype):
    return F32_RTOL if dtype == "float32" else BF16_RTOL


def test_config_and_batch_specs_match_reference():
    ours, ref = get_config(ARCH), ref_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(ours.reduced())
            == dataclasses.asdict(ref.reduced()))
    assert ours.reduced().enc_seq == 16 and ours.reduced().n_enc_layers == 2
    cfg = ours.reduced(compute_dtype="float32")
    port, rmodel = get_model(cfg), ref_model(ref.reduced(
        compute_dtype="float32"))
    assert port.family is encdec
    assert port.stacked_prefixes == ("enc_layers", "dec_layers")
    for kind in ("train", "prefill", "decode"):
        shape = InputShape("s", 24, 2, kind)
        got = port.batch_specs(shape)
        want = rmodel.batch_specs(RefInputShape("s", 24, 2, kind))
        assert list(got) == list(want)
        for name, (dims, dtype) in got.items():
            assert dims == tuple(want[name].shape), name
            assert dtype.is_floating_point == jnp.issubdtype(
                want[name].dtype, jnp.floating)
        batch = port.make_batch(shape, device="cpu")
        assert {k: tuple(v.shape) for k, v in batch.items()} == {
            k: d for k, (d, _) in got.items()}
    frames = frontends.audio_frames(cfg, 3, device="cpu")
    assert tuple(frames.shape) == (3, 16, 128)
    assert frames.dtype == torch.float32
    assert 0.015 < float(frames.std()) < 0.025
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            frontends.audio_frames(cfg, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            frontends.vision_patches(cfg, 1)


def test_refusals_name_the_right_module():
    enc = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="models.encdec"):
        transformer.param_shapes(enc)
    with pytest.raises(ValueError, match="models.transformer"):
        encdec.param_shapes(get_config("qwen2-0.5b"))
    # the launcher feeds token batches only: refused before anything is
    # built (the reference's launcher fails on the missing frames key)
    with pytest.raises(ValueError, match="Queue C 18"):
        launcher.run_training(enc, steps=1, batch=2, seq=8, device="cpu")


def test_full_size_leaves_and_plan_match_reference():
    """Full width and depth: leaf names, order and shapes (``jax.eval_shape``,
    nothing allocated), and the plan's dims, sizes and seed tags at rbd-dim
    1024 (total_dim 1,058; 52,168,320 parameters)."""
    rcfg = ref_config(ARCH)
    shapes = jax.eval_shape(
        lambda: ref_encdec.init_params(rcfg, jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in _named(shapes).items()}
    model = get_model(get_config(ARCH))
    got = model.param_shapes()
    assert list(got) == list(want) and got == want
    assert {str(v.dtype) for v in _named(shapes).values()} == {"float32"}
    assert {v.dtype for v in model.param_template().values()} == {
        torch.float32}
    rplan = ref_comp.make_plan(shapes, 1024,
                               is_stacked=ref_model(rcfg).is_stacked)
    plan = compartments.make_plan(got, 1024, is_stacked=model.is_stacked)
    assert plan.total_dim == rplan.total_dim == 1058
    assert plan.total_params == rplan.total_params == 52_168_320
    for a, b in zip(plan.leaves, rplan.leaves, strict=True):
        assert (a.name, a.shape, a.n_stack, a.size, a.dim, a.seed_tag) == (
            b.name, tuple(b.shape), b.n_stack, b.size, b.dim, b.seed_tag)


def test_init_follows_the_reference_scales():
    cfg = get_config(ARCH).reduced(compute_dtype="float32")
    p = encdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    named = _reference()[2]
    assert list(p) == list(named)
    for name, x in p.items():
        want = named[name]
        assert x.dtype == torch.float32 and tuple(x.shape) == want.shape
        if np.all(want == 0):
            assert bool((x == 0).all()), name
        else:
            ratio = float(x.std()) / float(want.std())
            assert 0.8 < ratio < 1.25, (name, ratio)


@pytest.mark.parametrize("seq,d", [(1500, 384), (16, 128), (448, 64)])
def test_sinusoidal_positions_bit_for_bit(seq, d):
    for dt, rdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = L.sinusoidal_positions(seq, d, dt)
        want = np.asarray(ref_layers.sinusoidal_positions(seq, d, rdt))
        assert got.dtype == dt and tuple(got.shape) == want.shape
        bits = got.view(torch.int32 if dt == torch.float32 else torch.int16)
        wbits = want.view(np.int32 if dt == torch.float32 else np.int16)
        assert np.array_equal(bits.numpy(), wbits), (seq, d, dt)


def test_float64_cast_rounds_like_the_reference():
    """Values where rounding float64 to bf16 directly differs from going
    through float32 (a tie in float32): the port takes the reference's
    bits."""
    x = np.array([1 + 2.0 ** -8 + 2.0 ** -40, -(3 + 2.0 ** -7 + 2.0 ** -39),
                  0.1, 12345.678])
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    got = L.from_float64(x, torch.bfloat16).view(torch.int16).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_reference(dtype):
    rs = np.random.default_rng(4)
    x = rs.standard_normal((3, 5, 96)).astype(np.float32) * 3 + 1
    w = rs.standard_normal(96).astype(np.float32)
    b = rs.standard_normal(96).astype(np.float32)
    tdt = L.dtype_of(dtype)
    want = np.asarray(ref_layers.layer_norm(
        jnp.asarray(x, ref_layers._dtype(dtype)), jnp.asarray(w),
        jnp.asarray(b)).astype(jnp.float32))
    got = L.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                       torch.from_numpy(b))
    assert got.dtype == tdt
    _close(got, want, 1e-6 if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_forward_match_reference(dtype):
    rcfg, params, _, frames, tokens = _reference()
    rcfg = dataclasses.replace(rcfg, compute_dtype=dtype)
    want_enc = ref_encdec.encode(rcfg, params, jnp.asarray(frames))
    want, _ = ref_encdec.forward(rcfg, params, jnp.asarray(tokens),
                                 jnp.asarray(frames))
    cfg, tp, tframes, ttokens = _port(dtype)
    model = get_model(cfg)
    with torch.no_grad():
        enc = encdec.encode(cfg, tp, tframes)
        logits, aux = model.forward(tp, {"tokens": ttokens,
                                         "frames": tframes})
    assert enc.dtype == L.dtype_of(dtype)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(enc, want_enc.astype(jnp.float32), _rtol(dtype), "encode")
    _close(logits, want, _rtol(dtype), "logits")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_cache_and_decode_match_reference(dtype):
    """``prefill_cross_cache`` (the encoder through the flash wrapper,
    once per encoder layer) and N_DECODE ``decode_step``s: the cross K/V,
    the self-attention cache and the logits of each step."""
    rcfg, params, _, frames, tokens = _reference()
    rcfg = dataclasses.replace(rcfg, compute_dtype=dtype)
    rcache = ref_encdec.prefill_cross_cache(
        rcfg, params, ref_encdec.init_cache(rcfg, B, S), jnp.asarray(frames))
    cfg, tp, tframes, ttokens = _port(dtype)
    model = get_model(cfg)
    rbd_step.reset_counts()
    cache = encdec.prefill_cross_cache(
        cfg, tp, model.init_cache(B, S, device="cpu"), tframes)
    assert rbd_step.CALLS["flash_attention"] == cfg.n_enc_layers
    for key in ("xk", "xv"):
        assert cache[key].dtype == L.dtype_of(dtype)
        _close(cache[key], rcache[key].astype(jnp.float32), _rtol(dtype),
               key)
    step = jax.jit(functools.partial(ref_encdec.decode_step, rcfg))
    with torch.no_grad():
        for i in range(N_DECODE):
            want, rcache = step(params, rcache, jnp.asarray(tokens[:, i:i + 1]))
            got, cache = model.decode_step(tp, cache, ttokens[:, i:i + 1])
            _close(got, want, _rtol(dtype), f"decode step {i}")
    assert int(cache["len"]) == N_DECODE == int(rcache["len"])
    assert rbd_step.CALLS["flash_attention"] == cfg.n_enc_layers
    for key in ("k", "v"):
        _close(cache[key][:, :, :N_DECODE],
               rcache[key][:, :, :N_DECODE].astype(jnp.float32),
               _rtol(dtype), key)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_teacher_forced_forward(dtype):
    """The port's own decode against its forward on the same tokens (the
    reference skips this case for the encoder-decoder): every position's
    logits; forward never launches the flash kernel."""
    cfg = get_config(ARCH).reduced(compute_dtype=dtype)
    model = get_model(cfg)
    params = model.init(3, device="cpu")
    frames = frontends.audio_frames(cfg, B, seed=5, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, S)))
    with torch.no_grad():
        rbd_step.reset_counts()
        full, _ = model.forward(params, {"tokens": toks, "frames": frames})
        assert rbd_step.CALLS["flash_attention"] == 0
        cache = encdec.prefill_cross_cache(
            cfg, params, model.init_cache(B, S, device="cpu"), frames)
        outs = []
        for i in range(S):
            logits, cache = model.decode_step(params, cache, toks[:, i:i + 1])
            outs.append(logits[:, 0])
    assert rbd_step.CALLS["flash_attention"] == cfg.n_enc_layers
    assert int(cache["len"]) == S
    _close(torch.stack(outs, 1), full.numpy(), _rtol(dtype))


def test_one_packed_step_matches_reference():
    """One ``fused_packed`` step of the port (backend ``torch``, packed
    on) against the reference's ``make_train_step`` (jnp backend, packed
    on), from the reference's parameters and batch (tokens, frames,
    labels).  RBD_DIM 8 plans one direction per compartment (total_dim
    52): the 40,960 learned decoder positions make every direction of
    that leaf 5.2 M basis values, which the plain versions generate on
    the host."""
    rcfg, params, named, _, _ = _reference()
    rmodel = ref_model(rcfg)
    rtcfg = RefTrainConfig(model=rcfg, rbd=RefRBDConfig(
        total_dim=RBD_DIM, backend="jnp", packed="on"), learning_rate=0.5)
    r_init, r_step, r_opt = ref_step.make_train_step(
        rmodel, rtcfg, return_optimizer=True)
    assert r_opt.plan_execution().strategy == "fused_packed"
    rstate = r_init(jax.random.PRNGKey(0))
    batch = rmodel.make_batch(RefInputShape("s", 12, 2, "train"))
    rstate, rmetrics = jax.jit(r_step)(rstate, batch)

    port = get_model(get_config(ARCH).reduced(compute_dtype="float32"))
    tb = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k != "frames" else np.float32)) for k, v in batch.items()}
    tcfg = TrainConfig(model=port.cfg, rbd=RBDConfig(
        total_dim=RBD_DIM, backend="torch", packed="on"), learning_rate=0.5)
    init_state, train_step, sub_opt = steplib.make_train_step(
        port, tcfg, device="cpu", return_optimizer=True)
    assert sub_opt.plan_execution().strategy == "fused_packed"
    state = init_state(params=params_from_reference(named, device="cpu"))
    theta0 = state.params.numpy().copy()
    state, metrics = train_step(state, tb)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=LOSS_RTOL)
    want = np.asarray(rstate.params)
    moved = np.abs(want - theta0).max()
    assert moved > 0
    tol = THETA_OF_UPDATE * moved + 4 * EPS32 * np.abs(want).max()
    np.testing.assert_allclose(state.params.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_noncausal_ragged_matches_pallas(dtype):
    """The wrapper (its plain version here) at the encoder's head size 64,
    non-causal, Sq = Sk = 200 (a ragged last 128-row tile, as 1,500 is on
    the card), and Sq 24 against Sk 200 (the cross shape), against the
    reference's Pallas kernel in interpret mode; bf16 also through the
    tensor-core kernel's function (P rounded to bf16)."""
    rs = np.random.default_rng(8)
    tdt = L.dtype_of(dtype)
    for sq in (200, 24):
        q = rs.standard_normal((1, sq, 2, 64)).astype(np.float32)
        k, v = (rs.standard_normal((1, 200, 2, 64)).astype(np.float32)
                for _ in range(2))
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        want = np.asarray(ref_kernel.flash_attention(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=False,
            q_block=128, kv_block=128, interpret=True).astype(jnp.float32))
        tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
        with torch.no_grad():
            got = flash.flash_attention(tq, tk, tv, causal=False)
        if dtype == "float32":
            _close(got, want, 1e-6, f"sq {sq}")
            continue
        # bf16 at head size 64 is the tensor-core kernel's: P rounded to
        # bf16; the CUDA-core kernel's function keeps P in f32
        assert flash.kernel_for(tdt, 64) == "wgmma"
        p_f32 = flash.flash_attention_plain(tq, tk, tv, causal=False)
        p_f32 = p_f32.float().numpy()
        ulp = _bf16_ulp(np.maximum(np.abs(p_f32), np.abs(want)))
        assert (np.abs(p_f32 - want) <= ulp).all(), sq
        got = got.float().numpy()
        tol = ((2.0 ** -8 + 1e-5) * float(np.abs(v).max())
               + _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))
        assert (np.abs(got - want) <= tol).all(), sq
