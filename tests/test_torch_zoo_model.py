"""Port parity of the decoder-only model zoo (``repro_torch.models``)
against ``repro.models``: the configs, every leaf at full size (without
allocating it), the RBD plan's dims and seeds, and, for the attention
families (gemma3, granite, llava; qwen2 and tinyllama's forward), the
forward pass and one packed random-bases step at reduced size, in
float32 compute, with the reference's parameters and inputs carried
across through numpy.  The MoE families are in
tests/test_torch_zoo_blocks.py, the recurrent ones in
tests/test_torch_zoo_recurrent.py; both use this file's ``check_*``
helpers (the three files spread over the workers of ``--dist loadfile``).

Tolerances: logits within 1e-5 of their largest magnitude (float32
matmuls, RoPE, norms and the recurrences' sums in another order; measured
at most 2e-6 of it); the MoE aux loss rtol 1e-5.  One packed step
(``fused_packed``: ``project_packed`` and ``reconstruct_apply_packed``,
their plain versions on the backend ``torch``): the loss rtol 1e-5, theta
within 1e-3 * max|theta_1 - theta_0| + 4 ulp of max|theta|
(tests/test_torch_train.py's gate: the coordinates inherit the
gradient's relative error), the aux rtol 1e-5.  Where a MoE layer
routes, every token's gap between its k-th and (k+1)-th router
probability is asserted above 1e-4, far above the float32 rounding of the
routing (~1e-7), so a routing difference between the packages fails the
test instead of passing as noise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import INPUT_SHAPES as REF_INPUT_SHAPES
from repro.configs import get_config as ref_config
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import compartments as ref_comp
from repro.data import synthetic as ref_data
from repro.models import frontends as ref_frontends
from repro.models import get_model as ref_model
from repro.models import transformer as ref_transformer
from repro.train import step as ref_step
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import compartments
from repro_torch.models import layers as L
from repro_torch.models import moe, transformer
from repro_torch.models.registry import get_model, params_from_reference
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

LOGITS_RTOL = 1e-5     # of the largest |logit|
AUX_RTOL = 1e-5
LOSS_RTOL = 1e-5
THETA_OF_UPDATE = 1e-3   # of max|theta_1 - theta_0|, plus 4 ulp of theta
EPS32 = 2.0 ** -23
ROUTE_MARGIN = 1e-4    # least top-k / top-(k+1) router probability gap

# the decoder-only IDs (whisper-tiny is tests/test_torch_encdec.py's)
DECODERS = sorted(a for a in ARCH_IDS
                  if not get_config(a).is_encoder_decoder)
# (arch, overrides of reduced(), sequence length): the nine reduced
# configs, gemma3 with one global layer in six and the window of 64
# biting, zamba2 with two hybrid groups
FORWARD_CASES = [(a, {}, 48) for a in DECODERS] + [
    ("gemma3-4b", {"n_layers": 6}, 96),
    ("zamba2-2.7b", {"n_layers": 4}, 24),
]


def named_leaves(params) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {ref_comp._leaf_name(p): x for p, x in flat}


@functools.lru_cache(maxsize=None)
def _reference_setup(arch, overrides):
    cfg = ref_config(arch).reduced(compute_dtype="float32",
                                   **dict(overrides))
    model = ref_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in named_leaves(params).items()}
    return cfg, model, params, named


def reference_setup(arch, overrides=None):
    """(reference cfg, model, params, the params as numpy by leaf name)
    at the reduced size, float32 compute; made once per process."""
    return _reference_setup(arch, tuple(sorted((overrides or {}).items())))


def port_model(arch, overrides=None):
    return get_model(get_config(arch).reduced(compute_dtype="float32",
                                              **(overrides or {})))


def inputs(cfg, b, s, seed=0):
    """A token batch (numpy) and, for the VLM, the reference's patches."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    patches = (np.array(ref_frontends.vision_patches(cfg, b))
               if cfg.n_patches else None)
    return toks, patches


def routing_margin(p, x, *, top_k, prefix="moe/"):
    """Each token's gap between its k-th and (k+1)-th router probability
    ((B, S)): a routing that two packages compute to rounding can differ
    only where this gap is within the rounding."""
    router = p[prefix + "router"].float()
    probs = torch.softmax(x.float() @ router, dim=-1)
    top = torch.topk(probs, top_k + 1, dim=-1).values
    return top[..., top_k - 1] - top[..., top_k]


def assert_routing_margins(port, params, batch):
    """Every MoE layer's routing margin in the port's forward is above
    ROUTE_MARGIN (read at each layer's normed input)."""
    margins = []
    real = moe.moe_ffn

    def spy(p, x, **kw):
        margins.append(float(routing_margin(p, x, top_k=kw["top_k"])
                             .min()))
        return real(p, x, **kw)

    moe.moe_ffn = spy
    try:
        with torch.no_grad():
            port.forward(params, batch)
    finally:
        moe.moe_ffn = real
    assert len(margins) == port.cfg.n_layers
    assert min(margins) > ROUTE_MARGIN, margins


def test_configs_match_reference():
    assert set(ARCH_IDS) == set(REF_ARCH_IDS)
    assert sorted(set(ARCH_IDS) - set(DECODERS)) == ["whisper-tiny"]
    for arch in ARCH_IDS:
        ours, ref = get_config(arch), ref_config(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), arch
        assert ours.supports_long_context == ref.supports_long_context
        assert (dataclasses.asdict(ours.reduced())
                == dataclasses.asdict(ref.reduced()))
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_INPUT_SHAPES.items()}
    whisper = get_config("whisper-tiny")
    assert whisper.is_encoder_decoder and whisper.enc_seq == 1500
    assert get_model(whisper).family.__name__ == "repro_torch.models.encdec"
    with pytest.raises(ValueError, match="models.encdec"):
        transformer.param_shapes(whisper)


@pytest.mark.parametrize("arch", DECODERS)
def test_full_size_leaves_and_plan_match_reference(arch):
    """At full width and depth: the leaves' names, order and shapes
    (``jax.eval_shape``, nothing allocated), and the plan's dims, sizes
    and seed tags at rbd-dim 1024."""
    rcfg = ref_config(arch)
    shapes = jax.eval_shape(
        lambda: ref_transformer.init_params(rcfg, jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in named_leaves(shapes).items()}
    model = get_model(get_config(arch))
    got = model.param_shapes()
    assert list(got) == list(want) and got == want
    rplan = ref_comp.make_plan(shapes, 1024,
                               is_stacked=ref_model(rcfg).is_stacked)
    plan = compartments.make_plan(got, 1024, is_stacked=model.is_stacked)
    assert plan.total_dim == rplan.total_dim
    assert plan.total_params == rplan.total_params
    for a, b in zip(plan.leaves, rplan.leaves, strict=True):
        assert (a.name, a.shape, a.n_stack, a.size, a.dim, a.seed_tag) == (
            b.name, tuple(b.shape), b.n_stack, b.size, b.dim, b.seed_tag)


def check_forward(arch, overrides, s):
    """The port's logits and aux against the reference's, reduced config
    (``overrides`` of ``reduced()``), batch 2 x ``s`` (+ the VLM's
    patches); the MoE families' routing margins."""
    cfg, model, params, named = reference_setup(arch, overrides)
    toks, patches = inputs(cfg, 2, s)
    batch = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)
        tb["patches"] = torch.from_numpy(patches)
    logits_ref, aux_ref = model.forward(params, batch)
    port = port_model(arch, overrides)
    tp = params_from_reference(named, device="cpu")
    assert list(tp) == list(port.param_shapes())
    with torch.no_grad():
        logits, aux = port.forward(tp, tb)
    want = np.asarray(logits_ref)
    assert logits.shape == want.shape == (2, s + cfg.n_patches, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=LOGITS_RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=AUX_RTOL)
    if cfg.is_moe:
        assert float(aux) > 0
        assert_routing_margins(port, tp, tb)


def check_packed_step(arch):
    """One ``fused_packed`` step of the port (backend ``torch``, packed
    on) against the reference's ``make_train_step`` (jnp backend, packed
    on), from the reference's parameters and batch: the loss, theta, the
    aux."""
    rcfg, rmodel, params, named = reference_setup(arch)
    rtcfg = RefTrainConfig(model=rcfg, rbd=RefRBDConfig(
        total_dim=128, backend="jnp", packed="on"), learning_rate=0.5)
    r_init, r_step, r_opt = ref_step.make_train_step(
        rmodel, rtcfg, return_optimizer=True)
    assert r_opt.plan_execution().strategy == "fused_packed"
    rstate = r_init(jax.random.PRNGKey(0))
    batch = next(ref_data.lm_batches(0, 2, 16, rcfg.vocab))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    if rcfg.n_patches:
        _, batch["patches"] = inputs(rcfg, 2, 16)
        batch["labels"] = np.random.default_rng(5).integers(
            0, rcfg.vocab, (2, rcfg.n_patches + 16)).astype(np.int32)
    rstate, rmetrics = jax.jit(r_step)(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})

    port = port_model(arch)
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                              else v) for k, v in batch.items()}
    tparams = params_from_reference(named, device="cpu")
    if rcfg.is_moe:
        assert_routing_margins(port, tparams, tb)
    tcfg = TrainConfig(model=port.cfg, rbd=RBDConfig(
        total_dim=128, backend="torch", packed="on"), learning_rate=0.5)
    init_state, train_step, sub_opt = steplib.make_train_step(
        port, tcfg, device="cpu", return_optimizer=True)
    assert sub_opt.plan_execution().strategy == "fused_packed"
    state = init_state(params=tparams)
    theta0 = state.params.numpy().copy()
    state, metrics = train_step(state, tb)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=LOSS_RTOL)
    want = np.asarray(rstate.params)
    moved = np.abs(want - theta0).max()
    assert moved > 0
    tol = THETA_OF_UPDATE * moved + 4 * EPS32 * np.abs(want).max()
    np.testing.assert_allclose(state.params.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(float(metrics["aux"]), float(rmetrics["aux"]),
                               rtol=AUX_RTOL)


ATTN_FORWARD = [c for c in FORWARD_CASES
                if c[0] in ("gemma3-4b", "granite-34b",
                            "llava-next-mistral-7b", "qwen2-0.5b",
                            "tinyllama-1.1b")]


@pytest.mark.parametrize("arch,overrides,s", ATTN_FORWARD,
                         ids=[f"{a}-{o.get('n_layers', 'r')}"
                              for a, o, _ in ATTN_FORWARD])
def test_forward_logits_and_aux_match_reference(arch, overrides, s):
    check_forward(arch, overrides, s)


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-34b",
                                  "llava-next-mistral-7b"])
def test_one_packed_step_matches_reference(arch):
    check_packed_step(arch)


def test_gemma3_windows_and_global_layers():
    """Layer i is global when (i + 1) % 6 == 0; the window changes a
    local layer's output once the sequence outgrows it."""
    cfg = get_config("gemma3-4b")
    wins = transformer.layer_windows(cfg)
    assert [i for i, w in enumerate(wins) if w is None] == [5, 11, 17, 23,
                                                            29]
    assert set(wins) == {None, 1024}
    assert transformer.layer_windows(get_config("mixtral-8x7b")) == [
        4096] * 32
    assert transformer.n_groups(get_config("zamba2-2.7b")) == 9


def test_batch_specs_match_reference():
    for arch in ("qwen2-0.5b", "llava-next-mistral-7b"):
        cfg = get_config(arch).reduced(compute_dtype="float32")
        rmodel = ref_model(ref_config(arch).reduced(compute_dtype="float32"))
        port = get_model(cfg)
        for shape in INPUT_SHAPES.values():
            small = dataclasses.replace(shape, seq_len=32, global_batch=2)
            got = port.batch_specs(small)
            want = rmodel.batch_specs(REF_INPUT_SHAPES[shape.name].__class__(
                **dataclasses.asdict(small)))
            assert list(got) == list(want)
            for name, (dims, dtype) in got.items():
                assert dims == tuple(want[name].shape), (arch, name)
                assert dtype.is_floating_point == jnp.issubdtype(
                    want[name].dtype, jnp.floating)
            batch = port.make_batch(small, device="cpu")
            assert {k: tuple(v.shape) for k, v in batch.items()} == {
                k: d for k, (d, _) in got.items()}
            if "tokens" in batch:
                assert int(batch["tokens"].max()) < cfg.vocab


def check_init_scales(arch):
    """The port's init against the reference's, leaf by leaf, at the
    reduced size: constants by leaf name (not by a name prefix), the
    random leaves' spread within 0.8-1.25x (dense matrices at
    1/sqrt(fan-in), bonus_u at 0.1, embed at 0.02)."""
    cfg = get_config(arch).reduced(compute_dtype="float32")
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    named = reference_setup(arch)[3]
    assert list(p) == list(named)
    for name, x in p.items():
        want = named[name]
        assert x.dtype == L.dtype_of(cfg.param_dtype)
        if np.all(want == want.flat[0]):       # a constant leaf
            assert bool((x == float(want.flat[0])).all()), name
        else:
            ratio = float(x.std()) / float(want.std())
            assert 0.8 < ratio < 1.25, (name, ratio)


@pytest.mark.parametrize("arch", ["gemma3-4b", "llava-next-mistral-7b"])
def test_init_follows_the_reference_scales_by_leaf(arch):
    check_init_scales(arch)
