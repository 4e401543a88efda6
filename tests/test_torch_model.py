"""Port parity: the dense decoder (``repro_torch.models``) against
``repro.models`` on the reduced qwen2-0.5b and tinyllama configs, in
float32 compute, with the reference's parameters carried across
(``registry.params_from_reference``) and the reference's batches.

Tolerances: logits and loss rtol 1e-5 (float32 matmuls, RoPE cos/sin and
softmax accumulate in another order); the packed gradient within
2e-5 * max|g| (the backward pass adds one more layer of reordered sums).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.data import synthetic as ref_data
from repro.models import get_model as ref_model
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.core import compartments, projector
from repro_torch.models.registry import (
    get_model, pack_reference, params_from_reference)
from repro_torch.train import step as steplib

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

ARCHS = ["qwen2-0.5b", "tinyllama-1.1b"]


def _reference(arch):
    cfg = ref_config(arch).reduced(compute_dtype="float32")
    model = ref_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = next(ref_data.lm_batches(0, 2, 16, cfg.vocab))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    named = {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}
    return cfg, model, params, batch, named


def _port(arch):
    return get_model(get_config(arch).reduced(compute_dtype="float32"))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long()
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match(arch):
    cfg, model, params, batch, named = _reference(arch)
    logits_ref, _ = model.forward(params, batch)
    loss_ref = ref_step.softmax_cross_entropy(logits_ref, batch["labels"])
    port = _port(arch)
    tp = params_from_reference(named, device="cpu")
    assert list(tp) == compartments.leaf_order(named)
    assert {k: tuple(v.shape) for k, v in tp.items()} == port.param_shapes()
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits, aux = port.forward(tp, tb)
        loss = steplib.softmax_cross_entropy(logits, tb["labels"])
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_gradient_matches(arch):
    cfg, model, params, batch, named = _reference(arch)
    port = _port(arch)
    rplan = ref_comp.make_plan(jax.eval_shape(lambda: params), 128,
                               is_stacked=model.is_stacked)
    rlayout = rplan.packed()

    def ref_loss(packed):
        p = ref_proj.unpack_tree(packed, rplan, rlayout, params)
        logits, _ = model.forward(p, batch)
        return ref_step.softmax_cross_entropy(logits, batch["labels"])

    g_ref = np.asarray(jax.grad(ref_loss)(
        ref_proj.pack_tree(params, rplan, rlayout)))

    plan = compartments.make_plan(port.param_shapes(), 128,
                                  is_stacked=port.is_stacked)
    packed = pack_reference(named, plan, device="cpu").requires_grad_(True)
    p = projector.unpack_tree(packed, plan, plan.packed(),
                              port.param_template())
    logits, _ = port.forward(p, _torch_batch(batch))
    loss = steplib.softmax_cross_entropy(
        logits, _torch_batch(batch)["labels"])
    (g,) = torch.autograd.grad(loss, packed)
    g = g.numpy()
    valid = rlayout.param_valid == 1
    assert (g[~valid] == 0).all()          # zero on the padding
    np.testing.assert_allclose(g, g_ref, rtol=0,
                               atol=2e-5 * np.abs(g_ref).max())


def test_bf16_compute_casts_like_reference():
    """bf16 compute: parameters cast at forward entry, logits float32."""
    cfg, model, params, batch, named = _reference("qwen2-0.5b")
    bcfg = cfg.__class__(**{**cfg.__dict__, "compute_dtype": "bfloat16"})
    logits_ref, _ = ref_model(bcfg).forward(params, batch)
    port = get_model(get_config("qwen2-0.5b").reduced(
        compute_dtype="bfloat16"))

    with torch.no_grad():
        logits, _ = port.forward(params_from_reference(named, device="cpu"),
                                 _torch_batch(batch))
    assert logits.dtype == torch.float32
    ref = np.asarray(logits_ref)
    # bf16 keeps 8 bits of mantissa: compare at bf16 resolution
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0,
                               atol=0.05 * np.abs(ref).max())
