"""Port parity of ``train.loop.train`` with ``grad_accum_steps`` 2 against
the reference's ``repro.train.loop.train`` on the reduced qwen2-0.5b
(the packed step on one global compartment of rbd-dim 16, momentum),
from the reference's initial parameters: 2 steps in each package on the
same 4 batches, stacked 2 a step by each loop's ``fetch``.  The losses
within 1e-5 (relative) and theta within 1e-4, the tolerances of
tests/test_torch_loop.py (whose fixture is not shared: this file runs
beside it under ``--dist loadfile``)."""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.core import compartments as ref_comp
from repro.data import synthetic as ref_data
from repro.models import get_model as ref_model
from repro.train import loop as ref_loop
from repro_torch.configs import get_config
from repro_torch.models.registry import get_model, params_from_reference
from repro_torch.train import loop
from test_torch_loop import (LOSS_RTOL, PARAM_ATOL, _ref_tcfg,
                             _starting_from, _tcfg, _torch_batches)

torch.set_num_threads(1)

STEPS, N_ACCUM = 2, 2


def test_grad_accum_matches_reference():
    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    rmodel = ref_model(rcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        rmodel.init(jax.random.PRNGKey(0)))
    named = {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}
    stream = ref_data.lm_batches(0, 2, 16, rcfg.vocab)
    batches = [jax.device_get(next(stream)) for _ in range(STEPS * N_ACCUM)]

    r_state, r_hist = ref_loop.train(
        rmodel, dataclasses.replace(_ref_tcfg(rcfg), steps=STEPS,
                                    grad_accum_steps=N_ACCUM),
        iter(batches), log_every=1)

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = _starting_from(get_model(cfg),
                           params_from_reference(named, device="cpu"))
    data = _torch_batches(batches)
    state, hist = loop.train(
        model, _tcfg(cfg, grad_accum_steps=N_ACCUM, steps=STEPS), data,
        log_every=1, device="cpu")
    assert next(data, None) is None
    assert [h["step"] for h in hist] == [h["step"] for h in r_hist] \
        == list(range(STEPS))
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in r_hist], rtol=LOSS_RTOL)
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(r_state.params), rtol=0,
                               atol=PARAM_ATOL)
