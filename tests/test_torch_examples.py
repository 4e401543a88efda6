"""Port parity of the examples ``repro_torch.examples.quickstart`` and
``repro_torch.examples.train_lm`` against the reference's.

* the quickstart's first 3 steps (``main(["--steps", "3", ...])`` from the
  reference's FC parameters, on the ``fused_per_leaf`` route the card
  plans, here through the kernels' plain versions) against the
  reference's quickstart loop, rebuilt from its pieces (``make_plan`` of
  a global 'exact' d = 250 plan, ``SubspaceOptimizer`` over
  ``RandomBasesTransform(plan, 0, redraw=True)``, lr 2.0, the jitted
  value-and-grad step) on the same parameters and the port's batches:
  losses within 1e-5 relative, the parameters within 1e-5 of their
  largest magnitude (float32 sums of 101,770 products in another order,
  three steps); the reference's ``main`` has no step argument and is
  not run;
* ``train_lm``'s preamble (D, d, the reduction factor, the three modes'
  traffic) against the reference's ``make_plan`` and ``grad_comm_bytes``
  on ``jax.eval_shape`` of its qwen2-100m config, the printed lines
  character for character;
* both entry points refuse the card when there is none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.core import make_plan as ref_make_plan
from repro.core.distributed import grad_comm_bytes as ref_comm
from repro.core.rbd import RandomBasesTransform as RefTransform
from repro.models import get_model as ref_model
from repro.models import vision as ref_vision
from repro.optim.subspace import SubspaceOptimizer as RefSubspace
from repro.train.step import make_plan as ref_step_plan
from repro_torch.data import synthetic
from repro_torch.examples import quickstart, train_lm
from repro_torch.models.registry import params_from_reference

torch.set_num_threads(1)

QUICK_STEPS = 3
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _reference_quickstart(params, batches):
    """The reference's quickstart loop (examples/quickstart.py:41-72) on
    the given parameters and batches."""
    _, apply = ref_vision.get_vision_model("fc")
    plan = ref_make_plan(params, quickstart.D_TOTAL, granularity="global",
                         normalization="exact")
    sub = RefSubspace(transform=RefTransform(plan, base_seed=0, redraw=True),
                      learning_rate=quickstart.LR)

    def loss_fn(p, x, y):
        logp = jax.nn.log_softmax(apply(p, x))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    @jax.jit
    def train_step(p, rbd_state, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        p, rbd_state, opt_state, _ = sub.step(p, grads, rbd_state, opt_state)
        return p, rbd_state, opt_state, loss

    rbd_state = sub.init_rbd_state(params)
    opt_state = sub.init_opt_state(params)
    losses = []
    for x, y in batches:
        params, rbd_state, opt_state, loss = train_step(
            params, rbd_state, opt_state, x, y)
        losses.append(float(loss))
    return params, losses


def test_quickstart_first_steps_match_reference(capsys):
    init, _ = ref_vision.get_vision_model("fc")
    rparams = init(jax.random.PRNGKey(0), quickstart.SHAPE)
    out = quickstart.main(
        ["--device", "cpu", "--steps", str(QUICK_STEPS)], backend="cuda",
        params=params_from_reference(_named(rparams), device="cpu"))
    text = capsys.readouterr().out
    assert "FC model: D=101,770 parameters, training in d=250 random " \
        "dimensions (407x reduction)" in text
    assert out["eplan"].strategy == "fused_per_leaf"
    assert out["plan"].total_dim == 250 and out["plan"].flatten
    assert sorted(out["accuracy"]) == [0, QUICK_STEPS - 1]
    assert all(0.0 <= a <= 1.0 for a in out["accuracy"].values())

    # the port's batches, fed to the reference
    data = synthetic.mixture_dataset(0, quickstart.BATCH,
                                     shape=quickstart.SHAPE,
                                     noise=quickstart.NOISE, device="cpu")
    batches = [tuple(jnp.asarray(t.numpy()) for t in next(data))
               for _ in range(QUICK_STEPS)]
    want_params, want_losses = _reference_quickstart(rparams, batches)
    np.testing.assert_allclose(out["losses"], want_losses, rtol=LOSS_RTOL)
    want = _named(want_params)
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(out["params"][k].numpy(), w, rtol=0,
                                   atol=PARAM_RTOL * scale, err_msg=k)


def test_train_lm_preamble_matches_reference(capsys):
    rcfg = dataclasses.replace(
        ref_config("qwen2-0.5b"), name="qwen2-100m", n_layers=8,
        d_model=512, n_heads=8, n_kv_heads=2, d_head=64, d_ff=2048,
        vocab=32_000, compute_dtype="float32")
    rmodel = ref_model(rcfg)
    shapes = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(shapes))
    for rbd_dim, workers in ((4096, 4), (4096, 1), (1024, 2)):
        rplan = ref_step_plan(rmodel, RefRBDConfig(total_dim=rbd_dim))
        pre = train_lm.preamble(train_lm.qwen2_100m(), rbd_dim, workers)
        assert pre["n_params"] == n_params
        assert pre["plan"].total_dim == rplan.total_dim
        assert pre["plan"].reduction_factor == rplan.reduction_factor
        assert pre["plan"].describe() == rplan.describe()
        lines = [f"model D={n_params / 1e6:.1f}M params; RBD "
                 f"d={rplan.total_dim} ({rplan.reduction_factor:.0f}x "
                 "reduction)"]
        for m in train_lm.COMM_MODES:
            c = ref_comm(rplan, n_params, workers, m)
            assert pre["comm"][m] == c
            lines.append(f"  per-step gradient traffic [{m:18s}]: "
                         f"{c['bytes_per_step'] / 1e6:10.3f} MB")
        assert pre["lines"] == lines


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_examples_refuse_the_card_without_one():
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        quickstart.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train_lm.main(["--workers", "1", "--steps", "1"])
