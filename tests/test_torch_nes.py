"""Port parity of the NES baseline ``core.nes.nes_gradient`` against the
reference's ``repro.core.nes.nes_gradient`` on the FC net at 14 x 14 x 1
(the fixture of tests/test_system.py:16-31), from the reference's
parameters and a batch of its mixture images, at sigma 0.02.

Cases: a layer plan at d 32 (rsqrt_dim) and a global 'exact' plan at d 16,
each antithetic and one-sided; the reference runs under ``jax.jit`` (one
compile instead of one ``lax.map`` compile a leaf).  Tolerance, relative to max|estimate|:
2e-3 antithetic, 1e-5 one-sided.  Both packages evaluate the same loss to
float32 rounding (~1e-7 of |L|, the sums in another order); the
antithetic form divides the difference of two nearby losses by 2 sigma,
so the estimate's relative error grows by |L| / |L+ - L-| -- measured up
to 4.2e-4 here -- while the one-sided form divides L itself (measured
1.6e-7).  The port's estimate is also collinear with its own RBD sketch
at the same seed on the global plan (cosine > 0.99, the reference's
tests/test_system.py:175), and ``backend="cuda"`` without the parameters
on a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_plan as ref_make_plan
from repro.core import nes as ref_nes
from repro.core import rng as ref_rng
from repro.data import synthetic as ref_data
from repro.models import vision as ref_vision
from repro_torch.core import compartments, nes, projector, rng
from repro_torch.models import vision
from repro_torch.models.registry import params_from_reference

torch.set_num_threads(1)

SIGMA = 0.02
RTOL = {True: 2e-3, False: 1e-5}      # antithetic, one-sided
CASES = [("layer", 32, "rsqrt_dim"), ("global", 16, "exact")]


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def fc():
    init, apply = ref_vision.get_vision_model("fc")
    rparams = init(jax.random.PRNGKey(0), (14, 14, 1))
    x, y = ref_data.mixture_images(jax.random.PRNGKey(5), 64,
                                   shape=(14, 14, 1), noise=0.8)

    def ref_loss(p):
        logp = jax.nn.log_softmax(apply(p, x))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    _, papply = vision.get_vision_model("fc")
    xt = torch.from_numpy(np.array(x))
    yt = torch.from_numpy(np.array(y)).long()

    def loss(p):
        logp = torch.log_softmax(papply(p, xt), -1)
        return -torch.mean(torch.gather(logp, 1, yt[:, None])[:, 0])

    return rparams, ref_loss, params_from_reference(
        _named(rparams), device="cpu"), loss


@pytest.mark.parametrize("antithetic", [True, False],
                         ids=["antithetic", "one_sided"])
@pytest.mark.parametrize("granularity,dim,norm", CASES,
                         ids=[f"{g}_d{d}" for g, d, _ in CASES])
def test_nes_matches_reference(fc, granularity, dim, norm, antithetic):
    rparams, ref_loss, params, loss = fc
    rplan = ref_make_plan(rparams, dim, granularity=granularity,
                          normalization=norm)
    plan = compartments.make_plan(params, dim, granularity=granularity,
                                  normalization=norm)
    assert plan.total_dim == rplan.total_dim
    # under jax.jit: one compile, not one a leaf (the eager call's
    # values to float32 rounding, far inside the tolerance)
    want = _named(jax.jit(lambda p: ref_nes.nes_gradient(
        ref_loss, p, rplan, ref_rng.fold_seed(1), sigma=SIGMA,
        antithetic=antithetic))(rparams))
    got = nes.nes_gradient(loss, params, plan, rng.fold_seed(1),
                           sigma=SIGMA, antithetic=antithetic)
    assert sorted(got) == sorted(want)
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=RTOL[antithetic] * scale, err_msg=k)


def test_nes_is_collinear_with_the_rbd_sketch(fc):
    _, _, params, loss = fc
    plan = compartments.make_plan(params, 16, granularity="global",
                                  normalization="exact")
    seed = rng.fold_seed(1)
    est = nes.nes_gradient(loss, params, plan, seed, sigma=SIGMA)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
    sketch = projector.rbd_gradient(grads, plan, seed)
    a = torch.cat([est[k].reshape(-1) for k in params]).double()
    b = torch.cat([sketch[k].reshape(-1) for k in params]).double()
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos > 0.99, cos


def test_cuda_backend_needs_the_card(fc):
    _, _, params, loss = fc
    plan = compartments.make_plan(params, 4, granularity="global")
    with pytest.raises(RuntimeError, match="CUDA device"):
        nes.nes_gradient(loss, params, plan, 0, backend="cuda")
    # auto on the CPU: the plain versions, the torch backend's values
    auto = nes.nes_gradient(loss, params, plan, 0)
    plain = nes.nes_gradient(loss, params, plan, 0, backend="torch")
    assert all(torch.equal(auto[k], plain[k]) for k in params)
