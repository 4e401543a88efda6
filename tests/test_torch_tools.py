"""Port parity of the small core helpers the tools and examples use,
against ``repro`` on the same inputs:

* ``Plan.describe()``, ``reduction_factor`` and ``packable``: the
  reference's strings and values on the FC net's plans (layer and global)
  and on the reduced qwen2-0.5b's (every normalization);
* ``make_even_plan``: the reference's plan, and its ValueError when K
  does not divide D;
* ``rng.generate_vector``: the uint32 bit streams at its counters and the
  uniform / rademacher / bernoulli samples bit for bit (the offset
  wrapping past 2**32 included); normal samples within 1e-6 absolute
  (torch's log / cos against XLA's, an ulp or two: ROADMAP ground
  rules);
* ``distributed.grad_comm_bytes``: the reference's dict over the three
  modes x ``packed`` x ``widened`` on the reduced qwen2-0.5b plan.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import RBDConfig as RefRBDConfig
from repro.core import compartments as ref_comp
from repro.core import distributed as ref_dist
from repro.core import rng as ref_rng
from repro.models import get_model as ref_model
from repro.models import vision as ref_vision
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig
from repro_torch.core import compartments, distributed, rng
from repro_torch.models import vision
from repro_torch.models.registry import get_model
from repro_torch.train import step as steplib

torch.set_num_threads(1)

NORMAL_ATOL = 1e-6
NORMALIZATIONS = ("rsqrt_dim", "exact", "none", "orthonormal")


def _fc_plans(granularity, dim):
    init, _ = ref_vision.get_vision_model("fc")
    rparams = init(jax.random.PRNGKey(0), (28, 28, 1))
    params = vision.fc_init(0, (28, 28, 1), device="cpu")
    return (ref_comp.make_plan(rparams, dim, granularity=granularity,
                               normalization="exact"),
            compartments.make_plan(params, dim, granularity=granularity,
                                   normalization="exact"))


def _qwen_plans(norm, dim=128):
    rcfg = ref_config("qwen2-0.5b").reduced(compute_dtype="float32")
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    return (ref_step.make_plan(ref_model(rcfg),
                               RefRBDConfig(total_dim=dim,
                                            normalization=norm)),
            steplib.make_plan(get_model(cfg),
                              RBDConfig(total_dim=dim, normalization=norm)))


def _assert_plan_summary(ref, port):
    assert port.describe() == ref.describe()
    assert port.reduction_factor == ref.reduction_factor
    assert port.packable == ref.packable


@pytest.mark.parametrize("granularity,dim", [("layer", 250), ("global", 250),
                                             ("layer", 7)])
def test_fc_plan_summary_matches_reference(granularity, dim):
    _assert_plan_summary(*_fc_plans(granularity, dim))


@pytest.mark.parametrize("norm", NORMALIZATIONS)
def test_qwen2_plan_summary_matches_reference(norm):
    ref, port = _qwen_plans(norm)
    _assert_plan_summary(ref, port)
    assert port.packable == (norm != "orthonormal")


@pytest.mark.parametrize("n,k,d,dist,norm", [
    (1200, 4, 64, "normal", "rsqrt_dim"),
    (1200, 3, 7, "rademacher", "exact"),
    (96, 8, 1000, "uniform", "none"),     # d_k clipped to the size
    (10, 10, 3, "normal", "rsqrt_dim"),   # at least one direction
])
def test_make_even_plan_matches_reference(n, k, d, dist, norm):
    ref = ref_comp.make_even_plan(n, k, d, distribution=dist,
                                  normalization=norm)
    port = compartments.make_even_plan(n, k, d, distribution=dist,
                                       normalization=norm)
    assert port.leaves == tuple(compartments.LeafPlan(**vars(lp))
                                for lp in ref.leaves)
    assert (port.total_dim, port.total_params, port.distribution,
            port.normalization, port.flatten, port.pad) == (
        ref.total_dim, ref.total_params, ref.distribution,
        ref.normalization, ref.flatten, ref.pad)
    assert port.describe() == ref.describe()


def test_make_even_plan_refuses_k_not_dividing_d():
    with pytest.raises(ValueError) as ref_err:
        ref_comp.make_even_plan(10, 3, 4)
    with pytest.raises(ValueError) as err:
        compartments.make_even_plan(10, 3, 4)
    assert str(err.value) == str(ref_err.value)


# (seed parts, offset, n): offsets at 0, mid-range, and wrapping past 2**32
VECTORS = [((7,), 0, 1000), ((1, 2), 123_456, 513),
           ((3,), 2**32 - 100, 300)]


@pytest.mark.parametrize("parts,offset,n", VECTORS)
def test_generate_vector_bits_match_reference(parts, offset, n):
    ctr = (np.arange(n, dtype=np.uint64) + offset).astype(np.uint32)
    want = ref_rng._bits_for_counters(ref_rng.fold_seed(*parts), ctr,
                                      np.uint32(0))
    ctr_t = rng.as_u32(ctr)
    got = rng._bits_for_counters(rng.fold_seed(*parts), ctr_t, 0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(rng.to_uint32(g), np.asarray(w))


@pytest.mark.parametrize("dist", ["uniform", "rademacher", "bernoulli",
                                  "normal"])
@pytest.mark.parametrize("parts,offset,n", VECTORS)
def test_generate_vector_matches_reference(parts, offset, n, dist):
    want = np.asarray(ref_rng.generate_vector(ref_rng.fold_seed(*parts),
                                              np.uint32(offset), n, dist))
    got = rng.generate_vector(rng.fold_seed(*parts), offset, n, dist)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    if dist == "normal":
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=NORMAL_ATOL)
    else:
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_generate_vector_dtype_and_int_seed():
    a = rng.generate_vector(5, 10, 16, "uniform", dtype=torch.float64)
    b = rng.generate_vector(rng.as_u32(5), 10, 16, "uniform")
    assert a.dtype == torch.float64
    assert torch.equal(a, b.double())


@pytest.mark.parametrize("mode,packed,widened", list(itertools.product(
    ("sgd", "shared_basis", "independent_bases"), (False, True),
    (False, True))))
def test_grad_comm_bytes_matches_reference_on_qwen2(mode, packed, widened):
    ref, port = _qwen_plans("rsqrt_dim")
    for k in (1, 2, 4):
        assert distributed.grad_comm_bytes(
            port, port.total_params, k, mode, packed=packed,
            widened=widened) == ref_dist.grad_comm_bytes(
            ref, ref.total_params, k, mode, packed=packed, widened=widened)
