"""Port parity of the recurrent zoo families (RWKV-6 and the zamba2
Mamba2 hybrid) against ``repro.models``: the forward pass at reduced size
(zamba2 also at four layers: two groups, the shared block twice) and one
packed random-bases step,
and the init's scales leaf by leaf, through tests/test_torch_zoo_model.py's
helpers and tolerances (logits 1e-5 of max|logit|; the step's loss rtol
1e-5 and theta 1e-3 of the update + 4 ulp)."""

import pytest
import torch

from test_torch_zoo_model import (FORWARD_CASES, check_forward,
                                  check_init_scales, check_packed_step)

torch.set_num_threads(1)

RECURRENT = ("rwkv6-1.6b", "zamba2-2.7b")
CASES = [c for c in FORWARD_CASES if c[0] in RECURRENT]


@pytest.mark.parametrize("arch,overrides,s", CASES,
                         ids=[f"{a}-{o.get('n_layers', 'r')}"
                              for a, o, _ in CASES])
def test_forward_logits_match_reference(arch, overrides, s):
    check_forward(arch, overrides, s)


@pytest.mark.parametrize("arch", RECURRENT)
def test_one_packed_step_matches_reference(arch):
    check_packed_step(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_follows_the_reference_scales_by_leaf(arch):
    check_init_scales(arch)
