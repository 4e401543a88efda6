"""Three ``fused_packed`` steps of the port against the reference's
``make_train_step`` for the stateful coordinate optimizers (momentum,
adam); sgd and the tolerances are in tests/test_torch_train.py."""

import pytest

from test_torch_train import run_three_steps_against_reference


@pytest.mark.parametrize("optimizer,lr", [("momentum", 0.25),
                                          ("adam", 0.02)])
def test_three_fused_packed_steps_match_reference(optimizer, lr):
    run_three_steps_against_reference(optimizer, lr)
