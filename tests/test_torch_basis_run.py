"""The gradient_informed + lbfgs short run of the materialized basis
against the reference (test_torch_basis.py has the checks, the
tolerances and the trajectory_pca + momentum run): 6 steps of the reduced
qwen2-0.5b at rbd-dim 40, the basis refreshed every 3 steps from the
packed gradients, L-BFGS in its coordinates."""

import torch

from test_torch_basis import run_short_against_reference

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


def test_gradient_informed_lbfgs_run_matches_reference():
    run_short_against_reference("gradient_informed", "lbfgs")
