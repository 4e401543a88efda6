"""Port parity of the K-worker ``SubspaceOptimizer`` simulation
(independent bases, ``k_workers=K``, ``axis_name=None``) against the
reference's, on the same stacked per-worker gradients: K projections on
the workers' own bases, the (K, d_packed) joint optimizer state, and one
K-worker reconstruct-apply per step.

Tolerances: through optimizer steps the coordinates inherit the
projection's relative error (about 1e-6, float32 sums in another order),
which the optimizer state carries forward: theta within 1e-4 of the
cumulative update + 4 ulp of the largest parameter, the optimizer state
within 1e-4 of its largest entry, the update norm rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rbd import RandomBasesTransform as RefTransform
from repro.optim import subspace as ref_subspace
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.kernels import rbd_step
from repro_torch.optim import subspace
from test_torch_projector import EPS32, _packed_inputs, _plans

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# (c) the K-worker SubspaceOptimizer simulation vs the reference's
# ---------------------------------------------------------------------------

def _ref_tree():
    return {"w": jnp.ones((64, 32)), "layers": {"k": jnp.ones((3, 40, 10))},
            "s": jnp.ones(()), "odd": jnp.ones((7, 73)),
            "long": jnp.ones((700,))}


def _opt_kw(optimizer):
    return dict(optimizer=optimizer,
                learning_rate={"sgd": 0.3, "momentum": 0.2,
                               "adam": 0.02}[optimizer])


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("norm", ["rsqrt_dim", "exact"])
@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_k_worker_simulation_vs_reference(optimizer, norm, k):
    ref_plan, plan = _plans("normal", norm, dim=96)
    layout = plan.packed()
    rs = np.random.default_rng(100 + k)
    _, theta0, _, valid = _packed_inputs(layout, seed=k)
    grad_seq = [np.where(valid, rs.standard_normal((k, layout.q_packed)),
                         0).astype(np.float32) for _ in range(2)]

    rsub = ref_subspace.SubspaceOptimizer(
        transform=RefTransform(ref_plan, base_seed=7, backend="jnp"),
        use_packed=True, mode="independent_bases", k_workers=k,
        **_opt_kw(optimizer))
    sub = subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=7, backend="cuda"),
        use_packed=True, mode="independent_bases", k_workers=k,
        **_opt_kw(optimizer))
    assert sub.plan_execution() == rsub.plan_execution()
    assert sub.joint_subspace and rsub.joint_subspace

    tree = _ref_tree()
    r_theta, r_rbd = jnp.asarray(theta0), rsub.init_rbd_state(tree)
    r_opt = rsub.init_opt_state(tree)
    theta, rbd_state = torch.from_numpy(theta0), sub.init_rbd_state()
    opt_state = sub.init_opt_state(device="cpu")
    r_step = jax.jit(rsub.step)
    rbd_step.reset_counts()
    for gs in grad_seq:
        r_theta, r_rbd, r_opt, r_aux = r_step(r_theta, jnp.asarray(gs),
                                              r_rbd, r_opt)
        theta, rbd_state, opt_state, aux = sub.step(
            theta, torch.from_numpy(gs), rbd_state, opt_state)
        want = np.asarray(r_theta)
        tol = (1e-4 * np.abs(want - theta0).max()
               + 4 * EPS32 * np.abs(want).max())
        np.testing.assert_allclose(theta.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(float(aux.update_norm),
                                   float(r_aux.update_norm), rtol=1e-4)
    assert (theta.numpy()[~valid] == 0).all()
    r_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(r_opt)
                if np.asarray(x).ndim == 2]
    leaves = [x.numpy() for x in
              (opt_state if isinstance(opt_state, tuple) else [opt_state])
              if isinstance(x, torch.Tensor) and x.ndim == 2]
    assert len(leaves) == len(r_leaves) == {"sgd": 0, "momentum": 1,
                                            "adam": 2}[optimizer]
    for a, b in zip(leaves, r_leaves):
        assert a.shape == (k, layout.d_packed)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    # K projections and ONE K-worker apply per step
    assert rbd_step.CALLS["project_packed"] == 2 * k
    assert rbd_step.CALLS["reconstruct_apply_packed_workers"] == 2
    assert rbd_step.CALLS["reconstruct_apply_packed"] == 0
