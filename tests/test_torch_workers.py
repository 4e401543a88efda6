"""Port parity of the K-worker joint subspace (independent bases, paper
Algorithm 1): worker seeds, the plain version of the K-worker
reconstruct-apply kernel, the split and accumulated steps, and the
exchange accounting -- each against the reference on the same inputs
(its jnp oracles; Pallas in interpret mode at a tiny shape).  The K-worker
``SubspaceOptimizer`` simulation is in test_torch_workers_sim.py.

Tolerances (as in test_torch_projector.py, for the same reasons):
seeds bit-exact; theta within 1e-5 of the largest update + 2 ulp of the
largest parameter (float32 sums in another order, per dir-block and per
worker).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as ref_dist
from repro.core import projector as ref_proj
from repro.core import rng as ref_rng
from repro.kernels import rbd_step as ref_kernels
from repro.optim import subspace as ref_subspace
from repro_torch.configs import get_config
from repro_torch.configs.base import RBDConfig, TrainConfig
from repro_torch.core import distributed, projector, rng
from repro_torch.core.rbd import RandomBasesTransform
from repro_torch.data import synthetic
from repro_torch.kernels import rbd_step
from repro_torch.models.registry import get_model
from repro_torch.optim import subspace
from repro_torch.train import step as steplib
from test_torch_projector import (DB, PB, _assert_theta_close,
                                  _packed_inputs, _plans)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

DISTS = ["normal", "uniform", "bernoulli", "rademacher", "sparse"]


def _worker_scale(layout, k, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((k, layout.d_packed)) * 1e-2
            * layout.coord_valid).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) worker seeds
# ---------------------------------------------------------------------------


K_MAX = 5


@functools.cache
def _ref_worker_seeds(step):
    """The reference's K_MAX worker seeds and worker-major segment seeds
    of one step (one compile; worker k's seeds do not depend on K)."""
    ref_plan, _ = _plans()
    seeds = ref_proj.worker_base_seeds(ref_rng.fold_seed(11, jnp.uint32(
        step)), K_MAX)
    seg = jax.vmap(lambda s: ref_proj.segment_seeds(ref_plan, s))(seeds)
    return np.asarray(seeds), np.asarray(seg)


@pytest.mark.parametrize("k", [1, 2, 3, K_MAX])
def test_worker_seeds_bit_exact(k):
    _, plan = _plans()
    n_seg = plan.packed().n_segments
    for step in (0, 7):
        want, want_seg = _ref_worker_seeds(step)
        seed = rng.fold_seed(11, step)
        got = rng.to_uint32(projector.worker_base_seeds(seed, k))
        np.testing.assert_array_equal(got, want[:k])
        got_seg = rng.to_uint32(projector.worker_segment_seeds(plan, seed, k))
        assert got_seg.shape == (k * n_seg,)
        np.testing.assert_array_equal(got_seg, want_seg[:k].reshape(-1))


# ---------------------------------------------------------------------------
# (b) the K-worker apply: plain version vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dist", DISTS)
def test_workers_plain_vs_reference_oracle(dist, k):
    ref_plan, plan = _plans(dist)
    rl, layout = ref_plan.packed(PB, DB), plan.packed(PB, DB)
    _, theta, _, valid = _packed_inputs(layout, seed=k)
    scale = _worker_scale(layout, k, seed=10 + k)
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(5), k)
    want = np.asarray(ref_proj._reconstruct_apply_packed_workers_jnp(
        jnp.asarray(rng.to_uint32(wseeds)), jnp.asarray(scale),
        jnp.asarray(theta), rl, k, dist))
    got = rbd_step.reconstruct_apply_packed_workers_plain(
        wseeds, torch.from_numpy(scale), torch.from_numpy(theta), layout,
        dist).numpy()
    _assert_theta_close(got, want, theta)
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("k", [2, 3])
def test_public_workers_api_exact_vs_reference(k):
    """'exact' folds each worker's gathered row norms into its scale row;
    the public entry (seed schedule, factors, eta) against the
    reference's."""
    ref_plan, plan = _plans("normal", "exact")
    rl, layout = ref_plan.packed(PB, DB), plan.packed(PB, DB)
    _, theta, _, valid = _packed_inputs(layout, seed=20 + k)
    rs = np.random.default_rng(k)
    coords = _worker_scale(layout, k, seed=30 + k) * 100
    row_sq = (rs.uniform(0.5, 2.0, (k, layout.d_packed))
              * layout.coord_valid).astype(np.float32)
    want = np.asarray(ref_proj.reconstruct_apply_packed_workers(
        jnp.asarray(coords), ref_plan, ref_rng.fold_seed(8),
        jnp.asarray(theta), 0.3 / k, row_sq=jnp.asarray(row_sq), layout=rl,
        prepacked=True))
    got = projector.reconstruct_apply_packed_workers(
        torch.from_numpy(coords), plan, rng.fold_seed(8),
        torch.from_numpy(theta), 0.3 / k, row_sq=torch.from_numpy(row_sq),
        layout=layout, prepacked=True).numpy()
    _assert_theta_close(got, want, theta)
    assert (got[~valid] == 0).all()


def test_workers_api_raises_like_reference():
    _, plan = _plans("normal", "exact")
    layout = plan.packed()
    coords = torch.zeros((2, layout.d_packed))
    theta = torch.zeros((layout.q_packed,))
    with pytest.raises(ValueError, match="row norms"):
        projector.reconstruct_apply_packed_workers(
            coords, plan, rng.fold_seed(0), theta, 0.1, prepacked=True)
    _, ortho = _plans("normal", "orthonormal")
    with pytest.raises(ValueError, match="factor-style"):
        projector.reconstruct_apply_packed_workers(
            coords, ortho, rng.fold_seed(0), theta, 0.1, prepacked=True)


def test_workers_plain_vs_interpret_mode_pallas():
    """A handful of tiles through the reference's K-worker Pallas kernel
    in interpret mode."""
    shapes = {"a": (2, 50), "b": (130,)}
    ref_plan, plan = _plans("normal", shapes=shapes, dim=12)
    rl, layout = ref_plan.packed(PB, DB), plan.packed(PB, DB)
    _, theta, _, _ = _packed_inputs(layout, seed=3)
    scale = _worker_scale(layout, 2, seed=4)
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(4), 2)
    want = np.asarray(ref_kernels.reconstruct_apply_packed_workers(
        jnp.asarray(rng.to_uint32(wseeds)), jnp.asarray(scale),
        jnp.asarray(theta), rl, 2, "normal", interpret=True))
    got = rbd_step.reconstruct_apply_packed_workers_plain(
        wseeds, torch.from_numpy(scale), torch.from_numpy(theta), layout,
        "normal").numpy()
    _assert_theta_close(got, want, theta)


def test_workers_wrapper_takes_plain_version_on_cpu_only():
    _, plan = _plans("uniform")
    layout = plan.packed(PB, DB)
    _, theta, _, _ = _packed_inputs(layout, seed=5)
    scale = torch.from_numpy(_worker_scale(layout, 3, seed=6))
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(1), 3)
    rbd_step.reset_counts()
    th = torch.from_numpy(theta.copy())
    out = rbd_step.reconstruct_apply_packed_workers(wseeds, scale, th,
                                                    layout, "uniform",
                                                    out=th)
    want = rbd_step.reconstruct_apply_packed_workers_plain(
        wseeds, scale, torch.from_numpy(theta), layout, "uniform")
    assert out is th and torch.equal(th, want)
    assert rbd_step.CALLS["reconstruct_apply_packed_workers"] == 1
    assert rbd_step.LAUNCHES == dict.fromkeys(rbd_step.KERNELS, 0)
    # K = 1 with worker seed fold_seed(s, 1) is the single-worker apply
    one = rbd_step.reconstruct_apply_packed_workers_plain(
        wseeds[: layout.n_segments], scale[:1], torch.from_numpy(theta),
        layout, "uniform")
    single = rbd_step.reconstruct_apply_packed_plain(
        projector.segment_seeds(plan, rng.fold_seed(rng.fold_seed(1), 1)),
        scale[0], torch.from_numpy(theta), layout, "uniform")
    assert torch.equal(one, single)


# ---------------------------------------------------------------------------
# (d) split step and accumulation
# ---------------------------------------------------------------------------


def _tiny_sub(optimizer="adam", **kw):
    _, plan = _plans("normal", dim=96)
    return subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=3, backend="cuda"),
        optimizer=optimizer, learning_rate=0.3, use_packed=True, **kw)


@pytest.mark.parametrize("mode,k", [("shared_basis", 1),
                                    ("independent_bases", 3)])
def test_split_step_matches_monolithic_step(mode, k):
    sub = _tiny_sub(mode=mode, k_workers=k)
    layout = sub.transform.plan.packed()
    _, theta, _, valid = _packed_inputs(layout, seed=1)
    rs = np.random.default_rng(2)
    shape = (k, layout.q_packed) if k > 1 else (layout.q_packed,)
    g = torch.from_numpy(np.where(valid, rs.standard_normal(shape),
                                  0).astype(np.float32))
    theta = torch.from_numpy(theta)
    st_r, st_o = sub.init_rbd_state(), sub.init_opt_state(device="cpu")
    one, _, one_o, _ = sub.step(theta, g, st_r, st_o)
    ticket = sub.step_sketch(theta, g, st_r, st_o)
    two, _, two_o, _ = sub.step_finish(theta, ticket, st_r, st_o)
    assert torch.equal(one, two)
    for a, b in zip(one_o, two_o):
        assert torch.equal(a, b)


def test_accumulate_finalize_bit_exact_vs_manual_mean():
    sub = _tiny_sub("sgd")
    layout = sub.transform.plan.packed()
    _, theta, _, valid = _packed_inputs(layout, seed=4)
    rs = np.random.default_rng(5)
    gps = [torch.from_numpy(np.where(valid, rs.standard_normal(
        layout.q_packed), 0).astype(np.float32)) for _ in range(4)]
    acc = None
    for g in gps:
        acc = sub.accumulate_grads(acc, g)
    mean = sub.finalize_accum(acc, 4)
    ref = (((gps[0] + gps[1]) + gps[2]) + gps[3]) * (1.0 / 4)
    assert torch.equal(mean, ref)
    theta = torch.from_numpy(theta)
    st_r, st_o = sub.init_rbd_state(), sub.init_opt_state(device="cpu")
    got, *_ = sub.step(theta, mean, st_r, st_o)
    want, *_ = sub.step(theta, ref, st_r, st_o)
    assert torch.equal(got, want)
    # N=1 is an exact passthrough
    assert sub.finalize_accum(gps[0], 1) is gps[0]


@pytest.mark.parametrize("optimizer,norm", [("sgd", "rsqrt_dim"),
                                            ("momentum", "exact"),
                                            ("adam", "none")])
def test_grad_accum_matches_concatenated_batch(optimizer, norm):
    """One optimizer step on N stacked microbatches == one step on the
    concatenated batch, up to the order of the float32 loss reductions
    (the reference's contract: rtol 1e-4 / atol 2e-5 for sgd, 2e-4 for
    the stateful optimizers)."""
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    n, bs = 2, 2

    def tcfg(accum, batch):
        return TrainConfig(model=cfg, rbd=RBDConfig(
            total_dim=128, backend="cuda", normalization=norm),
            optimizer=optimizer, learning_rate=0.5, batch_size=batch,
            seq_len=16, grad_accum_steps=accum)

    stream = synthetic.lm_batches(0, bs, 16, cfg.vocab, device="cpu")
    micro = [next(stream) for _ in range(n)]
    stacked = steplib.stack_microbatches(micro)
    concat = {k: torch.cat([m[k] for m in micro]) for k in micro[0]}
    init_a, step_a = steplib.make_train_step(model, tcfg(n, bs),
                                             device="cpu")
    init_c, step_c = steplib.make_train_step(model, tcfg(1, n * bs),
                                             device="cpu")
    rbd_step.reset_counts()
    sa, ma = step_a(init_a(0), stacked)
    assert rbd_step.CALLS["project_packed"] == 1
    sc, mc = step_c(init_c(0), concat)
    tol = (dict(rtol=1e-4, atol=2e-5) if optimizer == "sgd"
           else dict(rtol=2e-4, atol=2e-4))
    np.testing.assert_allclose(sa.params.numpy(), sc.params.numpy(), **tol)
    np.testing.assert_allclose(float(ma["loss"]), float(mc["loss"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# (e) exchange buffers, accounting and plans
# ---------------------------------------------------------------------------


def test_widened_buffer_roundtrip():
    rs = np.random.default_rng(0)
    c, q = (rs.standard_normal((3, 24)).astype(np.float32) for _ in "cq")
    buf = distributed.widen_coord_buffer(torch.from_numpy(c),
                                         torch.from_numpy(q))
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(ref_dist.widen_coord_buffer(c, q)))
    c2, q2 = distributed.split_coord_buffer(buf, 24)
    assert torch.equal(c2, torch.from_numpy(c))
    assert torch.equal(q2, torch.from_numpy(q))
    # no process group: the token carries the local buffers through
    pend = distributed.start_exchange(torch.from_numpy(c[0]),
                                      torch.from_numpy(q[0]), None)
    assert pend.kind == "local" and pend.work is None
    got_c, got_q = distributed.finish_exchange(pend)
    assert torch.equal(got_c, torch.from_numpy(c[0]))
    assert torch.equal(got_q, torch.from_numpy(q[0]))


@pytest.mark.parametrize("packed,widened", [(False, False), (True, False),
                                            (True, True)])
@pytest.mark.parametrize("mode", ["sgd", "shared_basis",
                                  "independent_bases"])
def test_grad_comm_bytes_matches_reference(mode, packed, widened):
    ref_plan, plan = _plans()
    for k in (1, 2, 8):
        assert distributed.grad_comm_bytes(
            plan, 123_456, k, mode, packed=packed, widened=widened) == \
            ref_dist.grad_comm_bytes(ref_plan, 123_456, k, mode,
                                     packed=packed, widened=widened)


JOINT_FLAG_CASES = [
    dict(mode="independent_bases", k_workers=4),
    dict(mode="independent_bases", k_workers=4, normalization="exact"),
    dict(mode="independent_bases", axis_name="data",
         normalization="exact"),
    dict(mode="independent_bases", axis_name="data", overlap="off"),
    dict(mode="independent_bases", axis_name="data", optimizer="adam"),
    dict(mode="shared_basis", axis_name="data", normalization="exact"),
    dict(mode="shared_basis", k_workers=4),
]


@pytest.mark.parametrize("flags", JOINT_FLAG_CASES,
                         ids=[str(i) for i in range(len(JOINT_FLAG_CASES))])
def test_joint_plans_and_overlap_reasons_match_reference(flags):
    port = subspace.plan_from_flags(backend="cuda", use_packed=True,
                                    **flags)
    ref = ref_subspace.plan_from_flags(backend="pallas", use_packed=True,
                                       **flags)
    assert port == ref
    assert port.strategy == "fused_packed"


def test_k_worker_plan_needs_stacked_grads():
    sub = _tiny_sub("sgd", mode="independent_bases", k_workers=3)
    layout = sub.transform.plan.packed()
    with pytest.raises(ValueError, match="stacked"):
        sub.step_sketch(torch.zeros(layout.q_packed),
                        torch.zeros((2, layout.q_packed)),
                        sub.init_rbd_state(), ())
