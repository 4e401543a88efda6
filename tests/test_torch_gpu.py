"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and
skips with a reason where there is none.  On a machine with the card
(``--noconftest``: the repository's conftest imports jax, which these
tests do not need):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: bits bit-exact; samples bit-exact except
normal (1e-6); u relative to ||g_seg|| sqrt(sq/Q) and sq relative 2e-5
(another float32 summation order); theta 1e-4 of the update plus 2 ulp
(also for the K-worker apply, whose K workers' parts are subtracted in
the same order by the kernel and its plain version, and for each row of
the B-adapter apply, whose rows are also bit-identical to the
single-tenant kernel's).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import compartments, projector, rng
from repro_torch.kernels import rbd_step

pytestmark = pytest.mark.gpu
DISTS = ["normal", "uniform", "rademacher", "sparse"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layout(dist):
    shapes = {"w": (640, 33), "layers/k": (3, 700, 10), "s": (),
              "odd": (7, 73)}
    plan = compartments.make_plan(
        shapes, 300, is_stacked=lambda n: n.startswith("layers"),
        distribution=dist)
    return plan, plan.packed()


def _valid(layout, device):
    mask = torch.zeros(layout.q_packed, dtype=torch.bool, device=device)
    for off, size in zip(layout.seg_param_off, layout.seg_size):
        mask[int(off): int(off) + int(size)] = True
    return mask


@pytest.mark.parametrize("dist", DISTS + ["bernoulli"])
def test_generate_tile_matches_plain(cuda, dist):
    for row0, col0 in ((16, 1024), (2**32 - 4, 2**32 - 300)):
        b0, b1, x = rbd_step.generate_tile(123, row0, col0, (8, 512), dist,
                                           device=cuda)
        p0, p1, px = rbd_step.generate_tile(123, row0, col0, (8, 512), dist,
                                            device="cpu")
        assert torch.equal(b0.cpu(), p0) and torch.equal(b1.cpu(), p1)
        if dist == "normal":
            assert float((x.cpu() - px).abs().max()) <= 1e-6
        else:
            assert torch.equal(x.cpu(), px)


@pytest.mark.parametrize("dist", DISTS)
def test_project_kernel_matches_plain(cuda, dist):
    plan, lay = _layout(dist)
    seeds = projector.segment_seeds(plan, rng.fold_seed(3))
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.where(_valid(lay, cuda),
                    torch.randn(lay.q_packed, generator=gen, device=cuda), 0)
    before = rbd_step.LAUNCHES["project_packed"]
    u, sq = rbd_step.project_packed(seeds, g, lay, dist)
    u2, sq2 = rbd_step.project_packed(seeds, g, lay, dist)
    assert rbd_step.LAUNCHES["project_packed"] == before + 2
    assert torch.equal(u, u2) and torch.equal(sq, sq2)
    up, sqp = rbd_step.project_packed_plain(seeds, g, lay, dist)
    for s in range(lay.n_segments):
        o, q = int(lay.seg_param_off[s]), int(lay.seg_size[s])
        c, n = int(lay.seg_coord_off[s]), int(lay.seg_pdim[s])
        scale = g[o: o + q].norm() * torch.sqrt(sqp[c: c + n] / q)
        assert bool(((u - up)[c: c + n].abs() <= 2e-5 * scale).all())
    assert bool(((sq - sqp).abs() <= 2e-5 * sqp).all())


@pytest.mark.parametrize("dist", DISTS)
def test_reconstruct_apply_kernel_matches_plain(cuda, dist):
    plan, lay = _layout(dist)
    seeds = projector.segment_seeds(plan, rng.fold_seed(4))
    gen = torch.Generator(device=cuda).manual_seed(1)
    valid = _valid(lay, cuda)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device=cuda), 0)
    scale = torch.randn(lay.d_packed, generator=gen, device=cuda) * 1e-2
    scale = scale * torch.from_numpy(lay.coord_valid).to(cuda)
    out = rbd_step.reconstruct_apply_packed(seeds, scale, theta, lay, dist)
    again = theta.clone()
    rbd_step.reconstruct_apply_packed(seeds, scale, again, lay, dist,
                                      out=again)
    assert torch.equal(out, again)
    assert bool((out[~valid] == 0).all())
    ref = rbd_step.reconstruct_apply_packed_plain(seeds, scale, theta, lay,
                                                  dist)
    tol = (1e-4 * float((ref - theta).abs().max())
           + 2 * 2.0**-23 * float(theta.abs().max()))
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dist", DISTS)
def test_workers_kernel_matches_plain(cuda, dist, k):
    plan, lay = _layout(dist)
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(6), k)
    gen = torch.Generator(device=cuda).manual_seed(2)
    valid = _valid(lay, cuda)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device=cuda), 0)
    scale = torch.randn((k, lay.d_packed), generator=gen, device=cuda)
    scale = scale * 1e-2 * torch.from_numpy(lay.coord_valid).to(cuda)
    before = rbd_step.LAUNCHES["reconstruct_apply_packed_workers"]
    out = rbd_step.reconstruct_apply_packed_workers(wseeds, scale, theta,
                                                    lay, dist)
    assert rbd_step.LAUNCHES["reconstruct_apply_packed_workers"] == before + 1
    again = theta.clone()
    rbd_step.reconstruct_apply_packed_workers(wseeds, scale, again, lay,
                                              dist, out=again)
    assert torch.equal(out, again)
    assert bool((out[~valid] == 0).all())
    ref = rbd_step.reconstruct_apply_packed_workers_plain(wseeds, scale,
                                                          theta, lay, dist)
    tol = (1e-4 * float((ref - theta).abs().max())
           + 2 * 2.0**-23 * float(theta.abs().max()))
    assert float((out - ref).abs().max()) <= tol


def test_workers_kernel_k1_is_the_single_worker_kernel(cuda):
    plan, lay = _layout("normal")
    step_seed = rng.fold_seed(9)
    gen = torch.Generator(device=cuda).manual_seed(3)
    theta = torch.where(_valid(lay, cuda), torch.randn(
        lay.q_packed, generator=gen, device=cuda), 0)
    scale = torch.randn((1, lay.d_packed), generator=gen, device=cuda)
    scale = scale * 1e-2 * torch.from_numpy(lay.coord_valid).to(cuda)
    one = rbd_step.reconstruct_apply_packed_workers(
        projector.worker_segment_seeds(plan, step_seed, 1), scale, theta,
        lay)
    single = rbd_step.reconstruct_apply_packed(
        projector.segment_seeds(plan, rng.fold_seed(step_seed, 1)),
        scale[0].contiguous(), theta, lay)
    assert torch.equal(one, single)


def test_k_worker_simulation_launches(cuda):
    from repro_torch.core.rbd import RandomBasesTransform
    from repro_torch.optim import subspace

    plan, lay = _layout("normal")
    k = 3
    sub = subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=1, backend="cuda"),
        learning_rate=0.3, use_packed=True, mode="independent_bases",
        k_workers=k)
    valid = _valid(lay, cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device=cuda), 0)
    st_r, st_o = sub.init_rbd_state(), sub.init_opt_state(device=cuda)
    rbd_step.reset_counts()
    for _ in range(2):
        g = torch.where(valid, torch.randn((k, lay.q_packed), generator=gen,
                                           device=cuda), 0)
        theta, st_r, st_o, _ = sub.step(theta, g, st_r, st_o)
    assert rbd_step.LAUNCHES["project_packed"] == 2 * k
    assert rbd_step.LAUNCHES["reconstruct_apply_packed_workers"] == 2
    assert bool(torch.isfinite(theta).all())
    assert bool((theta[~valid] == 0).all())


def test_train_step_launches_two_kernels(cuda):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.data import synthetic
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=128,
                                                backend="cuda"))
    init_state, train_step = steplib.make_train_step(get_model(cfg), tcfg,
                                                     device=cuda)
    state = init_state(0)
    data = synthetic.lm_batches(0, 2, 16, cfg.vocab, device=cuda)
    rbd_step.reset_counts()
    for _ in range(2):
        state, metrics = train_step(state, next(data))
        assert math.isfinite(float(metrics["loss"]))
    assert rbd_step.LAUNCHES["project_packed"] == 2
    assert rbd_step.LAUNCHES["reconstruct_apply_packed"] == 2


def _adapter_inputs(plan, lay, cuda, b, seed=5):
    aseeds = np.arange(40, 40 + b, dtype=np.uint32)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    theta = torch.where(_valid(lay, cuda), torch.randn(
        lay.q_packed, generator=gen, device=cuda), 0)
    scale = torch.randn((b, lay.d_packed), generator=gen, device=cuda)
    scale = scale * 1e-2 * torch.from_numpy(lay.coord_valid).to(cuda)
    return aseeds, projector.adapter_segment_seeds(plan, aseeds), theta, scale


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dist", DISTS)
def test_adapters_kernel_matches_plain(cuda, dist, b):
    plan, lay = _layout(dist)
    _, aseg, theta, scale = _adapter_inputs(plan, lay, cuda, b)
    valid = _valid(lay, cuda)
    before = rbd_step.LAUNCHES["reconstruct_apply_packed_adapters"]
    out = rbd_step.reconstruct_apply_packed_adapters(aseg, scale, theta, lay,
                                                     dist)
    assert rbd_step.LAUNCHES["reconstruct_apply_packed_adapters"] == \
        before + 1
    assert out.shape == (b, lay.q_packed)
    again = rbd_step.reconstruct_apply_packed_adapters(aseg, scale, theta,
                                                       lay, dist)
    assert torch.equal(out, again)
    assert bool((out[:, ~valid] == 0).all())
    ref = rbd_step.reconstruct_apply_packed_adapters_plain(aseg, scale,
                                                           theta, lay, dist)
    for a in range(b):
        tol = (1e-4 * float((ref[a] - theta).abs().max())
               + 2 * 2.0**-23 * float(theta.abs().max()))
        assert float((out[a] - ref[a]).abs().max()) <= tol


def test_adapters_kernel_b1_is_the_single_tenant_kernel(cuda):
    plan, lay = _layout("normal")
    aseeds, aseg, theta, scale = _adapter_inputs(plan, lay, cuda, 3, seed=6)
    out = rbd_step.reconstruct_apply_packed_adapters(aseg[:lay.n_segments],
                                                     scale[:1], theta, lay)
    single = rbd_step.reconstruct_apply_packed(
        projector.segment_seeds(plan, int(aseeds[0])), scale[0].contiguous(),
        theta, lay)
    assert torch.equal(out[0], single)
    # and each row of a B = 3 launch is that adapter's single-tenant apply
    batch = rbd_step.reconstruct_apply_packed_adapters(aseg, scale, theta,
                                                       lay)
    for a in range(3):
        single = rbd_step.reconstruct_apply_packed(
            projector.segment_seeds(plan, int(aseeds[a])),
            scale[a].contiguous(), theta, lay)
        assert torch.equal(batch[a], single)


def test_multi_tenant_admission_is_one_launch(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.adapters import (AdapterCache, AdapterRegistry,
                                            AdapterSpec)
    from repro_torch.serve.engine import MultiTenantEngine

    cfg = get_config("tinyllama-1.1b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    plan = compartments.make_plan(model.param_shapes(), 64,
                                  granularity="layer",
                                  is_stacked=model.is_stacked)
    reg = AdapterRegistry()
    rs = np.random.default_rng(0)
    for i in range(3):
        reg.register(AdapterSpec(f"t{i}", 100 + i,
                                 0.05 * rs.normal(size=plan.packed().d_packed)))
    mt = MultiTenantEngine(model, params, plan, registry=reg,
                           delta_cache=AdapterCache(1 << 30), n_slots=4,
                           max_len=32)
    for i in range(3):
        mt.submit(np.arange(5) + i, 4, adapter_id=f"t{i}")
    mt.submit(np.arange(6), 4)
    rbd_step.reset_counts()
    mt.step()
    assert rbd_step.LAUNCHES["reconstruct_apply_packed_adapters"] == 1
    assert mt.stats["fused_launches"] == 1
    mt.run()
    assert rbd_step.LAUNCHES["reconstruct_apply_packed_adapters"] == 1
    assert mt.stats["decode_steps"] == 3
