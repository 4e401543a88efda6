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
single-tenant kernel's).  The per-leaf kernels: ``project_flat`` to the
same u/sq tolerances and bit-identical to ``project_packed`` on the same
seeds (the same grid and sum order); ``reconstruct_flat`` within 2e-5 of
its largest value; ``reconstruct_apply_flat`` 1e-4 of the update plus 2
ulp of theta's dtype, bf16 rounded once; their shard instances to the
same tolerances against their plain versions, and against the
unsharded kernels bit for bit (reconstructions) or within 8 ulps of sum
|g b| (the summed projections).  The prefill's flash-attention
kernels: the CUDA-core one (f32; bf16 at head size 16 / 32 / 80 / 256) within 1e-5
of max|v| of its plain version (f32 sums over another tiling), plus one
bf16 ulp of the larger value for bf16 outputs; the tensor-core one (bf16
at head size 64 / 128) against the plain version with p_dtype=bfloat16 (P
rounded to bf16 at the same tiles) within the same plus 2**-7 max|v|
min(1 / l, 1 - 1 / l) of the row (one p landing on the other bf16
neighbour, at the largest weight such a key may have), and within 2**-10
of the output's norm in relative L2; reruns bit-identical.  The guarded
packed step (resilience) bit for bit: healthy, it is the unguarded step;
a NaN step leaves theta and the adam state untouched; restore + replay is
the uninterrupted run.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import compartments, projector, rng
from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step

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


# (n_stack, q, dim): a stacked leaf with a ragged last pos-block and a
# padded dir-block; an unstacked leaf of several projection chunks
FLAT_CASES = [(3, 700, 13), (1, 70_000, 20)]


def _flat_inputs(cuda, n, q, dim, seed=7):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    seeds = rng.fold_seed(rng.fold_seed(11, seed),
                          torch.arange(n, dtype=torch.int32))
    g = torch.randn((n, q), generator=gen, device=cuda)
    scale = torch.randn((n, dim), generator=gen, device=cuda) * 1e-2
    theta = torch.randn((n, q), generator=gen, device=cuda)
    return seeds, g, scale, theta


@pytest.mark.parametrize("n,q,dim", FLAT_CASES)
@pytest.mark.parametrize("dist", DISTS)
def test_project_flat_kernel_matches_plain(cuda, dist, n, q, dim):
    seeds, g, _, _ = _flat_inputs(cuda, n, q, dim)
    before = rbd_step.LAUNCHES["project_flat"]
    u, sq = rbd_project.project_flat(seeds, g, dim, dist)
    u2, sq2 = rbd_project.project_flat(seeds, g, dim, dist)
    assert rbd_step.LAUNCHES["project_flat"] == before + 2
    assert u.shape == sq.shape == (n, dim)
    assert torch.equal(u, u2) and torch.equal(sq, sq2)
    up, sqp = rbd_project.project_flat_plain(seeds, g, dim, dist)
    scale = g.norm(dim=1, keepdim=True) * torch.sqrt(sqp / q)
    assert bool(((u - up).abs() <= 2e-5 * scale).all())
    assert bool(((sq - sqp).abs() <= 2e-5 * sqp).all())


def test_project_flat_is_project_packed_bit_for_bit(cuda):
    """One leaf's per-leaf launch and the packed launch of the same
    compartments run the same grid and sum order: identical bits."""
    shapes = {"layers/k": (3, 700, 10)}
    plan = compartments.make_plan(
        shapes, 39, is_stacked=lambda n: n.startswith("layers"))
    lay = plan.packed()
    lp = plan.leaves[0]
    seeds = projector.segment_seeds(plan, rng.fold_seed(5))
    gen = torch.Generator(device=cuda).manual_seed(8)
    g = torch.randn((lp.n_stack, lp.size), generator=gen, device=cuda)
    u, sq = rbd_project.project_flat(seeds, g, lp.dim)
    pu, psq = rbd_step.project_packed(
        seeds, projector.pack_tree({"layers/k": g}, plan, lay), lay)
    cu = projector.unpack_coords(pu, plan, lay)[0]
    csq = projector.unpack_coords(psq, plan, lay)[0]
    assert torch.equal(u, cu) and torch.equal(sq, csq)


@pytest.mark.parametrize("n,q,dim", FLAT_CASES)
@pytest.mark.parametrize("dist", DISTS)
def test_reconstruct_flat_kernel_matches_plain(cuda, dist, n, q, dim):
    seeds, _, scale, _ = _flat_inputs(cuda, n, q, dim)
    before = rbd_step.LAUNCHES["reconstruct_flat"]
    out = rbd_reconstruct.reconstruct_flat(seeds, scale, q, dist)
    again = rbd_reconstruct.reconstruct_flat(seeds, scale, q, dist)
    assert rbd_step.LAUNCHES["reconstruct_flat"] == before + 2
    assert torch.equal(out, again) and out.dtype == torch.float32
    ref = rbd_reconstruct.reconstruct_flat_plain(seeds, scale, q, dist)
    assert float((out - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,q,dim", FLAT_CASES)
@pytest.mark.parametrize("dist", DISTS)
def test_reconstruct_apply_flat_kernel_matches_plain(cuda, dist, n, q, dim,
                                                     dtype):
    seeds, _, scale, theta = _flat_inputs(cuda, n, q, dim)
    theta = theta.to(dtype)
    before = rbd_step.LAUNCHES["reconstruct_apply_flat"]
    out = rbd_reconstruct.reconstruct_apply_flat(seeds, scale, theta, 0.5,
                                                 dist)
    assert rbd_step.LAUNCHES["reconstruct_apply_flat"] == before + 1
    assert out.dtype == dtype
    inplace = theta.clone()
    rbd_reconstruct.reconstruct_apply_flat(seeds, scale, inplace, 0.5, dist,
                                           out=inplace)
    assert torch.equal(out, inplace)
    ref = rbd_reconstruct.reconstruct_apply_flat_plain(seeds, scale, theta,
                                                       0.5, dist)
    ulp = 2.0**-23 if dtype == torch.float32 else 2.0**-7
    tol = (1e-4 * float((ref.float() - theta.float()).abs().max())
           + 2 * ulp * float(theta.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_reconstruct_apply_flat_bf16_rounds_once(cuda):
    """bf16 theta: float32 accumulation from float(theta), one rounding
    on the store -- the kernel's bf16 output is its float32 output on the
    same values rounded once."""
    seeds, _, scale, theta = _flat_inputs(cuda, 2, 5000, 24, seed=9)
    theta16 = theta.to(torch.bfloat16)
    out16 = rbd_reconstruct.reconstruct_apply_flat(seeds, scale, theta16,
                                                   0.1)
    out32 = rbd_reconstruct.reconstruct_apply_flat(seeds, scale,
                                                   theta16.float(), 0.1)
    assert torch.equal(out16, out32.to(torch.bfloat16))


# leaf shards of pjit-style sharding: (name, whole shape, sharded dim,
# stacked, m) -- embed-like on 0, a head on -1, stacked row-parallel on
# -2 across several projection chunks, MoE experts on -3
SHARD_CASES = [("embed", (96, 700), 0, False, 4),
               ("lm_head", (33, 4096), 1, False, 4),
               ("layers/mlp/w_down", (2, 70_000, 3), 1, True, 2),
               ("layers/moe/w_up", (2, 4, 24, 40), 1, True, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SHARD_CASES, ids=[c[0] for c in SHARD_CASES])
@pytest.mark.parametrize("dist", DISTS)
def test_shard_instances_match_plain_and_unsharded_slices(cuda, dist, case,
                                                          dtype):
    """Rows 8-10's shard instances on every shard: against their plain
    versions (the per-leaf tolerances), and against the unsharded
    kernels -- reconstruct and apply the same positions bit for bit, the
    projections summed over the shards within PROJ_ULPS ulps of sum |g b|
    (another summation order)."""
    from repro_torch.models.registry import LeafShards

    name, shape, dim, stacked, m = case
    n = shape[0] if stacked else 1
    d = 13
    gen = torch.Generator(device=cuda).manual_seed(3)
    seeds = rng.fold_seed(rng.fold_seed(11, 3),
                          torch.arange(n, dtype=torch.int32))
    g = torch.randn(shape, generator=gen, device=cuda)
    th = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    sc = torch.randn((n, d), generator=gen, device=cuda) * 1e-2

    def rows(x):
        return x.reshape(n, -1).contiguous()

    q = rows(g).shape[1]
    u, sq = rbd_project.project_flat(seeds, rows(g), d, dist)
    delta = rbd_reconstruct.reconstruct_flat(seeds, sc, q, dist)
    out = rbd_reconstruct.reconstruct_apply_flat(seeds, sc, rows(th), 0.5,
                                                 dist)
    shards = LeafShards({name: shape}, {name: dim}, m, 0)
    us, sqs = torch.zeros_like(u), torch.zeros_like(sq)
    ulp = 2.0**-23 if dtype == torch.float32 else 2.0**-7
    for r in range(m):
        sh = shards.with_rank(r)
        cm = sh.colmap(name, stacked)
        gl, tl = rows(sh.cut(name, g)), rows(sh.cut(name, th))
        before = rbd_step.LAUNCHES["project_flat_shard"]
        ul, sql = rbd_project.project_flat_shard(seeds, gl, d, dist,
                                                 colmap=cm)
        assert rbd_step.LAUNCHES["project_flat_shard"] == before + 1
        up, sqp = rbd_project.project_flat_shard_plain(seeds, gl, d, dist,
                                                       colmap=cm)
        scale = gl.norm(dim=1, keepdim=True) * torch.sqrt(sqp / gl.shape[1])
        assert bool(((ul - up).abs() <= 2e-5 * scale).all())
        assert bool(((sql - sqp).abs() <= 2e-5 * sqp).all())
        us += ul
        sqs += sql
        dl = rbd_reconstruct.reconstruct_flat_shard(seeds, sc, gl.shape[1],
                                                    dist, colmap=cm)
        assert torch.equal(dl.reshape(sh.local_shape(name)),
                           sh.cut(name, delta.reshape(shape)))
        ref = rbd_reconstruct.reconstruct_flat_shard_plain(
            seeds, sc, gl.shape[1], dist, colmap=cm)
        assert float((dl - ref).abs().max()) <= 2e-5 * float(
            ref.abs().max())
        ol = rbd_reconstruct.reconstruct_apply_flat_shard(seeds, sc, tl, 0.5,
                                                          dist, colmap=cm)
        assert ol.dtype == dtype
        assert torch.equal(ol.reshape(sh.local_shape(name)),
                           sh.cut(name, out.reshape(shape)))
        ref = rbd_reconstruct.reconstruct_apply_flat_shard_plain(
            seeds, sc, tl, 0.5, dist, colmap=cm)
        tol = (1e-4 * float((ref.float() - tl.float()).abs().max())
               + 2 * ulp * float(tl.float().abs().max()))
        assert float((ol.float() - ref.float()).abs().max()) <= tol
    for s in range(n):
        tail = shape[1:] if stacked else shape
        b = rng.generate_block(int(rng.as_u32(seeds[s].cpu())), 0, 0,
                               (d, int(np.prod(tail))), dist,
                               device=cuda).abs()
        gb = b @ rows(g)[s].abs()
        assert bool(((us[s] - u[s]).abs() <= 8 * 2.0**-23 * gb).all())
        bb = (b * b).sum(1)
        assert bool(((sqs[s] - sq[s]).abs() <= 8 * 2.0**-23 * bb).all())


def test_shard_instances_refuse_tile_keyed_impls(cuda):
    seeds = torch.zeros(1, dtype=torch.int32)
    g = torch.zeros((1, 512), device=cuda)
    with pytest.raises(ValueError, match="threefry"):
        rbd_project.project_flat_shard(seeds, g, 8, colmap=(256, 512, 0),
                                       prng="hw")


@pytest.mark.parametrize("impl", ["threefry", "hw_emulated", "hw"])
def test_plain_generator_new_form_is_the_stepwise_one(cuda, impl):
    """The plain generator's card path (fused passes, column chunks
    replayed as CUDA graphs) against its stepwise form, bit for bit."""
    shape = (16, (1 << 18) + 512)   # several chunks and a ragged one
    for dist in DISTS + ["bernoulli"]:
        got = rng.generate_tiled_block(impl, 0x2468ACE, 512, shape, dist,
                                       device=cuda)
        with rng.stepwise_form():
            want = rng.generate_tiled_block(impl, 0x2468ACE, 512, shape,
                                            dist, device=cuda)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_per_leaf_train_steps_launch_per_leaf(cuda):
    """fused_per_leaf: one project_flat and one reconstruct_apply_flat
    launch per LeafPlan per step; weight decay (full_space): one
    project_flat and one reconstruct_flat per leaf."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.data import synthetic
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    for rbd, wd, apply in ((RBDConfig(total_dim=128, backend="cuda",
                                      packed="off"), 0.0,
                            "reconstruct_apply_flat"),
                           (RBDConfig(total_dim=128, backend="cuda"), 0.01,
                            "reconstruct_flat")):
        tcfg = TrainConfig(model=cfg, rbd=rbd, weight_decay=wd)
        init_state, train_step, sub = steplib.make_train_step(
            get_model(cfg), tcfg, device=cuda, return_optimizer=True)
        n = len(sub.transform.plan.leaves)
        state = init_state(0)
        data = synthetic.lm_batches(0, 2, 16, cfg.vocab, device=cuda)
        rbd_step.reset_counts()
        for _ in range(2):
            state, metrics = train_step(state, next(data))
            assert math.isfinite(float(metrics["loss"]))
        launched = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
        assert launched == {"project_flat": 2 * n, apply: 2 * n}


# -- the model-sharded slab kernels -----------------------------------------


def _padded(lay, sl, gen, cuda):
    valid = torch.cat([_valid(lay, cuda), torch.zeros(
        sl.q_padded - lay.q_packed, dtype=torch.bool, device=cuda)])
    return valid, torch.where(valid, torch.randn(
        sl.q_padded, generator=gen, device=cuda), 0)


@pytest.mark.parametrize("m", [2, 3, 7])
@pytest.mark.parametrize("dist", DISTS)
def test_sharded_projection_matches_plain_and_completes(cuda, dist, m):
    """Each slab's partial (u, sq) against its plain version, and the
    shard-ordered sum against the unsharded kernel, to the u/sq
    tolerances; reruns bit-identical."""
    plan, lay = _layout(dist)
    sl = compartments.sharded_packed_layout(lay, m)
    seeds = projector.segment_seeds(plan, rng.fold_seed(3))
    gen = torch.Generator(device=cuda).manual_seed(10)
    _, g = _padded(lay, sl, gen, cuda)
    uf, sqf = rbd_step.project_packed(seeds, g[:lay.q_packed].contiguous(),
                                      lay, dist)
    us = torch.zeros_like(uf)
    sqs = torch.zeros_like(sqf)
    for shard in range(m):
        slab = sl.slab_range(shard)
        gs = g[slab[0]:slab[1]]
        u, sq = rbd_step.project_packed_sharded(seeds, gs, sl, shard, dist)
        u2, sq2 = rbd_step.project_packed_sharded(seeds, gs, sl, shard, dist)
        assert torch.equal(u, u2) and torch.equal(sq, sq2)
        up, sqp = rbd_step.project_packed_sharded_plain(seeds, gs, sl, shard,
                                                        dist)
        _assert_partial_close(u, sq, up, sqp, uf, sqf, g, lay)
        us += u
        sqs += sq
    _assert_partial_close(us, sqs, uf, sqf, uf, sqf, g, lay)


def _assert_partial_close(u, sq, uw, sqw, uf, sqf, g, lay):
    """u within 2e-5 of ||g_seg|| sqrt(sq/Q) and sq within 2e-5 of the
    unsharded sq (``uf``, ``sqf``): a partial's sums to the scale of the
    whole coordinate's."""
    for s in range(lay.n_segments):
        o, q = int(lay.seg_param_off[s]), int(lay.seg_size[s])
        c, n = int(lay.seg_coord_off[s]), int(lay.seg_pdim[s])
        scale = g[o: o + q].norm() * torch.sqrt(sqf[c: c + n] / q)
        assert bool(((u - uw)[c: c + n].abs() <= 2e-5 * scale).all())
    assert bool(((sq - sqw).abs() <= 2e-5 * sqf).all())


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("m", [2, 3, 7])
@pytest.mark.parametrize("dist", DISTS)
def test_sharded_applies_are_slices_of_the_unsharded_kernel(cuda, dist, m,
                                                            k):
    """Each slab bit-identical to the matching slice of the unsharded
    apply (k=None) or K-worker apply; in place equal; padding exactly 0;
    within the theta tolerance of the plain version."""
    plan, lay = _layout(dist)
    sl = compartments.sharded_packed_layout(lay, m)
    gen = torch.Generator(device=cuda).manual_seed(11)
    valid, theta = _padded(lay, sl, gen, cuda)
    rows = 1 if k is None else k
    scale = torch.randn((rows, lay.d_packed), generator=gen, device=cuda)
    scale = scale * 1e-2 * torch.from_numpy(lay.coord_valid).to(cuda)
    if k is None:
        seeds = projector.segment_seeds(plan, rng.fold_seed(4))
        sc = scale[0].contiguous()
        full = rbd_step.reconstruct_apply_packed(
            seeds, sc, theta[:lay.q_packed].contiguous(), lay, dist)
        kernel = rbd_step.reconstruct_apply_packed_sharded
        plain = rbd_step.reconstruct_apply_packed_sharded_plain
    else:
        seeds = projector.worker_segment_seeds(plan, rng.fold_seed(4), k)
        sc = scale
        full = rbd_step.reconstruct_apply_packed_workers(
            seeds, sc, theta[:lay.q_packed].contiguous(), lay, dist)
        kernel = rbd_step.reconstruct_apply_packed_workers_sharded
        plain = rbd_step.reconstruct_apply_packed_workers_sharded_plain
    slabs = []
    for shard in range(m):
        a, b = sl.slab_range(shard)
        ts = theta[a:b]
        out = kernel(seeds, sc, ts, sl, shard, dist)
        again = ts.clone()
        kernel(seeds, sc, again, sl, shard, dist, out=again)
        assert torch.equal(out, again)
        ref = plain(seeds, sc, ts, sl, shard, dist)
        tol = (1e-4 * float((ref - ts).abs().max())
               + 2 * 2.0**-23 * float(ts.abs().max()))
        assert float((out - ref).abs().max()) <= tol
        slabs.append(out)
    got = torch.cat(slabs)
    assert torch.equal(got[:lay.q_packed], full)
    assert bool((got[~valid] == 0).all())


def test_shards_in_turn_launch_two_kernels_per_shard(cuda):
    from repro_torch.core.rbd import RandomBasesTransform
    from repro_torch.optim import subspace

    plan, lay = _layout("normal")
    m = 3
    sub = subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=1, backend="cuda"),
        learning_rate=0.3, use_packed=True, model_sharded=True,
        model_axis="model", model_shards=m)
    sl = sub.sharded_layout()
    gen = torch.Generator(device=cuda).manual_seed(12)
    valid, theta = _padded(lay, sl, gen, cuda)
    slabs = [sub.slab_of(theta, s).clone() for s in range(m)]
    st_r, st_o = sub.init_rbd_state(), sub.init_opt_state(device=cuda)
    rbd_step.reset_counts()
    for _ in range(2):
        g = torch.where(valid, torch.randn(sl.q_padded, generator=gen,
                                           device=cuda), 0)
        slabs, st_r, st_o, _ = sub.step_shards_in_turn(
            slabs, [sub.slab_of(g, s) for s in range(m)], st_r, st_o)
    assert rbd_step.LAUNCHES["project_packed_sharded"] == 2 * m
    assert rbd_step.LAUNCHES["reconstruct_apply_packed_sharded"] == 2 * m
    assert rbd_step.LAUNCHES["project_packed"] == 0
    got = torch.cat(slabs)
    assert bool(torch.isfinite(got).all()) and bool((got[~valid] == 0).all())


# -- the prefill's flash-attention kernel ------------------------------------

# (B, Sq, Sk, H, KV, hd, causal, window, kv_block):
# tests/test_flash_kernel.py's cases, qwen2-0.5b's heads at a ragged
# length, rows with no live key, the ragged lengths 1, 127 and 129; then batch 2 with a ragged Sk (the rows
# past Sk of a 128-row box are the hardware's zeros, not the next batch's),
# head size 128 with a window, kv_block 64 with Sk = 150 (Sk_pad 192 is
# not a multiple of the 128-row tile) and rows with no live key, and Sq = 1
FLASH_CASES = [
    (2, 256, 256, 4, 4, 16, True, None, 128),
    (2, 256, 256, 8, 2, 16, True, None, 128),
    (2, 200, 200, 4, 1, 16, True, None, 128),
    (2, 256, 256, 4, 2, 16, True, 64, 128),
    (2, 384, 384, 2, 2, 16, True, 100, 128),
    (1, 128, 256, 4, 4, 32, False, None, 128),
    (1, 200, 200, 14, 2, 64, True, None, 128),
    (1, 300, 100, 2, 1, 16, False, 50, 128),
    (1, 300, 100, 2, 1, 128, True, 50, 128),
    (1, 1, 1, 14, 2, 64, True, None, 128),
    (1, 127, 127, 32, 4, 64, True, 100, 128),
    (1, 129, 129, 14, 2, 64, True, None, 128),
    (2, 300, 200, 14, 2, 64, True, None, 128),
    (1, 512, 512, 4, 2, 128, True, 200, 128),
    (1, 400, 150, 2, 1, 64, True, 50, 64),
    (2, 1, 77, 14, 2, 128, False, None, 128),
]


def _flash_close(out, ref, v):
    """Within 1e-5 of max|v| (the output is a convex combination of v's
    rows; f32 sums over another tiling), plus for bf16 one bf16 ulp of the
    larger value (both round once from f32)."""
    a, b = out.float(), ref.float()
    tol = 1e-5 * float(v.float().abs().max())
    if out.dtype == torch.bfloat16:
        big = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
        tol = tol + torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((a - b).abs() <= tol).all())


def _flash_close_p_bf16(out, ref, l, v):
    """The tensor-core kernel against the plain version with
    p_dtype=bfloat16 (P rounded at the same tiles of 128 keys, 64 at head
    size 256; ``l`` its denominators): within _flash_close's tolerance +
    2**-7 max|v| min(1 / l, 1 - 1 / l) of the row (where the two f32 p of a key round to
    neighbouring bf16 values, 2**-7 of its weight p / l at most, allowed
    once a row; the row's largest key has p = 1 on both sides and weight
    1 / l, any other at most min(1 / l, 1 - 1 / l)), and within 2**-10
    of the output's norm in relative L2."""
    a, b = out.float(), ref.float()
    vmax = float(v.float().abs().max())
    big = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    w = 1.0 / l[..., None]
    tol = (1e-5 * vmax + torch.exp2(torch.floor(torch.log2(big)) - 7)
           + 2.0 ** -7 * vmax * torch.minimum(w, 1.0 - w))
    diff = (a - b).abs()
    rel = torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(b)
    return bool((diff <= tol).all()) and float(rel) <= 2.0 ** -10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(i) for i in range(len(FLASH_CASES))])
def test_flash_attention_matches_plain(cuda, case, dtype):
    """Each case through the kernel the wrapper chooses: the tensor-core
    one for bf16 at head size 64 / 128 (80 / 256: the zoo's test below),
    the CUDA-core one otherwise (f32, and bf16 at 16 / 32, under
    _flash_close as before); the variant counts
    show which ran."""
    from repro_torch.kernels import flash_attention as flash

    b, sq, sk, h, kv, hd, causal, window, kv_block = case
    gen = torch.Generator(device=cuda).manual_seed(sq + h)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, kv, hd), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    kernel = flash.kernel_for(dtype, hd)
    other = "fma" if kernel == "wgmma" else "wgmma"
    variants = rbd_step.VARIANT_LAUNCHES
    before = rbd_step.LAUNCHES["flash_attention"]
    ran = variants.get(f"flash_attention[{kernel}]", 0)
    not_ran = variants.get(f"flash_attention[{other}]", 0)
    out = flash.flash_attention(q, k, v, causal=causal, window=window,
                                kv_block=kv_block)
    again = flash.flash_attention(q, k, v, causal=causal, window=window,
                                  kv_block=kv_block)
    torch.cuda.synchronize()
    assert rbd_step.LAUNCHES["flash_attention"] == before + 2
    assert variants.get(f"flash_attention[{kernel}]", 0) == ran + 2
    assert variants.get(f"flash_attention[{other}]", 0) == not_ran
    assert out.dtype == dtype and tuple(out.shape) == (b, sq, h, hd)
    assert torch.equal(out, again)
    ref, l = flash.flash_attention_plain(
        q, k, v, causal=causal, window=window, kv_block=kv_block,
        p_dtype=flash.P_DTYPE[kernel], return_l=True)
    if kernel == "wgmma":
        assert _flash_close_p_bf16(out, ref, l, v)
    else:
        assert _flash_close(out, ref, v)


# the zoo's head sizes: zamba2's (32 / 32 heads of 80) and gemma3's (8 / 4
# heads of 256), causal, with and without a window, ragged lengths; batch
# 2 with a ragged Sk at 80 (the second column block's box reaches past
# column 80 and, in the last tile, past Sk), and at 256 rows with no live
# key over Sk_pad 256 (tiles 192-255 wholly past Sk = 150: the hardware's
# zeros), Sq = 1; (B, Sq, Sk, H, KV, hd, window, kv_block)
ZOO_FLASH_CASES = [
    (1, 300, 300, 4, 4, 80, None, 128), (2, 200, 200, 4, 4, 80, 64, 128),
    (1, 300, 300, 8, 4, 256, None, 128), (1, 257, 257, 8, 4, 256, 100, 128),
    (2, 300, 170, 4, 4, 80, None, 128), (1, 400, 150, 4, 2, 256, 50, 128),
    (1, 1, 77, 8, 4, 256, None, 128), (1, 400, 150, 4, 4, 80, 50, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ZOO_FLASH_CASES,
                         ids=[str(i) for i in range(len(ZOO_FLASH_CASES))])
def test_flash_attention_zoo_head_sizes(cuda, case, dtype):
    """Head sizes 80 and 256: bf16 runs the tensor-core kernel, within
    _flash_close_p_bf16 of its plain version (P rounded at its tiles: 128
    keys at 80, 64 at 256), f32 the CUDA-core kernel within _flash_close;
    at bf16 the CUDA-core kernel, named, stays within _flash_close of the
    f32-P plain version; reruns bit-identical."""
    from repro_torch.kernels import flash_attention as flash

    b, sq, sk, h, kv, hd, window, kv_block = case
    kernel = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert flash.kernel_for(dtype, hd) == kernel
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + hd)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, kv, hd), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    kw = dict(window=window, kv_block=kv_block)
    key = f"flash_attention[{kernel}]"
    before = dict(rbd_step.VARIANT_LAUNCHES)
    out = flash.flash_attention(q, k, v, **kw)
    again = flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    after = dict(rbd_step.VARIANT_LAUNCHES)
    assert after.get(key, 0) == before.get(key, 0) + 2
    assert sum(after.values()) == sum(before.values()) + 2
    assert torch.equal(out, again)
    ref, l = flash.flash_attention_plain(q, k, v, **kw,
                                         p_dtype=flash.P_DTYPE[kernel],
                                         return_l=True)
    if kernel == "wgmma":
        assert _flash_close_p_bf16(out, ref, l, v)
        out = flash._launch_kernel(q, k, v, kernel="fma", **kw)
        again = flash._launch_kernel(q, k, v, kernel="fma", **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        ref = flash.flash_attention_plain(q, k, v, **kw)
    assert _flash_close(out, ref, v)


def test_flash_attention_refuses_other_head_sizes_on_the_card(cuda):
    """A head size the kernel has no instance for raises on a CUDA tensor
    (no fall back to the plain version)."""
    from repro_torch.kernels import flash_attention as flash

    for hd in (48, 96, 512):
        q = torch.randn((1, 64, 2, hd), device=cuda)
        with pytest.raises(ValueError, match=f"head size {hd}"):
            flash.flash_attention(q, q, q)


def test_cuda_core_kernel_still_takes_bf16_at_64(cuda):
    """The CUDA-core kernel, named explicitly for bf16 at head size 64
    (as chip_smoke.py times it beside the tensor-core one), still matches
    the f32-P plain version under _flash_close."""
    from repro_torch.kernels import flash_attention as flash

    gen = torch.Generator(device=cuda).manual_seed(21)
    q = torch.randn((1, 200, 14, 64), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((1, 200, 2, 64), generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    before = rbd_step.VARIANT_LAUNCHES.get("flash_attention[fma]", 0)
    out = flash._launch_kernel(q, k, v, kernel="fma")
    torch.cuda.synchronize()
    assert rbd_step.VARIANT_LAUNCHES["flash_attention[fma]"] == before + 1
    assert _flash_close(out, flash.flash_attention_plain(q, k, v), v)
    with pytest.raises(ValueError, match="wgmma kernel takes bfloat16"):
        flash._launch_kernel(q.float(), k.float(), v.float(),
                             kernel="wgmma")


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as flash

    q = torch.randn((1, 64, 4, 64), device=cuda)
    k = torch.randn((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                              k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k.cpu(), k)
    with pytest.raises(RuntimeError, match="forward only"):
        flash.flash_attention(q.requires_grad_(), k, k)


def test_prefill_launches_flash_once_per_layer(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 200), device=cuda)
    rbd_step.reset_counts()
    with torch.no_grad():
        logits, cache = transformer.prefill(cfg, params, tokens, 208)
        assert rbd_step.LAUNCHES["flash_attention"] == cfg.n_layers
        full, _ = transformer.forward(cfg, params, tokens)
        model.decode_step(params, cache, tokens[:, :1])
    assert rbd_step.LAUNCHES["flash_attention"] == cfg.n_layers
    scale = float(full[:, -1].abs().max())
    assert float((logits[:, 0] - full[:, -1]).abs().max()) <= 1e-5 * scale


def test_bf16_prefill_runs_the_tensor_core_kernel(cuda):
    """qwen2-0.5b's head size (64) at the reduced width, bf16 compute: every
    layer's prefill launch is the tensor-core kernel's."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model

    cfg = get_config("qwen2-0.5b").reduced(d_head=64)
    assert cfg.compute_dtype == "bfloat16"
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 300), device=cuda)
    rbd_step.reset_counts()
    with torch.no_grad():
        logits, _ = transformer.prefill(cfg, params, tokens, 304)
    torch.cuda.synchronize()
    assert rbd_step.VARIANT_LAUNCHES == {
        "flash_attention[wgmma]": cfg.n_layers}
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the tile-keyed PRNG impls and the double buffer
# ---------------------------------------------------------------------------

TILE_KEYED = ["hw_emulated", "hw"]


@pytest.mark.parametrize("prng", TILE_KEYED)
@pytest.mark.parametrize("dist", DISTS + ["bernoulli"])
def test_tile_keyed_generate_tile_matches_plain(cuda, dist, prng):
    for row0, col0 in ((16, 1024), (2**32 - 4, 2**32 - 300), (0, 0)):
        b0, b1, x = rbd_step.generate_tile(123, row0, col0, (8, 512), dist,
                                           device=cuda, prng=prng)
        p0, p1, px = rbd_step.generate_tile(123, row0, col0, (8, 512), dist,
                                            device="cpu", prng=prng)
        assert torch.equal(b0.cpu(), p0) and torch.equal(b1.cpu(), p1)
        if dist == "normal":
            assert float((x.cpu() - px).abs().max()) <= 1e-6
        else:
            assert torch.equal(x.cpu(), px)


def _theta_tol(ref, theta):
    return (1e-4 * float((ref - theta).abs().max())
            + 2 * 2.0**-23 * float(theta.abs().max()))


@pytest.mark.parametrize("prng", TILE_KEYED)
@pytest.mark.parametrize("dist", DISTS)
def test_tile_keyed_packed_kernels_match_plain(cuda, dist, prng):
    """Rows 1-4 and 5-7 (m = 2) under a tile-keyed impl: each kernel
    against its plain version, the adapter rows and the slabs
    bit-identical to the single-tenant and unsharded kernels."""
    plan, lay = _layout(dist)
    seeds = projector.segment_seeds(plan, rng.fold_seed(8))
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(8), 2)
    gen = torch.Generator(device=cuda).manual_seed(8)
    valid = _valid(lay, cuda)
    g = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                       device=cuda), 0)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device=cuda), 0)
    scale = (torch.randn((2, lay.d_packed), generator=gen, device=cuda)
             * 1e-2 * torch.from_numpy(lay.coord_valid).to(cuda))
    u, sq = rbd_step.project_packed(seeds, g, lay, dist, prng=prng)
    up, sqp = rbd_step.project_packed_plain(seeds, g, lay, dist, prng=prng)
    for s in range(lay.n_segments):
        o, q = int(lay.seg_param_off[s]), int(lay.seg_size[s])
        c, n = int(lay.seg_coord_off[s]), int(lay.seg_pdim[s])
        bound = g[o: o + q].norm() * torch.sqrt(sqp[c: c + n] / q)
        assert bool(((u - up)[c: c + n].abs() <= 2e-5 * bound).all())
    assert bool(((sq - sqp).abs() <= 2e-5 * sqp).all())
    out = rbd_step.reconstruct_apply_packed(seeds, scale[0], theta, lay,
                                            dist, prng=prng)
    ref = rbd_step.reconstruct_apply_packed_plain(seeds, scale[0], theta,
                                                  lay, dist, prng=prng)
    assert float((out - ref).abs().max()) <= _theta_tol(ref, theta)
    assert bool((out[~valid] == 0).all())
    w = rbd_step.reconstruct_apply_packed_workers(wseeds, scale, theta, lay,
                                                  dist, prng=prng)
    ref = rbd_step.reconstruct_apply_packed_workers_plain(
        wseeds, scale, theta, lay, dist, prng=prng)
    assert float((w - ref).abs().max()) <= _theta_tol(ref, theta)
    a = rbd_step.reconstruct_apply_packed_adapters(wseeds, scale, theta,
                                                   lay, dist, prng=prng)
    assert torch.equal(a[0], rbd_step.reconstruct_apply_packed(
        wseeds[:lay.n_segments], scale[0], theta, lay, dist, prng=prng,
        double_buffer=False))
    sl = compartments.sharded_packed_layout(lay, 2)
    pad = sl.q_padded - lay.q_packed
    gp = torch.cat([g, g.new_zeros(pad)])
    tp = torch.cat([theta, theta.new_zeros(pad)])
    us = 0
    for shard in range(2):
        lo, hi = sl.slab_range(shard)
        su, _ = rbd_step.project_packed_sharded(
            seeds, gp[lo:hi].contiguous(), sl, shard, dist, prng=prng)
        us = us + su
        so = rbd_step.reconstruct_apply_packed_sharded(
            seeds, scale[0], tp[lo:hi].contiguous(), sl, shard, dist,
            prng=prng)
        assert torch.equal(so, torch.cat([out, out.new_zeros(pad)])[lo:hi])
        sw = rbd_step.reconstruct_apply_packed_workers_sharded(
            wseeds, scale, tp[lo:hi].contiguous(), sl, shard, dist,
            prng=prng)
        assert torch.equal(sw, torch.cat([w, w.new_zeros(pad)])[lo:hi])
    assert float((us - u).abs().max()) <= 1e-4 * float(u.abs().max())


@pytest.mark.parametrize("prng", ["threefry"] + TILE_KEYED)
def test_double_buffer_is_bit_identical(cuda, prng):
    """Rows 1-3 and 5-7: double_buffer on and off give the same bits;
    the variant counts see both launches."""
    plan, lay = _layout("normal")
    seeds = projector.segment_seeds(plan, rng.fold_seed(9))
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(9), 2)
    gen = torch.Generator(device=cuda).manual_seed(9)
    valid = _valid(lay, cuda)
    g = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                       device=cuda), 0)
    scale = torch.randn((2, lay.d_packed), generator=gen, device=cuda) * 1e-2
    sl = compartments.sharded_packed_layout(lay, 2)
    lo, hi = sl.slab_range(1)
    gp = torch.cat([g, g.new_zeros(sl.q_padded - lay.q_packed)])[lo:hi]
    calls = [
        lambda d: rbd_step.project_packed(seeds, g, lay, prng=prng,
                                          double_buffer=d),
        lambda d: rbd_step.reconstruct_apply_packed(
            seeds, scale[0], g, lay, prng=prng, double_buffer=d),
        lambda d: rbd_step.reconstruct_apply_packed_workers(
            wseeds, scale, g, lay, prng=prng, double_buffer=d),
        lambda d: rbd_step.project_packed_sharded(
            seeds, gp.contiguous(), sl, 1, prng=prng, double_buffer=d),
        lambda d: rbd_step.reconstruct_apply_packed_sharded(
            seeds, scale[0], gp.contiguous(), sl, 1, prng=prng,
            double_buffer=d),
        lambda d: rbd_step.reconstruct_apply_packed_workers_sharded(
            wseeds, scale, gp.contiguous(), sl, 1, prng=prng,
            double_buffer=d),
    ]
    rbd_step.reset_counts()
    for fn in calls:
        off, on = fn(False), fn(True)
        off = off if isinstance(off, tuple) else (off,)
        on = on if isinstance(on, tuple) else (on,)
        assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert rbd_step.VARIANT_LAUNCHES[rbd_step.variant_name(
        "project_packed", prng, True)] == 1


@pytest.mark.parametrize("prng", TILE_KEYED)
def test_tile_keyed_flat_kernels_match_plain(cuda, prng):
    gen = torch.Generator(device=cuda).manual_seed(10)
    seeds = rng.fold_seed(rng.fold_seed(10), torch.arange(2,
                                                          dtype=torch.int32))
    g = torch.randn((2, 1500), generator=gen, device=cuda)
    u, sq = rbd_project.project_flat(seeds, g, 30, prng=prng)
    up, sqp = rbd_project.project_flat_plain(seeds, g, 30, prng=prng)
    bound = g.norm(dim=1, keepdim=True) * torch.sqrt(sqp / 1500)
    assert bool(((u - up).abs() <= 2e-5 * bound).all())
    sc = torch.randn((2, 30), generator=gen, device=cuda) * 0.1
    d = rbd_reconstruct.reconstruct_flat(seeds, sc, 1500, prng=prng)
    dp = rbd_reconstruct.reconstruct_flat_plain(seeds, sc, 1500, prng=prng)
    assert float((d - dp).abs().max()) <= 2e-5 * float(dp.abs().max())
    th = torch.randn((2, 1500), generator=gen, device=cuda)
    out = rbd_reconstruct.reconstruct_apply_flat(seeds, sc, th, 0.1,
                                                 prng=prng)
    ref = rbd_reconstruct.reconstruct_apply_flat_plain(seeds, sc, th, 0.1,
                                                       prng=prng)
    assert float((out - ref).abs().max()) <= _theta_tol(ref, th)


# ---------------------------------------------------------------------------
# the hw kernels' key handling, exactly: one-hot inputs make every output
# a single basis value (u = P[:, c] for a one-hot g at column c; theta' =
# theta - P[r, :] for a one-hot scale at row r), and uniform samples are
# bit-exact against the plain generator, so the kernels must equal their
# plain versions bit for bit -- on the tiles a block's shared keys cover
# ---------------------------------------------------------------------------

# segments: shorter than one pos-block; a chunk (64 pos-blocks) and a
# partial pos-block whose last 2-column apply group ends inside its second
# column (q % 512 = 300); one ending inside its first (q % 512 = 100); a
# stacked leaf of 3 short compartments
HW_SHAPES = {"short": (5, 20), "chunk": (64 * 512 + 300,),
             "first": (2, 512 + 50), "layers/k": (3, 7, 33)}
HW_DISTS = ["uniform", "sparse"]


def _hw_layout(dist):
    plan = compartments.make_plan(
        HW_SHAPES, 24, is_stacked=lambda n: n.startswith("layers"),
        distribution=dist)
    return plan, plan.packed()


def _one_hot_g(lay, cuda, pick):
    """A gradient with one 1.0 per segment, at within-segment column
    pick(q)."""
    g = torch.zeros(lay.q_packed, device=cuda)
    for off, q in zip(lay.seg_param_off, lay.seg_size):
        g[int(off) + pick(int(q))] = 1.0
    return g


def _one_hot_scale(lay, cuda, pick, k=1):
    """k scale rows with one 1.0 per segment, at coordinate pick(dim)."""
    sc = torch.zeros((k, lay.d_packed), device=cuda)
    for off, d in zip(lay.seg_coord_off, lay.seg_dim):
        sc[:, int(off) + pick(int(d))] = 1.0
    return sc


# within-segment columns that land on the edges the shared keys cover:
# the first, the second column of a thread's pair, the last of the first
# chunk, the first of the second chunk, the last column of the segment
HW_COLUMNS = [lambda q: 0, lambda q: min(q - 1, 300),
              lambda q: min(q - 1, 64 * 512 - 1),
              lambda q: min(q - 1, 64 * 512 + 7), lambda q: q - 1]


@pytest.mark.parametrize("dist", HW_DISTS)
def test_hw_projection_is_plain_bit_for_bit(cuda, dist):
    """project_packed under hw, both double-buffer settings: u equal to
    the plain version's for one-hot gradients (a segment shorter than a
    pos-block, a chunk whose last pos-block is partial); sq within 2e-5."""
    plan, lay = _hw_layout(dist)
    seeds = projector.segment_seeds(plan, rng.fold_seed(21))
    for pick in HW_COLUMNS:
        g = _one_hot_g(lay, cuda, pick)
        up, sqp = rbd_step.project_packed_plain(seeds, g, lay, dist,
                                                prng="hw")
        outs = [rbd_step.project_packed(seeds, g, lay, dist, prng="hw",
                                        double_buffer=db)
                for db in (False, True)]
        for u, sq in outs:
            assert torch.equal(u, up)
            assert bool(((sq - sqp).abs() <= 2e-5 * sqp).all())
        assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dist", HW_DISTS)
def test_hw_applies_are_plain_bit_for_bit(cuda, dist):
    """The hw applies (rows 2-4), both double-buffer settings: theta' =
    theta - P[r, :] exactly for one-hot scales, on every column of every
    segment -- the 2-column groups where q ends inside one (q % 512 =
    300 and 100) and a segment shorter than a pos-block included."""
    plan, lay = _hw_layout(dist)
    seeds = projector.segment_seeds(plan, rng.fold_seed(22))
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(22), 2)
    gen = torch.Generator(device=cuda).manual_seed(22)
    theta = torch.where(_valid(lay, cuda), torch.randn(
        lay.q_packed, generator=gen, device=cuda), 0)
    for pick in (lambda d: 0, lambda d: d - 1):
        sc = _one_hot_scale(lay, cuda, pick, 2)
        ref = rbd_step.reconstruct_apply_packed_plain(seeds, sc[0], theta,
                                                      lay, dist, prng="hw")
        wref = rbd_step.reconstruct_apply_packed_workers_plain(
            wseeds, sc, theta, lay, dist, prng="hw")
        for db in (False, True):
            assert torch.equal(rbd_step.reconstruct_apply_packed(
                seeds, sc[0], theta, lay, dist, prng="hw",
                double_buffer=db), ref)
            assert torch.equal(rbd_step.reconstruct_apply_packed_workers(
                wseeds, sc, theta, lay, dist, prng="hw",
                double_buffer=db), wref)
        a = rbd_step.reconstruct_apply_packed_adapters(wseeds, sc, theta,
                                                       lay, dist, prng="hw")
        aref = rbd_step.reconstruct_apply_packed_adapters_plain(
            wseeds, sc, theta, lay, dist, prng="hw")
        assert torch.equal(a, aref)


@pytest.mark.parametrize("dist", HW_DISTS)
def test_hw_sharded_kernels_are_plain_bit_for_bit(cuda, dist):
    """The sharded hw kernels (rows 5-7) on m = 3 slabs (a slab starting
    inside a projection chunk), both double-buffer settings: each slab's
    partial u equal to the plain version's for one-hot gradients, each
    slab's applies equal to the plain version's for one-hot scales."""
    plan, lay = _hw_layout(dist)
    seeds = projector.segment_seeds(plan, rng.fold_seed(23))
    wseeds = projector.worker_segment_seeds(plan, rng.fold_seed(23), 2)
    sl = compartments.sharded_packed_layout(lay, 3)
    pad = sl.q_padded - lay.q_packed
    gen = torch.Generator(device=cuda).manual_seed(23)
    theta = torch.where(_valid(lay, cuda), torch.randn(
        lay.q_packed, generator=gen, device=cuda), 0)
    tp = torch.cat([theta, theta.new_zeros(pad)])
    sc = _one_hot_scale(lay, cuda, lambda d: d - 1, 2)
    for pick in HW_COLUMNS:
        gp = torch.cat([_one_hot_g(lay, cuda, pick),
                        theta.new_zeros(pad)])
        for shard in range(3):
            lo, hi = sl.slab_range(shard)
            up, _ = rbd_step.project_packed_sharded_plain(
                seeds, gp[lo:hi].contiguous(), sl, shard, dist, prng="hw")
            for db in (False, True):
                u, _ = rbd_step.project_packed_sharded(
                    seeds, gp[lo:hi].contiguous(), sl, shard, dist,
                    prng="hw", double_buffer=db)
                assert torch.equal(u, up)
    for shard in range(3):
        lo, hi = sl.slab_range(shard)
        ts = tp[lo:hi].contiguous()
        ref = rbd_step.reconstruct_apply_packed_sharded_plain(
            seeds, sc[0], ts, sl, shard, dist, prng="hw")
        wref = rbd_step.reconstruct_apply_packed_workers_sharded_plain(
            wseeds, sc, ts, sl, shard, dist, prng="hw")
        for db in (False, True):
            assert torch.equal(rbd_step.reconstruct_apply_packed_sharded(
                seeds, sc[0], ts, sl, shard, dist, prng="hw",
                double_buffer=db), ref)
            assert torch.equal(
                rbd_step.reconstruct_apply_packed_workers_sharded(
                    wseeds, sc, ts, sl, shard, dist, prng="hw",
                    double_buffer=db), wref)


@pytest.mark.parametrize("dist", HW_DISTS)
def test_hw_flat_kernels_are_plain_bit_for_bit(cuda, dist):
    """The per-leaf kernels under hw (rows 8-10): project_flat's u equal
    to the plain version's for one-hot gradients and bit-identical to
    project_packed on the same seeds; the reconstructions equal to the
    plain versions' for one-hot scales (f32 and bf16 theta)."""
    n, q, dim = 2, 64 * 512 + 300, 19
    seeds = rng.fold_seed(rng.fold_seed(24), torch.arange(
        n, dtype=torch.int32))
    for c in (0, 300, 64 * 512 - 1, 64 * 512 + 7, q - 1):
        g = torch.zeros((n, q), device=cuda)
        g[:, c] = 1.0
        u, sq = rbd_project.project_flat(seeds, g, dim, dist, prng="hw")
        up, _ = rbd_project.project_flat_plain(seeds, g, dim, dist,
                                               prng="hw")
        assert torch.equal(u, up)
    gen = torch.Generator(device=cuda).manual_seed(24)
    sc = torch.zeros((n, dim), device=cuda)
    sc[:, dim - 1] = 1.0
    d = rbd_reconstruct.reconstruct_flat(seeds, sc, q, dist, prng="hw")
    assert torch.equal(d, rbd_reconstruct.reconstruct_flat_plain(
        seeds, sc, q, dist, prng="hw"))
    for dtype in (torch.float32, torch.bfloat16):
        th = torch.randn((n, q), generator=gen, device=cuda).to(dtype)
        out = rbd_reconstruct.reconstruct_apply_flat(seeds, sc, th, 1.0,
                                                     dist, prng="hw")
        assert torch.equal(out, rbd_reconstruct.reconstruct_apply_flat_plain(
            seeds, sc, th, 1.0, dist, prng="hw"))
    # project_flat is project_packed on the same seeds, bit for bit
    shapes = {"layers/w": (n, q)}
    plan = compartments.make_plan(shapes, dim * n,
                                  is_stacked=lambda x: True,
                                  distribution=dist)
    lay = plan.packed()
    lp = plan.leaves[0]
    pseeds = projector.segment_seeds(plan, rng.fold_seed(24))
    g = torch.randn((n, q), generator=gen, device=cuda)
    u, sq = rbd_project.project_flat(pseeds, g, lp.dim, dist, prng="hw")
    pu, psq = rbd_step.project_packed(
        pseeds, projector.pack_tree({"layers/w": g}, plan, lay), lay, dist,
        prng="hw")
    assert torch.equal(u, projector.unpack_coords(pu, plan, lay)[0])
    assert torch.equal(sq, projector.unpack_coords(psq, plan, lay)[0])


def test_hw_transform_is_the_librarys_on_every_input(cuda):
    """The hw paths' normal transform (the CUDA library's fast paths of
    logf, sqrtf and cosf without the code their inputs never reach)
    equals the library's bit for bit on all 2**24 inputs of each."""
    mism = rbd_step.hw_transform_mismatches()
    assert mism["radius"] == 0 and mism["cosine"] == 0, mism


def test_hw_projection_normal_is_generate_tile_bit_for_bit(cuda):
    """Normal under hw: u for one-hot gradients equals the generate_tile
    kernel's samples of the column's tile (both through the hw transform),
    on the edges the projection's shared keys cover."""
    plan, lay = _hw_layout("normal")
    seeds = projector.segment_seeds(plan, rng.fold_seed(25))
    su = rng.as_u32(seeds).tolist()
    for pick in HW_COLUMNS:
        g = _one_hot_g(lay, cuda, pick)
        for db in (False, True):
            u, _ = rbd_step.project_packed(seeds, g, lay, "normal",
                                           prng="hw", double_buffer=db)
            for s in range(lay.n_segments):
                c = pick(int(lay.seg_size[s]))
                col0 = c - c % 512
                off = int(lay.seg_coord_off[s])
                for d in range(int(lay.seg_pdim[s]) // 8):
                    _, _, x = rbd_step.generate_tile(
                        su[s], 8 * d, col0, (8, 512), "normal",
                        device=cuda, prng="hw")
                    assert torch.equal(u[off + 8 * d: off + 8 * d + 8],
                                       x[:, c - col0])


@pytest.mark.parametrize("chunk_cols", [64 * 512 - 1, 63 * 512 + 7,
                                        65 * 512])
def test_hw_flat_projection_refuses_chunks_off_the_pos_blocks(cuda,
                                                              chunk_cols):
    """rbd_project_flat under hw takes whole pos-blocks, at most 64 a
    chunk (a block holds the round keys of the pos-blocks its chunk
    meets): other chunk widths are refused, not run past the keys."""
    n, q, n_db = 1, 3 * 64 * 512, 1
    n_chunk = -(-q // chunk_cols)
    g = torch.zeros((n, q), device=cuda)
    seeds = torch.zeros((n,), dtype=torch.int32, device=cuda)
    partial = torch.empty((n * n_db * n_chunk * 16,), device=cuda)
    arrived = torch.zeros((n * n_db,), dtype=torch.int32, device=cuda)
    u = torch.empty((n, 8), device=cuda)
    sq = torch.empty_like(u)
    lib = rbd_step.library(rbd_step.FLAT_SOURCE).lib
    rc = lib.rbd_project_flat(
        g.data_ptr(), seeds.data_ptr(), n, q, n_db, n_chunk, chunk_cols,
        0, rbd_step.impl_code("hw"), partial.data_ptr(), arrived.data_ptr(),
        u.data_ptr(), sq.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    assert arrived.sum().item() == 0   # nothing ran


# ---------------------------------------------------------------------------
# resilience: the guarded packed step and its replay on the card
# ---------------------------------------------------------------------------

RES_SHAPES = {"w": (48, 20), "layers/k": (3, 40, 10), "s": (),
              "odd": (7, 73), "long": (700,)}


def _res_sub(mode="shared_basis", k=1, optimizer="adam", guarded=True,
             capture=True):
    from repro_torch.core import resilience as res
    from repro_torch.core.rbd import RandomBasesTransform
    from repro_torch.optim import subspace

    plan = compartments.make_plan(
        RES_SHAPES, 96, is_stacked=lambda n: n.startswith("layers"),
        normalization="exact")
    return subspace.SubspaceOptimizer(
        transform=RandomBasesTransform(plan, base_seed=11, backend="cuda"),
        learning_rate=0.3, use_packed=True, optimizer=optimizer, mode=mode,
        k_workers=k, guard=res.GuardConfig() if guarded else None,
        capture_coords=capture)


def _res_grads(sub, cuda, key):
    lay = sub.transform.plan.packed()
    valid = _valid(lay, cuda)
    gen = torch.Generator(device=cuda).manual_seed(100 + key)
    shape = ((sub.k_workers, lay.q_packed) if sub.joint_subspace
             else (lay.q_packed,))
    return torch.where(valid, torch.randn(shape, generator=gen, device=cuda),
                       0)


def _res_state(sub, cuda):
    from repro_torch.core import resilience as res
    from repro_torch.train.step import TrainState

    lay = sub.transform.plan.packed()
    gen = torch.Generator(device=cuda).manual_seed(3)
    theta = torch.where(_valid(lay, cuda),
                        torch.randn(lay.q_packed, generator=gen, device=cuda),
                        0)
    return TrainState(theta, sub.init_rbd_state(),
                      sub.init_opt_state(device=cuda), 0,
                      res.guard_init(cuda) if sub.guard is not None else ())


def _res_drive(sub, cuda, state, keys, monitor=None):
    from repro_torch.train.step import TrainState

    for key in keys:
        p, r, o, aux = sub.step(state.params, _res_grads(sub, cuda, key),
                                state.rbd_state, state.opt_state,
                                state.guard)
        state = TrainState(p, r, o, state.step + 1,
                           aux.guard if sub.guard is not None else ())
        if monitor is not None:
            metrics = {"guard_reason": aux.reason,
                       "guard_lr_scale": aux.guard.lr_scale,
                       "replay_coords": aux.coords}
            if not isinstance(aux.row_sq, tuple):
                metrics["replay_row_sq"] = aux.row_sq
            monitor.observe(state, metrics)
    return state


def _res_leaves_equal(a, b):
    from repro_torch.core import resilience as res

    la, lb = res._tree_leaves(a), res._tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_guarded_healthy_step_is_the_unguarded_step(cuda):
    guarded = _res_sub()
    plain = _res_sub(guarded=False, capture=False)
    rbd_step.reset_counts()
    s_g = _res_drive(guarded, cuda, _res_state(guarded, cuda), range(3))
    assert rbd_step.LAUNCHES["project_packed"] == 3
    assert rbd_step.LAUNCHES["reconstruct_apply_packed"] == 3
    s_p = _res_drive(plain, cuda, _res_state(plain, cuda), range(3))
    assert torch.equal(s_g.params, s_p.params)
    assert _res_leaves_equal(s_g.opt_state, s_p.opt_state)
    assert float(s_g.guard.lr_scale) == 1.0
    assert int(s_g.guard.nonfinite_count) == 0


def test_nonfinite_step_rejected_with_theta_untouched(cuda):
    from repro_torch.core import resilience as res

    sub = _res_sub()
    state = _res_drive(sub, cuda, _res_state(sub, cuda), range(1))
    g = _res_grads(sub, cuda, 1)
    g[3] = float("nan")
    p, r, o, aux = sub.step(state.params, g, state.rbd_state,
                            state.opt_state, state.guard)
    assert torch.equal(p, state.params)
    assert _res_leaves_equal(o, state.opt_state)
    assert int(aux.reason) == res.REASON_NONFINITE_LOCAL
    assert int(aux.guard.nonfinite_count) == 1
    assert float(aux.guard.lr_scale) == 0.5 and r.step == 2


@pytest.mark.parametrize("mode,k", [("shared_basis", 1),
                                    ("independent_bases", 3)])
def test_resume_is_bit_exact_on_the_card(cuda, tmp_path, mode, k):
    """5 steps against crash before step 4, snapshot 3 + 1 replayed
    record: theta, adam state and guard state bit for bit; the replay is
    one apply launch (the K-worker one, row 3, in the joint subspace) and
    no projection."""
    from repro_torch.core import resilience as res

    sub = _res_sub(mode, k)
    apply = ("reconstruct_apply_packed_workers" if k > 1
             else "reconstruct_apply_packed")
    ref = _res_drive(sub, cuda, _res_state(sub, cuda), range(5))
    cfg = res.ResilienceConfig(directory=str(tmp_path), snapshot_every=3,
                               guard=res.GuardConfig())
    monitor = res.ResilienceMonitor(cfg, sub)
    _res_drive(sub, cuda, _res_state(sub, cuda), range(4), monitor)
    monitor.log.close()
    rbd_step.reset_counts()
    recovered, info = res.recover(cfg, sub, _res_state(sub, cuda))
    assert (info["snapshot_step"], info["replayed"]) == (3, 1)
    assert rbd_step.LAUNCHES[apply] == 1
    assert rbd_step.LAUNCHES["project_packed"] == 0
    assert recovered.params.device.type == cuda.type
    done = _res_drive(sub, cuda, recovered, range(4, 5))
    assert torch.equal(done.params, ref.params)
    assert _res_leaves_equal(done.opt_state, ref.opt_state)
    assert _res_leaves_equal(done.guard, ref.guard)


# ---------------------------------------------------------------------------
# the basis layer: the materialized products and L-BFGS on the card
# ---------------------------------------------------------------------------


def _materialized_plan():
    return compartments.make_plan({"w": (640, 33), "layers/k": (3, 700, 10),
                                   "s": ()}, 40,
                                  is_stacked=lambda n: n.startswith("layers"))


def test_materialized_basis_on_the_card(cuda):
    """The card's basis has the CPU's properties: rows orthonormal within
    1e-5, padding columns exactly zero, the same seed the same bits."""
    plan = _materialized_plan()
    layout = plan.packed()
    basis = projector.materialize_random_basis(plan, layout, 7, device=cuda)
    assert basis.device.type == cuda.type
    assert basis.shape == (plan.total_dim, layout.q_packed)
    gram = (basis.double() @ basis.double().T).cpu()
    assert float((gram - torch.eye(plan.total_dim,
                                   dtype=torch.float64)).abs().max()) <= 1e-5
    assert bool((basis[:, ~_valid(layout, cuda)] == 0).all())
    assert torch.equal(basis, projector.materialize_random_basis(
        plan, layout, 7, device=cuda))


def test_materialized_products_match_the_cpu(cuda):
    """``project_materialized`` and ``reconstruct_apply_materialized`` on
    the card against the same products on the CPU: within 1e-5 of the
    largest magnitude (float32 sums in another order; TF32 off)."""
    plan = _materialized_plan()
    layout = plan.packed()
    basis = projector.materialize_random_basis(plan, layout, 3, device="cpu")
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(layout.q_packed, generator=gen)
    theta = torch.randn(layout.q_packed, generator=gen)
    c = torch.randn(plan.total_dim, generator=gen)
    u_cpu = projector.project_materialized(basis, g)
    u = projector.project_materialized(basis.to(cuda), g.to(cuda)).cpu()
    assert float((u - u_cpu).abs().max()) <= 1e-5 * float(
        u_cpu.abs().max())
    new_cpu = projector.reconstruct_apply_materialized(c, basis, theta, 0.3)
    new = projector.reconstruct_apply_materialized(
        c.to(cuda), basis.to(cuda), theta.to(cuda), 0.3).cpu()
    assert float((new - new_cpu).abs().max()) <= 1e-5 * float(
        (new_cpu - theta).abs().max()) + 2 * 2.0 ** -23 * float(
        theta.abs().max())


@pytest.mark.parametrize("name", ["lbfgs", "newton", "chain"])
def test_second_order_on_the_card_matches_the_cpu(cuda, name):
    """14 steps of L-BFGS (history 4, so the ring wraps; two repeated
    gradients skip their pairs), BFGS and clip -> lbfgs -> cosine schedule
    on the card against the CPU: every output and state field within 1e-4
    of its largest magnitude."""
    from repro_torch.optim import transforms as opt

    def make():
        if name == "lbfgs":
            return opt.lbfgs(4, 0.05)
        if name == "newton":
            return opt.newton(0.05)
        return opt.chain(opt.clip_by_global_norm(30.0), opt.lbfgs(4, 0.05),
                         opt.schedule("cosine", total_steps=10,
                                      warmup_steps=3))

    rs = np.random.default_rng(0)
    qm, _ = np.linalg.qr(rs.standard_normal((24, 24)))
    h = (qm * np.logspace(0, 1.5, 24)) @ qm.T
    x = rs.standard_normal(24)
    tr_cpu, tr_gpu = make(), make()
    st_cpu = tr_cpu.init(torch.zeros(24))
    st_gpu = tr_gpu.init(torch.zeros(24, device=cuda))
    prev = None
    for k in range(14):
        g = prev if k in (4, 9) else torch.from_numpy(
            (h @ x).astype(np.float32))
        prev = g
        x = x - 0.05 * g.numpy()
        u_cpu, st_cpu = tr_cpu.update(g, st_cpu)
        u_gpu, st_gpu = tr_gpu.update(g.to(cuda), st_gpu)
        for a, b in zip([u_cpu] + opt.leaves(st_cpu),
                        [u_gpu] + opt.leaves(st_gpu)):
            b = b.cpu()
            assert a.dtype == b.dtype and a.shape == b.shape
            if not a.is_floating_point():
                assert torch.equal(a, b)
                continue
            tol = 1e-4 * max(float(a.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= tol, (name, k)


# -- the encoder-decoder and the paper's image models -----------------------

# whisper's encoder (6 / 6 heads of 64 over 1,500 frames: the last 128-row
# query and key tiles ragged), batch 2, and the cross-attention's shape (a
# few decoder positions on the 1,500 encoder keys); non-causal, (B, Sq, Sk)
ENC_FLASH_CASES = [(1, 1500, 1500), (2, 1500, 1500), (2, 40, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ENC_FLASH_CASES,
                         ids=[f"{b}x{sq}x{sk}" for b, sq, sk in
                              ENC_FLASH_CASES])
def test_flash_attention_encoder_shape(cuda, case, dtype):
    """Non-causal at the encoder's heads: bf16 through the tensor-core
    kernel within _flash_close_p_bf16 of its plain version, f32 through
    the CUDA-core one within _flash_close; reruns bit-identical."""
    from repro_torch.kernels import flash_attention as flash

    b, sq, sk = case
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, sq, 6, 64), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, 6, 64), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    kernel = flash.kernel_for(dtype, 64)
    key = f"flash_attention[{kernel}]"
    before = rbd_step.VARIANT_LAUNCHES.get(key, 0)
    out = flash.flash_attention(q, k, v, causal=False)
    again = flash.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert rbd_step.VARIANT_LAUNCHES.get(key, 0) == before + 2
    assert torch.equal(out, again)
    ref, l = flash.flash_attention_plain(q, k, v, causal=False,
                                         p_dtype=flash.P_DTYPE[kernel],
                                         return_l=True)
    if kernel == "wgmma":
        assert _flash_close_p_bf16(out, ref, l, v)
    else:
        assert _flash_close(out, ref, v)


@pytest.mark.parametrize("name,shape", [("fc", (14, 14, 1)),
                                        ("cnn", (32, 32, 3)),
                                        ("resnet8", (32, 32, 3))])
def test_rbd_gradient_on_the_kernels_matches_torch(cuda, name, shape):
    """The image models' RBD sketch (``rbd_gradient``, make_plan(params,
    128)) through the per-leaf kernels against the torch backend on the
    same gradient: each leaf within 1e-4 of its largest value (phase 12's
    reconstruct tolerance; the coordinates' 2e-5 is below it), one
    ``project_flat`` and one ``reconstruct_flat`` launch a leaf."""
    from repro_torch.data import synthetic
    from repro_torch.models import vision

    init, apply = vision.get_vision_model(name)
    params = {k: v.requires_grad_(True)
              for k, v in init(0, shape, device=cuda).items()}
    plan = compartments.make_plan(params, 128)
    x, y = next(synthetic.mixture_dataset(0, 16, shape=shape, device=cuda))
    loss = torch.nn.functional.cross_entropy(apply(params, x), y)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    seed = rng.fold_seed(0, 0)
    before = dict(rbd_step.LAUNCHES)
    got = projector.rbd_gradient(grads, plan, seed, backend="cuda")
    torch.cuda.synchronize()
    n = len(plan.leaves)
    for k in ("project_flat", "reconstruct_flat"):
        assert rbd_step.LAUNCHES[k] == before.get(k, 0) + n
    want = projector.rbd_gradient(grads, plan, seed, backend="torch")
    for k, w in want.items():
        tol = 1e-4 * float(w.abs().max())
        assert float((got[k] - w).abs().max()) <= tol, k


def test_encdec_on_the_card_matches_the_cpu(cuda):
    """whisper-tiny at the reduced size, f32 compute: the encoder through
    the flash kernel (CUDA-core at head size 32), the cross cache and 4
    decode steps on the card against the same on the CPU (the plain
    versions), within 1e-4 of the largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, frontends
    from repro_torch.models.registry import get_model

    cfg = get_config("whisper-tiny").reduced(compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    frames = frontends.audio_frames(cfg, 2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 4)))
    outs = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        with torch.no_grad():
            cache = encdec.prefill_cross_cache(
                cfg, p, model.init_cache(2, 4, device=dev), frames.to(dev))
            logits = [model.decode_step(p, cache, toks[:, i:i + 1].to(dev))[0]
                      for i in range(4)]
        outs[str(dev)] = [cache["xk"].cpu(), torch.cat(logits, 1).cpu()]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


# ---------------------------------------------------------------------------
# the kernels as torch.library ops
# ---------------------------------------------------------------------------


def test_kernel_ops_launch_as_the_direct_launch(cuda):
    """A kernel's op (the wrappers' path) and its launch function called
    directly give the same bits and one launch each; the op on meta
    tensors gives the shapes and dtypes and launches nothing; on a CPU
    tensor it has no kernel."""
    plan, lay = _layout("normal")
    seeds = rbd_step._seeds_on(projector.segment_seeds(plan, rng.fold_seed(5)),
                               lay.n_segments, cuda)
    t = rbd_step._device_tables(lay, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn(lay.q_packed, generator=gen, device=cuda)
    scale = torch.randn(lay.d_packed, generator=gen, device=cuda)
    pargs = (g, seeds, t["size"], t["param_off"], t["coord_off"],
             t["n_chunk"], t["proj_blocks"], lay.n_segments,
             t["n_proj_blocks"], lay.pos_block, lay.d_packed, 0, 0, 0)
    before = rbd_step.LAUNCHES["project_packed"]
    via_op = torch.ops.repro_torch.project_packed(*pargs)
    direct = rbd_step.LAUNCH_FNS["project_packed"](*pargs)
    assert rbd_step.LAUNCHES["project_packed"] == before + 2
    for a, b in zip(via_op, direct):
        assert torch.equal(a, b)
    outs = []
    for fn in (torch.ops.repro_torch.reconstruct_apply_packed,
               rbd_step.LAUNCH_FNS["reconstruct_apply_packed"]):
        out = torch.empty_like(g)
        fn(scale, g, out, seeds, t["size"], t["pdim"], t["param_off"],
           t["coord_off"], t["recon_blocks"], lay.n_segments,
           t["n_recon_blocks"], lay.pos_block, t["max_ndb"], 0, 0, 0)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    meta = [x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in pargs]
    n = rbd_step.LAUNCHES["project_packed"]
    u, sq = torch.ops.repro_torch.project_packed(*meta)
    assert rbd_step.LAUNCHES["project_packed"] == n
    assert (u.device.type, tuple(u.shape), u.dtype) == (
        "meta", tuple(via_op[0].shape), via_op[0].dtype)
    cpu = [x.cpu() if isinstance(x, torch.Tensor) else x for x in pargs]
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.project_packed(*cpu)
