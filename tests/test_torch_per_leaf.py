"""Port parity of the per-leaf path: ``projector.project``,
``reconstruct``, ``reconstruct_apply`` and ``rbd_gradient`` against the
reference's (jnp backend) for every normalization and a ``global``
flatten plan, on both port backends (``torch``: the tensor-shaped
generation; ``cuda``: the per-leaf kernels' plain versions on the CPU);
the per-leaf against the packed projection; the plan catalog of the
unpacked routes; and the launcher's printed plan block on them.

Tolerances (float32 sums in another order than XLA's): coordinates within
2e-5 of ||g_leaf|| * sqrt(sq / Q) per direction (scaled by the
normalization factor), updates and new parameters within 1e-4 of their
largest update + 2 ulp of the largest value; the per-leaf and packed
projections of the same plan agree to the coordinate tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.core import rng as ref_rng
from repro.optim import subspace as ref_subspace
from repro_torch.core import compartments, projector, rng
from repro_torch.kernels import rbd_step
from repro_torch.launch import train as launcher
from repro_torch.optim import subspace

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

EPS32 = 2.0 ** -23
# a plain leaf, a stacked leaf (3 compartments) and a scalar compartment
SHAPES = {"w": (64, 32), "layers/k": (3, 40, 10), "s": ()}


def _plans(norm, granularity="layer", dim=96):
    ref_tree = {}
    for name, shape in SHAPES.items():
        node = ref_tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    kw = dict(is_stacked=lambda n: n.startswith("layers"),
              normalization=norm, granularity=granularity)
    return (ref_comp.make_plan(ref_tree, dim, **kw),
            compartments.make_plan(SHAPES, dim, **kw))


def _nest(named):
    out = {}
    for name, v in named.items():
        node = out
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_comp._leaf_name(p): np.asarray(x) for p, x in flat}


def _inputs(seed):
    rs = np.random.default_rng(seed)
    return {k: rs.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(named):
    return {k: torch.from_numpy(np.array(v)) for k, v in named.items()}



def _assert_close(got: dict, want: dict, base: dict):
    for k in want:
        upd = np.abs(want[k] - base[k]).max() if base is not None else \
            np.abs(want[k]).max()
        ref_max = np.abs(base[k] if base is not None else want[k]).max()
        tol = 1e-4 * upd + 2 * EPS32 * ref_max
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=tol, err_msg=k)


@pytest.mark.parametrize("norm,granularity", [
    ("rsqrt_dim", "layer"), ("exact", "layer"), ("none", "layer"),
    ("orthonormal", "layer"), ("rsqrt_dim", "global")])
def test_per_leaf_api_vs_reference(norm, granularity):
    """The reference side: ``project`` and ``reconstruct`` with the
    projection's norms (together its ``rbd_gradient``) and, for 'exact',
    without them (the norms regenerated); its jnp ``reconstruct_apply`` is
    ``theta - eta * reconstruct``, computed here from the latter."""
    ref_plan, plan = _plans(norm, granularity)
    g, theta = _inputs(1), _inputs(2)
    rseed, seed = ref_rng.fold_seed(3), rng.fold_seed(3)
    ref_c, ref_sq = ref_proj.project(_nest(g), ref_plan, rseed,
                                     return_norms=True)
    ref_grad = _named(ref_proj.reconstruct(ref_c, ref_plan, rseed, _nest(g),
                                           row_sq=ref_sq))
    ref_rec = ref_grad if norm != "exact" else _named(ref_proj.reconstruct(
        ref_c, ref_plan, rseed, _nest(g)))
    ref_c = [np.asarray(c) for c in ref_c]
    ref_new = {k: theta[k] - np.float32(0.25) * ref_rec[k] for k in theta}
    for backend in ("torch", "cuda"):
        c, sq = projector.project(_torch(g), plan, seed, backend=backend,
                                  return_norms=True)
        for i, lp in enumerate(plan.leaves):
            gl = np.linalg.norm(
                projector._ravel_tree(_torch(g), plan).numpy()
                if plan.flatten else g[lp.name].reshape(lp.n_stack, -1),
                axis=-1, keepdims=True)
            want_sq = np.asarray(ref_sq[i])
            np.testing.assert_allclose(sq[i].numpy(), want_sq, rtol=2e-5)
            # the typical size of a raw coordinate, times the
            # normalization factor
            tol = 2e-5 * gl * np.sqrt(want_sq / lp.size)
            if norm == "rsqrt_dim":
                tol = tol / np.sqrt(lp.size)
            elif norm == "exact":
                tol = tol / np.sqrt(want_sq)
            assert (np.abs(c[i].numpy() - ref_c[i]) <= tol + 1e-7).all(), (
                backend, lp.name)
        got = projector.rbd_gradient(_torch(g), plan, seed, backend=backend)
        _assert_close(got, ref_grad, None)
        coords = [torch.from_numpy(np.array(x)) for x in ref_c]
        got = projector.reconstruct(coords, plan, seed, _torch(g),
                                    backend=backend)
        _assert_close(got, ref_rec, None)
        got = projector.reconstruct_apply(coords, plan, seed, _torch(theta),
                                          0.25, backend=backend)
        assert all(got[k].dtype == torch.float32 for k in got)
        _assert_close(got, ref_new, theta)


def test_one_launch_per_leaf_and_exact_regeneration():
    """The cuda backend calls each per-leaf wrapper once per LeafPlan --
    stacked leaves included -- and 'exact' without row norms regenerates
    them with one more projection per leaf."""
    _, plan = _plans("exact")
    g = _torch(_inputs(4))
    n = len(plan.leaves)
    rbd_step.reset_counts()
    coords = projector.project(g, plan, rng.fold_seed(1), backend="cuda")
    projector.reconstruct_apply(coords, plan, rng.fold_seed(1), g, 0.1,
                                backend="cuda")
    assert rbd_step.CALLS["project_flat"] == 2 * n
    assert rbd_step.CALLS["reconstruct_apply_flat"] == n
    assert rbd_step.CALLS["reconstruct_flat"] == 0
    rbd_step.reset_counts()
    coords, norms = projector.project(g, plan, rng.fold_seed(1),
                                      backend="cuda", return_norms=True)
    projector.reconstruct(coords, plan, rng.fold_seed(1), g,
                          backend="cuda", row_sq=norms)
    assert rbd_step.CALLS["project_flat"] == n
    assert rbd_step.CALLS["reconstruct_flat"] == n
    assert sum(rbd_step.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dist", ["normal", "sparse"])
def test_per_leaf_projection_equals_packed(dist):
    """Per-leaf seeds are the packed segment seeds: the per-leaf
    projection of a plan is the packed projection of the same plan,
    leaf by leaf, up to the order of the sums."""
    plan = compartments.make_plan(
        SHAPES, 120, is_stacked=lambda n: n.startswith("layers"),
        normalization="exact", distribution=dist)
    layout = plan.packed()
    g = _torch(_inputs(5))
    seeds = torch.cat([projector._leaf_seeds(rng.fold_seed(6), lp)
                       for lp in plan.leaves])
    assert torch.equal(seeds, projector.segment_seeds(plan, rng.fold_seed(6)))
    c, sq = projector.project(g, plan, rng.fold_seed(6), backend="cuda",
                              return_norms=True)
    pc, psq = projector.project_packed(g, plan, rng.fold_seed(6),
                                       backend="cuda", return_norms=True)
    for i, (a, b) in enumerate(zip(projector.unpack_coords(pc, plan, layout),
                                   c)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=plan.leaves[i].name)
    for a, b in zip(projector.unpack_coords(psq, plan, layout), sq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5)


def test_orthonormal_refuses_large_compartments():
    with pytest.raises(ValueError, match="compartmentalize"):
        projector._ortho_basis(rng.fold_seed(0), 300, (1 << 16,), "normal")
    b = projector._ortho_basis(rng.fold_seed(0), 6, (5, 7), "normal")
    np.testing.assert_allclose((b @ b.T).numpy(), np.eye(6), atol=1e-5)
    want = ref_proj._ortho_basis(ref_rng.fold_seed(0), 6, (5, 7), "normal")
    np.testing.assert_allclose(b.numpy(), np.asarray(want), atol=1e-5)


ROUTES = [
    dict(use_packed=False),
    dict(use_packed=False, axis_name="data"),
    dict(use_packed=False, normalization="exact"),
    dict(use_packed=True, weight_decay=0.01),
    dict(use_packed=False, weight_decay=0.01, axis_name="data"),
    dict(rbd_enabled=False),
    dict(rbd_enabled=False, axis_name="data"),
    dict(use_packed=False, mode="independent_bases", axis_name="data"),
    dict(use_packed=True, mode="independent_bases", axis_name="data",
         normalization="orthonormal"),
    dict(use_packed=False, mode="independent_bases", k_workers=2),
    dict(use_packed=True, normalization="orthonormal"),
    dict(use_packed=False, normalization="orthonormal", axis_name="data"),
]


@pytest.mark.parametrize("flags", ROUTES,
                         ids=[str(i) for i in range(len(ROUTES))])
@pytest.mark.parametrize("backend", ["kernels", "plain"])
def test_unpacked_routes_plan_like_reference(flags, backend):
    port = subspace.plan_from_flags(
        backend={"kernels": "cuda", "plain": "torch"}[backend], **flags)
    ref = ref_subspace.plan_from_flags(
        backend={"kernels": "pallas", "plain": "jnp"}[backend], **flags)
    assert port == ref
    assert port.strategy in ("fused_per_leaf", "coord_unfused",
                             "full_space")


LAUNCH = ["--arch", "qwen2-0.5b", "--reduced", "--data", "1", "--rbd-dim",
          "64", "--batch", "2", "--seq", "8", "--steps", "2", "--device",
          "cpu"]


@pytest.mark.parametrize("extra,flags", [
    ([], dict(use_packed=False, backend="jnp")),
    (["--packed", "off", "--rbd-backend", "cuda"],
     dict(use_packed=False, backend="pallas")),
    (["--weight-decay", "0.01", "--rbd-backend", "cuda"],
     dict(use_packed=True, backend="pallas", weight_decay=0.01)),
    (["--mode", "sgd"], dict(rbd_enabled=False, backend="jnp")),
])
def test_launcher_unpacked_routes_print_reference_plan(capsys, extra, flags):
    """The default invocation trains on ``coord_unfused``; ``--packed
    off``, ``--weight-decay`` and ``--mode sgd`` run too, each printing
    the reference's plan block, with one collective per step (the
    coordinate all-reduce) -- none for the SGD baseline on one rank,
    which runs with ``axis_name=None`` as the reference's launcher does
    for ``--mode sgd --data 1``."""
    rbd_step.reset_counts()
    res = launcher.main(LAUNCH + extra)
    lines = capsys.readouterr().out.splitlines()
    ref = ref_subspace.plan_from_flags(axis_name="data", k_workers=1,
                                       **flags)
    assert f"update path: {ref.strategy} -- {ref.reason}" in lines
    if flags.get("rbd_enabled", True):
        assert (f"exchange schedule: {ref.overlap_exchange} -- "
                f"{ref.overlap_reason}") in lines
        assert res.collectives["all_reduce"] == 2
        assert res.collectives["grad_all_reduce"] == 0
    else:
        assert not any(x.startswith("basis:") for x in lines)
        assert res.collectives["grad_all_reduce"] == 0
        assert res.collectives["all_reduce"] == 0
        assert res.collectives["scalar"] == 0
    assert res.collectives["all_gather"] == 0
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert isinstance(res.state.params, dict)
    assert launcher.params_sum(res.state.params) != res.theta_init_sum
    n = len(res.sub_opt.transform.plan.leaves) if res.sub_opt.transform \
        else 0
    calls = {k: v for k, v in rbd_step.CALLS.items() if v}
    if "--packed" in extra:
        assert calls == {"project_flat": 2 * n, "reconstruct_apply_flat": 2 * n}
    elif "--weight-decay" in extra:
        assert calls == {"project_flat": 2 * n, "reconstruct_flat": 2 * n}
    else:
        assert calls == {}
