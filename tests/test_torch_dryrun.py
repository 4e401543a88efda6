"""Port parity: the multi-pod dry run (``repro_torch.launch.dryrun``).

* ``model_flops`` and ``should_skip`` equal the reference's for every
  arch x input shape (the reference side through ``jax.eval_shape``).
* The printed update path equals the reference's ``_print_update_path``
  line for line for the same plans.
* One full-width dry run (qwen2-0.5b, train_4k, sharedseed, 16x16 fake
  world) ends on this CPU-only box: two kernel calls, one non-scalar
  coordinate all-reduce of the plan's d, the loss's scalar, and the
  process's resident memory grows by less than 1 GB.
* The fake world and the meta device: the mesh's groups, no CUDA, and
  ``resolve_device("cuda")`` still raises.
* The megatron route (a model group cutting packed slabs), prefill and
  decode builders at a reduced size.
"""

import contextlib
import io
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib

ARCHS = ["gemma3-4b", "granite-34b", "llava-next-mistral-7b",
         "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-0.5b",
         "rwkv6-1.6b", "tinyllama-1.1b", "whisper-tiny", "zamba2-2.7b"]


def _ref_dryrun():
    """The reference's dry-run module, imported without its process-wide
    512-device flag (it sets XLA_FLAGS at import; the tests run on the
    one real CPU device)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def test_arch_list_is_the_references():
    from repro.configs import ARCH_IDS as REF_IDS
    from repro_torch.configs import ARCH_IDS

    assert sorted(ARCH_IDS) == sorted(REF_IDS) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_should_skip_equal_reference(arch):
    from repro.configs import INPUT_SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro_torch.configs import INPUT_SHAPES, get_config

    ref = _ref_dryrun()
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert sorted(INPUT_SHAPES) == sorted(REF_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dryrun.should_skip(cfg, shape) == ref.should_skip(
            rcfg, REF_SHAPES[name]), name
        assert dryrun.model_flops(cfg, shape) == ref.model_flops(
            rcfg, REF_SHAPES[name]), name


@pytest.mark.parametrize("case", ["momentum", "adam", "guard"])
def test_kernel_calls_equal_reference_pallas_calls(case):
    """The kernel-call parity cases of tests/test_torch_hlo_analysis.py
    that this file runs, to keep each file's time near half the two's."""
    import test_torch_hlo_analysis as hlo

    assert case in hlo.CASES and case not in hlo.HERE
    hlo.check_kernel_calls(case)


# ---------------------------------------------------------------------------
# the printed update path
# ---------------------------------------------------------------------------

PLANS = {
    "sharedseed_sgd": dict(axis_name="data"),
    "independent_bases": dict(axis_name="data", k_workers=4,
                              rbd=dict(mode="independent_bases")),
    "exact_adam": dict(axis_name="data", optimizer="adam",
                       rbd=dict(normalization="exact")),
    "guard_sentinel": dict(axis_name="data", guard=True, sentinel_every=2),
    "accum_2": dict(axis_name="data", n_accum=2),
    "per_leaf": dict(axis_name="data", rbd=dict(packed="off")),
    "pjit": dict(model_sharded=True),
    "model_axis_exact": dict(axis_name="data", model_sharded=True,
                             model_axis="model", model_shards=2,
                             rbd=dict(normalization="exact")),
    "prng_hw": dict(axis_name="data", rbd=dict(prng_impl="hw")),
    "rbd_off": dict(rbd=dict(enabled=False)),
    "trajectory_pca": dict(axis_name="data",
                           rbd=dict(basis="trajectory_pca")),
}


def _sub_opt(pkg: str, case: dict):
    """The optimizer of one plan in either package (``pkg``: ``repro`` or
    ``repro_torch``), at the reduced qwen2-0.5b."""
    import importlib

    cfgs = importlib.import_module(pkg + ".configs")
    base = importlib.import_module(pkg + ".configs.base")
    models = importlib.import_module(
        pkg + (".models" if pkg == "repro" else ".models.registry"))
    steplib = importlib.import_module(pkg + ".train.step")
    res_lib = importlib.import_module(pkg + ".core.resilience")
    cfg = cfgs.get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    model = models.get_model(cfg)
    backend = "pallas" if pkg == "repro" else "cuda"
    rbd = dict(total_dim=256, backend=backend, packed="on")
    rbd.update(case.get("rbd", {}))
    tcfg = base.TrainConfig(model=cfg, rbd=base.RBDConfig(**rbd),
                            optimizer=case.get("optimizer", "sgd"),
                            learning_rate=0.5,
                            grad_accum_steps=case.get("n_accum", 1))
    res = None
    if case.get("guard") or case.get("sentinel_every"):
        res = res_lib.ResilienceConfig(
            guard=res_lib.GuardConfig() if case.get("guard") else None,
            sentinel_every=case.get("sentinel_every", 0))
    kw = {k: case[k] for k in ("model_sharded", "model_axis",
                               "model_shards", "k_workers") if k in case}
    if pkg == "repro_torch":
        kw["device"] = "meta"
    return steplib.make_subspace_optimizer(
        model, tcfg, None, case.get("axis_name"), resilience=res, **kw)


@pytest.mark.parametrize("case", list(PLANS))
def test_update_path_lines_equal_reference(case):
    ref = _ref_dryrun()
    n_accum = PLANS[case].get("n_accum", 1)
    want, got = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        ref._print_update_path(_sub_opt("repro", PLANS[case]), n_accum)
    with contextlib.redirect_stdout(got):
        dryrun._print_update_path(_sub_opt("repro_torch", PLANS[case]),
                                  n_accum)
    assert got.getvalue().splitlines() == want.getvalue().splitlines()
    assert "update path [" in got.getvalue()


# ---------------------------------------------------------------------------
# the full-width dry run
# ---------------------------------------------------------------------------


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _ref_plan_d_packed(arch: str) -> int:
    """d_packed of the reference's plan for ``arch`` at the default
    RBDConfig, from the shapes alone: every compartment's dim padded to
    the dir-block of 8 (the reference's ``PackedLayout`` itself builds
    tables over every position, minutes and tens of GB at full width)."""
    from repro.configs import get_config
    from repro.configs.base import RBDConfig
    from repro.models import get_model
    from repro.train import step as steplib

    model = get_model(get_config(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    plan = steplib.make_plan(model, RBDConfig(), shapes)
    return sum(lp.n_stack * -(-lp.dim // 8) * 8 for lp in plan.leaves)


def test_full_width_sharedseed_dry_run(tmp_path):
    from repro_torch.models.registry import resolve_device

    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device("cuda")
    peak = [_rss()]
    base = peak[0]
    done = threading.Event()

    def sample():
        while not done.wait(0.05):
            peak[0] = max(peak[0], _rss())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        r = dryrun.run_one("qwen2-0.5b", "train_4k", mode="sharedseed",
                           out_dir=str(tmp_path))
    finally:
        done.set()
        th.join()
    assert peak[0] - base < 1 << 30, (peak[0] - base) / 2**20
    assert (tmp_path / "qwen2-0.5b_train_4k_16x16_sharedseed.json").exists()
    d = _ref_plan_d_packed("qwen2-0.5b")
    assert r["devices"] == 256 and r["mesh_axes"] == {"data": 256,
                                                      "model": 1}
    assert r["kernel_calls"] == {"project_packed": 1,
                                 "reconstruct_apply_packed": 1}
    # one non-scalar coordinate all-reduce of the plan's d, the loss's
    # scalar mean, nothing else
    assert [tuple(s) for s in r["collective_sites"]] == [("psum", d),
                                                        ("psum", 1)]
    assert r["collectives"] == {"all-reduce": 4.0 * (d + 1)}
    assert r["collective_bytes_per_device"] == 4.0 * (d + 1)
    assert r["hlo_loops"] == []
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    mem = r["memory_analysis"]
    # the arguments: the packed f32 theta (and the batch, two int64 rows)
    assert mem["argument_size_in_bytes"] > 4 * 494_000_000
    assert mem["temp_size_in_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    for k in ("t_compute", "t_memory", "t_collective", "trace_s",
              "useful_flops_ratio", "model_flops_global"):
        assert r[k] > 0, k
    assert not torch.cuda.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device("cuda")


def test_skip_combination_prints_reference_reason(tmp_path, capsys):
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("SKIP  qwen2-0.5b")
    assert "pure full-attention architecture" in out


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def test_fake_mesh_groups_match_init_mesh_layout():
    import torch.distributed as dist

    mesh = meshlib.init_fake_mesh(16, 16, rank=20)
    try:
        assert dist.get_world_size() == 256 and dist.get_rank() == 20
        assert (mesh.data_index, mesh.model_index) == (1, 4)
        assert dist.get_process_group_ranks(mesh.model_group) == list(
            range(16, 32))
        assert dist.get_process_group_ranks(mesh.data_group) == list(
            range(4, 256, 16))
        assert mesh.device == torch.device("meta")
        with pytest.raises(RuntimeError, match="already initialized"):
            meshlib.init_fake_mesh(2, 1)
    finally:
        meshlib.destroy_mesh(mesh)
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()


def _reduced(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    return get_model(get_config(arch).reduced(compute_dtype="float32"))


def test_megatron_route_packed_slabs(monkeypatch):
    """Above the pure_dp threshold (set to 0 here) sharedseed on 16x16
    runs over a 16-rank data axis, the packed theta cut into 16 slabs
    over the model group: the sharded kernels, one completion psum and
    one data-axis pmean of d, and the forward's slab all-gather."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import hlo_analysis
    from repro_torch.sharding import rules

    monkeypatch.setattr(rules, "PURE_DP_MAX_PARAMS", 0)
    model = _reduced("mixtral-8x7b")
    shape = InputShape("train_small", 32, 32, "train")
    dims = dryrun.production_mesh()
    assert dryrun._mesh_axes(dims, "megatron") == (16, 16)
    mesh = meshlib.init_fake_mesh(16, 16)
    try:
        fn, args = dryrun.build_train_inputs(model, shape, "sharedseed",
                                             mesh, mesh_dims=dims)
        tr = hlo_analysis.trace(fn, *args)
    finally:
        meshlib.destroy_mesh(mesh)
    assert tr.kernel_calls == ["project_packed_sharded",
                               "reconstruct_apply_packed_sharded"]
    sites = hlo_analysis._sites(tr)
    kinds = [k for k, n in sites if n > 1]
    assert kinds.count("psum") == 2 and kinds.count("all_gather") == 1
    # this rank's batch: 32 sequences over a data axis of 16
    assert tuple(args[1]["tokens"].shape) == (2, 32)


def test_prefill_and_decode_builders():
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import hlo_analysis

    model = _reduced("qwen2-0.5b")
    dims = dryrun.production_mesh(multi_pod=True)
    assert dryrun._mesh_axes(dims, "pure_dp") == (512, 1)
    assert dryrun._mesh_axes(dims, "megatron") == (32, 16)
    mesh = meshlib.init_fake_mesh(512, 1)
    try:
        fn, args = dryrun.build_prefill_inputs(
            model, InputShape("p", 64, 1024, "prefill"), mesh, dims)
        tr = hlo_analysis.trace(fn, *args)
    finally:
        meshlib.destroy_mesh(mesh)
    # 1,024 sequences over 512 ranks
    assert tuple(tr.result.shape) == (2, 64, model.cfg.vocab)
    assert tr.kernel_calls == [] and tr.collectives == []
    mesh = meshlib.init_fake_mesh(32, 16)
    try:
        fn, args = dryrun.build_decode_inputs(
            model, InputShape("d", 128, 64, "decode"), mesh, dims)
        tr = hlo_analysis.trace(fn, *args)
    finally:
        meshlib.destroy_mesh(mesh)
    logits, cache = tr.result
    # 64 sequences over the 32-rank data axis (pod x data)
    assert tuple(logits.shape)[:2] == (2, 1)
    assert tr.flops > 0
    specs = dryrun.shardings_for(model, InputShape("d", 128, 64, "decode"),
                                 dims)
    # pure_dp: no leaf cut; the 64 tokens do not divide over 512 ranks;
    # the cache's batch over pod x data, its kv heads over model
    assert set(specs) == {"params", "cache", "token"}
    assert all(s == () for s in specs["params"].values())
    assert specs["token"] == {"token": ()}
    assert specs["cache"]["k"][1] == ("pod", "data")
    assert np.isfinite(dryrun.roofline(tr)["t_memory"])


def test_chip_smoke_phase24_prediction_runs_on_the_cpu():
    """Phase 24 (a)'s prediction half is the dry run's machinery on meta
    tensors: it runs here, and predicts phase 4's two launches and its
    one coordinate all-reduce of d_packed plus the loss's scalar."""
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    pred = chip_smoke._dry_prediction()
    tr = pred["trace"]
    assert tr.kernel_calls == ["project_packed", "reconstruct_apply_packed"]
    assert [(c.primitive, c.elements) for c in tr.collectives] == [
        ("psum", pred["d"]), ("psum", 1)]
    assert tr.flops > 0 and tr.temp_bytes > 0
    assert tr.argument_bytes > 4 * 494_000_000
    assert not torch.cuda.is_initialized()
