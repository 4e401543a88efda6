"""Port parity: compartment plans, the packed layout (every ``pt_*``/
``rt_*`` tile table array-equal) and the segment seeds of
``repro_torch.core`` against ``repro.core``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import compartments as ref_comp
from repro.core import projector as ref_proj
from repro.core import rng as ref_rng
from repro.models import get_model as ref_model
from repro_torch.configs import get_config
from repro_torch.core import compartments, projector, rng
from repro_torch.models.registry import get_model

# One intra-op thread: the suite runs several test processes at once, and
# OpenMP threads spinning for work would slow every one of them down.
torch.set_num_threads(1)

LAYOUT_FIELDS = (
    "seg_leaf", "seg_layer", "seg_size", "seg_dim", "seg_psize", "seg_pdim",
    "seg_param_off", "seg_coord_off", "coord_valid", "coord_inv_sqrt_q",
    "param_valid", "pt_seg", "pt_row0", "pt_col0", "pt_gblk", "pt_ublk",
    "pt_init", "pt_q", "rt_seg", "rt_row0", "rt_col0", "rt_gblk", "rt_sblk",
    "rt_init", "rt_q")


def _named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_comp._leaf_name(p): leaf for p, leaf in flat}


def _ragged_params():
    # tests/test_packed_step.py's ragged case: 73 and 700 do not divide the
    # pos-block, "s" is a 1-element compartment, "layers/k" a stacked leaf
    return {"w": jnp.ones((64, 32)), "layers": {"k": jnp.ones((3, 40, 10))},
            "s": jnp.ones(()), "odd": jnp.ones((7, 73)),
            "long": jnp.ones((700,))}


def _assert_same_plan(ref_plan, plan):
    assert [dataclasses.asdict(lp) for lp in ref_plan.leaves] == [
        dataclasses.asdict(lp) for lp in plan.leaves]
    for f in ("total_dim", "total_params", "distribution", "normalization",
              "flatten", "pad"):
        assert getattr(ref_plan, f) == getattr(plan, f), f


def _assert_same_layout(ref_layout, layout):
    for f in ("pos_block", "dir_block", "n_segments", "q_packed", "d_packed",
              "n_proj_tiles", "n_recon_tiles"):
        assert getattr(ref_layout, f) == getattr(layout, f), f
    for f in LAYOUT_FIELDS:
        a, b = getattr(ref_layout, f), getattr(layout, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("arch,dim", [("qwen2-0.5b", 128),
                                      ("qwen2-0.5b", 1024),
                                      ("tinyllama-1.1b", 512)])
@pytest.mark.parametrize("pos_block", [512, 128])
def test_reduced_lm_plan_and_layout(arch, dim, pos_block):
    rcfg = ref_config(arch).reduced(compute_dtype="float32")
    rmodel = ref_model(rcfg)
    shapes = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    ref_plan = ref_comp.make_plan(shapes, dim, is_stacked=rmodel.is_stacked)
    model = get_model(get_config(arch).reduced(compute_dtype="float32"))
    assert {k: tuple(v.shape) for k, v in _named(shapes).items()} == \
        model.param_shapes()
    plan = compartments.make_plan(model.param_shapes(), dim,
                                  is_stacked=model.is_stacked)
    _assert_same_plan(ref_plan, plan)
    _assert_same_layout(ref_plan.packed(pos_block, 8),
                        plan.packed(pos_block, 8))


@pytest.mark.parametrize("kw", [
    dict(total_dim=96, is_stacked=lambda n: n.startswith("layers")),
    dict(total_dim=96, granularity="leaf", allocation="sqrt"),
    dict(total_dim=40, allocation="uniform",
         is_stacked=lambda n: n.startswith("layers")),
    dict(total_dim=48, granularity="global"),
    dict(total_dim=48, granularity="even", n_compartments=5),
], ids=["layer", "leaf-sqrt", "uniform", "global", "even"])
def test_ragged_stacked_flattened_layouts(kw):
    params = _ragged_params()
    ref_plan = ref_comp.make_plan(params, **kw)
    plan = compartments.make_plan(
        {k: tuple(v.shape) for k, v in _named(params).items()}, **kw)
    _assert_same_plan(ref_plan, plan)
    _assert_same_layout(ref_plan.packed(128, 8), plan.packed(128, 8))


@pytest.mark.parametrize("seed_parts", [(0,), (7,), (3, 41)])
def test_segment_seeds_equal(seed_parts):
    params = _ragged_params()
    kw = dict(total_dim=96, is_stacked=lambda n: n.startswith("layers"))
    ref_plan = ref_comp.make_plan(params, **kw)
    plan = compartments.make_plan(
        {k: tuple(v.shape) for k, v in _named(params).items()}, **kw)
    want = np.asarray(ref_proj.segment_seeds(ref_plan,
                                             ref_rng.fold_seed(*seed_parts)))
    got = rng.to_uint32(projector.segment_seeds(plan,
                                                rng.fold_seed(*seed_parts)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("granularity", ["layer", "even"])
def test_pack_unpack_matches_reference(granularity):
    rs = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rs.standard_normal(x.shape), jnp.float32),

        _ragged_params())
    kw = dict(total_dim=48, granularity=granularity, n_compartments=5,
              is_stacked=lambda n: n.startswith("layers"))
    ref_plan = ref_comp.make_plan(params, **kw)
    named = {k: torch.from_numpy(np.array(v))
             for k, v in _named(params).items()}
    plan = compartments.make_plan(named, **kw)
    want = np.asarray(ref_proj.pack_tree(params, ref_plan,
                                         ref_plan.packed(128, 8)))
    packed = projector.pack_tree(named, plan, plan.packed(128, 8))
    np.testing.assert_array_equal(packed.numpy(), want)
    back = projector.unpack_tree(packed, plan, plan.packed(128, 8), named)
    assert list(back) == compartments.leaf_order(named)
    for k, v in named.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
