"""The port's partitioning rules (``repro_torch.sharding.rules``) against
the reference's (``repro.sharding.rules``) on every leaf of all ten
configs at full size: leaf names and shapes from the reference's
``jax.eval_shape`` (nothing allocated), model-axis sizes 2, 4 and 16.
The reference takes a stand-in mesh whose ``.shape`` is a dict; a
``PartitionSpec`` is compared as the tuple of its entries."""

from __future__ import annotations

import functools
import types

import jax
import pytest

from repro.configs import get_config as ref_config
from repro.models import get_model as ref_get_model
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.models.registry import get_model
from repro_torch.sharding import rules

MODEL_SIZES = (2, 4, 16)


def _named(tree):
    """A nested dict of arrays -> ``{"a/b/c": leaf}`` in tree order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


@functools.cache
def _ref_shapes(arch):
    cfg = ref_config(arch)
    model = ref_get_model(cfg)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _ref_mesh(data, model, pod=None):
    shape = {"data": data, "model": model}
    if pod is not None:
        shape = {"pod": pod, **shape}
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _named_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_param_specs_equal_reference(arch):
    """``param_specs``, ``layout_policy`` and every leaf's ``_spec_for``
    at model sizes 2, 4 and 16; the port's leaves are the reference's."""
    shapes = _ref_shapes(arch)
    named = {k: tuple(v.shape) for k, v in _named(shapes).items()}
    cfg = get_config(arch)
    assert get_model(cfg).param_shapes() == named
    rcfg = ref_config(arch)
    assert rules.layout_policy(named, cfg) == ref_rules.layout_policy(
        shapes, rcfg)
    heads = (cfg.n_heads, cfg.n_kv_heads)
    for m in MODEL_SIZES:
        want = {k: tuple(v) for k, v in _named_specs(
            ref_rules.param_specs(shapes, _ref_mesh(1, m), rcfg)).items()}
        got = rules.param_specs(named, {"data": 1, "model": m}, cfg)
        assert got == want
        for name, shape in named.items():
            assert rules._spec_for(name, len(shape), shape, m, heads) == \
                tuple(ref_rules._spec_for(name, len(shape), shape, m, heads))


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_megatron_specs_never_shard_the_stacked_axis(arch):
    """Every config's specs under the megatron layout (forced by a
    threshold of 0) at model sizes 2, 4 and 16: a stacked (layer) leaf is
    never sharded on its leading (L,) axis, so a leaf shard never owns
    whole compartments (the projector's docstring relies on it)."""
    cfg = get_config(arch)
    model = get_model(cfg)
    named = model.param_shapes()
    for m in MODEL_SIZES:
        specs = {k: rules._spec_for(k, len(s), s, m,
                                    (cfg.n_heads, cfg.n_kv_heads))
                 for k, s in named.items()}
        for name, spec in specs.items():
            if model.is_stacked(name) and spec:
                assert rules.sharded_dim(spec) != 0, (name, spec)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-1.6b",
                                  "mixtral-8x7b", "zamba2-2.7b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("pod", [None, 2])
def test_batch_and_cache_specs_equal_reference(arch, pod):
    """``batch_axes``, ``batch_specs`` (both layouts, every input shape
    of the catalog) and ``cache_specs`` against the reference's."""
    rcfg = ref_config(arch)
    rmodel = ref_get_model(rcfg)
    model = get_model(get_config(arch))
    for data, m in ((2, 4), (4, 16), (16, 16)):
        rmesh = _ref_mesh(data, m, pod)
        mesh = dict(rmesh.shape)
        for layout in ("megatron", "pure_dp"):
            assert rules.batch_axes(mesh, layout) == ref_rules.batch_axes(
                rmesh, layout)
            for shape in INPUT_SHAPES.values():
                rspecs = rmodel.batch_specs(shape)
                want = {k: tuple(v) for k, v in ref_rules.batch_specs(
                    rspecs, rmesh, layout).items()}
                got = rules.batch_specs(
                    {k: s for k, (s, _) in model.batch_specs(shape).items()},
                    mesh, layout)
                assert got == want
        cache = jax.eval_shape(lambda: rmodel.init_cache(32, 256))
        want = {k: tuple(v) for k, v in _named_specs(
            ref_rules.cache_specs(cache, rmesh)).items()}
        got = rules.cache_specs({k: tuple(v.shape) for k, v in
                                 _named(cache).items()}, mesh)
        assert got == want
    assert rules.packed_slab_spec() == tuple(ref_rules.packed_slab_spec())


def test_the_launchers_mesh_gives_the_mappings_specs():
    """A ``launch.mesh.Mesh`` stands for its ``{"data": D, "model": M}``
    mapping."""
    import torch

    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(torch.device("cpu"), False, 0, 0, "data", None, 2, 16)
    assert rules.mesh_shape(mesh) == {"data": 2, "model": 16}
    cfg = get_config("mixtral-8x7b")
    shapes = get_model(cfg).param_shapes()
    assert rules.param_specs(shapes, mesh, cfg) == rules.param_specs(
        shapes, {"data": 2, "model": 16}, cfg)
    assert rules.batch_specs({"tokens": (32, 8)}, mesh, "pure_dp") == {
        "tokens": (("data", "model"), None)}
