"""Partitioning rules: parameter, batch and cache specs for the
``(data, model)`` layouts (port of ``repro.sharding.rules``).

Mesh axes: ``("data", "model")``, or ``("pod", "data", "model")`` with
``pod`` pure data parallelism.  ``model`` carries tensor / expert
parallelism: parameters are Megatron-style sharded -- column-parallel
in-projections, row-parallel out-projections, experts over ``model``,
embeddings over the vocabulary.

A spec is a plain tuple with the entries the reference's
``PartitionSpec`` holds, one per tensor dimension: ``None``
(replicated), ``"model"``, or the batch axes (a bare name for one axis,
a tuple for several, as ``PartitionSpec`` keeps them).  The replicated
spec is ``()``.  Rules are (regex over the leaf name) -> the index of the
dimension sharded over ``model``; a dimension is sharded only if the
model-axis size divides it (else the leaf is replicated), and attention
projections only on whole heads.  Parameters are the port's flat
``{leaf name: shape or tensor}`` maps, named as the reference flattens
its tree (``layers/attn/wq``).  A mesh is a ``{"data": D, "model": M}``
mapping or a :class:`repro_torch.launch.mesh.Mesh`.

The rules are a pure function of leaf names and shapes; nothing here
touches a device.  On the model-sharded packed route the parameters
live as one padded packed buffer instead, cut into slabs
(:func:`packed_slab_spec`).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

Spec = tuple

# leaf-name regex -> index of the dimension to shard over "model"
# (negative indices count from the right; None: replicated)
_PARAM_RULES: list[tuple[str, int | None]] = [
    (r".*embed$", 0),                   # (V, D): vocab-sharded
    (r".*dec_pos$", -1),
    # rwkv's channel mix carries wk/wv names too but is an MLP: its
    # hidden (F) axis is sharded both ways
    (r".*cmix/wk$", -1),                # (D, F)
    (r".*cmix/wv$", -2),                # (F, D): row parallel
    (r".*(wq|wk|wv)$", -1),             # (.., D, H*hd): column parallel
    (r".*(bq|bk|bv)$", -1),
    (r".*wo$", -2),                     # (.., H*hd, D): row parallel
    (r".*(w_up|w_gate)$", -1),          # (.., D, F)
    (r".*w_down$", -2),                 # (.., F, D)
    (r".*moe/(w_up|w_gate|w_down)$", -3),  # (L, E, .., ..): experts
    (r".*moe/router$", None),           # tiny, replicated
    (r".*(wr|wg)$", -1),                # rwkv in-projections
    (r".*w_decay_a$", -1),
    (r".*w_decay_b$", -2),
    (r".*w_in$", -1),                   # mamba in-projection
    (r".*w_out$", -2),
    (r".*conv_w$", -1),
    (r".*lm_head$", -1),                # (D, V)
    (r".*fc1/w$", -1),
]

# attention projections shard on whole heads only: below head granularity
# a sharded feature axis of Q/K/V turns every attention score block into a
# partial sum that needs a collective
_Q_HEAD_RULES = re.compile(r".*(wq|bq)$")
_KV_HEAD_RULES = re.compile(r".*(wk|wv|bk|bv)$")
_O_HEAD_RULES = re.compile(r".*wo$")

# Below this parameter count a model trains as pure data parallelism:
# parameters replicated, the batch sharded over data x model, no
# tensor-parallel collective.  Above it, Megatron-style over "model".
PURE_DP_MAX_PARAMS = 1_200_000_000


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a mapping or a ``launch.mesh.Mesh``."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {"data": int(mesh.data_size), "model": int(mesh.model_size)}


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", leaf))


def _head_divisible(name: str, heads, model_size: int) -> bool:
    if heads is None or "cmix/" in name:   # rwkv channel mix is an MLP
        return True
    n_heads, n_kv = heads
    if _Q_HEAD_RULES.match(name) or _O_HEAD_RULES.match(name):
        return n_heads % model_size == 0
    if _KV_HEAD_RULES.match(name):
        return n_kv % model_size == 0
    return True


def _spec_for(name: str, ndim: int, shape, model_size: int,
              heads=None) -> Spec:
    """The spec of one leaf: the first rule whose pattern matches."""
    for pattern, dim in _PARAM_RULES:
        if re.match(pattern, name):
            if dim is None:
                return ()
            d = dim % ndim
            if shape[d] % model_size != 0:
                return ()  # indivisible -> replicate
            if not _head_divisible(name, heads, model_size):
                return ()
            axes: list[Any] = [None] * ndim
            axes[d] = "model"
            return tuple(axes)
    return ()


def layout_policy(params_shape: Mapping[str, Any], cfg=None) -> str:
    """``"pure_dp"`` up to :data:`PURE_DP_MAX_PARAMS` parameters, else
    ``"megatron"``."""
    del cfg
    n = sum(int(np.prod(_shape(x), dtype=np.int64))
            for x in params_shape.values())
    return "pure_dp" if n <= PURE_DP_MAX_PARAMS else "megatron"


def param_specs(params_shape: Mapping[str, Any], mesh, cfg=None) -> dict:
    """``{leaf name: spec}`` for a parameter map of shapes (or tensors).
    ``cfg`` (a ``ModelConfig``) enables the whole-head rule."""
    if layout_policy(params_shape, cfg) == "pure_dp":
        return {name: () for name in params_shape}
    model_size = mesh_shape(mesh).get("model", 1)
    heads = (cfg.n_heads, cfg.n_kv_heads) if cfg is not None else None
    out = {}
    for name, leaf in params_shape.items():
        shape = _shape(leaf)
        out[name] = _spec_for(name, len(shape), shape, model_size, heads)
    return out


def sharded_dim(spec: Spec) -> int | None:
    """The dimension a parameter spec puts on ``"model"``, or None."""
    return spec.index("model") if "model" in spec else None


def packed_slab_spec(model_axis: str = "model") -> Spec:
    """Spec of the padded packed theta buffer on the model-sharded packed
    route: ``q_padded = n_shards * q_slab``, so it tiles onto the slabs."""
    return (model_axis,)


def batch_axes(mesh, layout: str = "megatron") -> tuple:
    """The mesh axes that jointly shard the batch dimension; under the
    pure_dp layout the ``model`` axis carries batch too."""
    names = _axis_names(mesh)
    axes = ("pod", "data") if "pod" in names else ("data",)
    if layout == "pure_dp" and "model" in names:
        axes = axes + ("model",)
    return axes


def _axes_entry(axes: tuple):
    """A spec entry naming ``axes``: the bare name for one axis (as
    ``PartitionSpec`` keeps it), else the tuple."""
    return axes[0] if len(axes) == 1 else axes


def batch_specs(batch_shape: Mapping[str, Any], mesh,
                layout: str = "megatron") -> dict:
    """Shard the leading (batch) dimension of every input leaf."""
    baxes = batch_axes(mesh, layout)
    sizes = mesh_shape(mesh)
    bsize = int(np.prod([sizes[a] for a in baxes]))

    def spec(leaf):
        shape = _shape(leaf)
        if shape and shape[0] % bsize == 0:
            return (_axes_entry(baxes),) + (None,) * (len(shape) - 1)
        return ()

    return {name: spec(leaf) for name, leaf in batch_shape.items()}


def cache_specs(cache_shape: Mapping[str, Any], mesh) -> dict:
    """KV / state caches: the batch axis over data (+pod), the kv heads
    (or, for MQA, the sequence axis) over model.  Attention caches are
    (L, B, S, KV, hd), recurrent states (L, B, ...)."""
    baxes = batch_axes(mesh)
    sizes = mesh_shape(mesh)
    bsize = int(np.prod([sizes[a] for a in baxes]))
    msize = sizes.get("model", 1)

    def spec(name, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return ()
        axes: list[Any] = [None] * nd
        if nd >= 2 and shape[1] % bsize == 0:
            axes[1] = _axes_entry(baxes)
        if name.endswith(("k", "v")) and nd == 5:
            if shape[3] % msize == 0:       # kv heads
                axes[3] = "model"
            elif shape[2] % msize == 0:     # MQA: shard sequence
                axes[2] = "model"
        elif nd >= 4 and shape[2] % msize == 0:
            axes[2] = "model"               # recurrent: heads axis
        return tuple(axes)

    return {name: spec(name, leaf) for name, leaf in cache_shape.items()}
