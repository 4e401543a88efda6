"""Uniform model API (port of ``repro.models.registry``), plus the bridge
that carries the reference's parameters and optimizer state into the
port, and the leaf shards of pjit-style parameter sharding
(:class:`LeafShards`, :func:`leaf_shards`, :func:`shard_params`,
:func:`gather_params`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import encdec, transformer


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device


def _family(cfg: ModelConfig):
    """The module that builds ``cfg``'s model: ``encdec`` for the
    encoder-decoder, else ``transformer``."""
    return encdec if cfg.is_encoder_decoder else transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    forward: Callable            # (params, batch, shards=None)
                                 #   -> (logits, aux)
    init_cache: Callable         # (batch, max_len, *, device) -> cache
    decode_step: Callable        # (params, cache, token) -> (logits, cache)
    stacked_prefixes: tuple[str, ...]

    def is_stacked(self, leaf_name: str) -> bool:
        return leaf_name.startswith(self.stacked_prefixes)

    @property
    def family(self):
        return _family(self.cfg)

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        return self.family.param_shapes(self.cfg)

    def param_template(self) -> dict[str, torch.Tensor]:
        """Leaf name -> meta tensor of the leaf's shape and dtype."""
        from repro_torch.models.layers import dtype_of

        dt = dtype_of(self.cfg.param_dtype)
        return {k: torch.empty(s, dtype=dt, device="meta")
                for k, s in self.param_shapes().items()}

    def init(self, seed: int = 0, *, device="cuda") -> dict:
        """A random parameter map, the same on every rank for one
        ``seed`` (a model group cuts it with :func:`shard_params`)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return self.family.init_params(self.cfg, gen, device)

    # ---------------- input construction -------------------------------
    def batch_specs(self, shape: InputShape) -> dict:
        """Name -> (shape, dtype) of a batch of ``shape``, the reference's:
        decode takes ``token`` (B, 1); the encoder-decoder takes ``frames``
        (B, enc_seq, D) beside S ``tokens``; the VLM takes ``patches`` (B,
        n_patches, D) and S - n_patches text ``tokens``; a train batch has
        ``labels`` over the full length S."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": ((b, 1), torch.int64)}
        if cfg.is_encoder_decoder:
            specs = {"tokens": ((b, s), torch.int64),
                     "frames": ((b, cfg.enc_seq, cfg.d_model),
                                torch.float32)}
        elif cfg.n_patches > 0:
            specs = {"tokens": ((b, s - cfg.n_patches), torch.int64),
                     "patches": ((b, cfg.n_patches, cfg.d_model),
                                 torch.float32)}
        else:
            specs = {"tokens": ((b, s), torch.int64)}
        if shape.kind == "train":
            specs["labels"] = ((b, s), torch.int64)
        return specs

    def make_batch(self, shape: InputShape, seed: int = 0, *,
                   device="cuda") -> dict:
        """A synthetic batch of :meth:`batch_specs`: integers uniform in
        the vocabulary, floats N(0, 1) * 0.02, drawn from a
        ``torch.Generator`` seeded with ``seed`` on ``device``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        out = {}
        for name, (dims, dtype) in self.batch_specs(shape).items():
            if dtype.is_floating_point:
                out[name] = torch.randn(dims, generator=gen,
                                        device=device) * 0.02
            else:
                out[name] = torch.randint(0, self.cfg.vocab, dims,
                                          generator=gen, device=device)
        return out


def get_model(cfg: ModelConfig) -> Model:
    family = _family(cfg)
    if family is encdec:
        def forward(params, batch, shards=None):
            if shards is not None:
                raise ValueError(
                    f"{cfg.name}: the encoder-decoder takes no leaf shards "
                    "(the launcher refuses it, ROADMAP.md Queue C 18)")
            return encdec.forward(cfg, params, batch["tokens"],
                                  batch["frames"])
    else:
        def forward(params, batch, shards=None):
            return transformer.forward(cfg, params, batch["tokens"],
                                       extra_embeds=batch.get("patches"),
                                       shards=shards)

    return Model(
        cfg=cfg,
        forward=forward,
        init_cache=lambda batch, max_len, *, device="cuda": (
            family.init_cache(cfg, batch, max_len,
                              device=resolve_device(device))),
        decode_step=lambda params, cache, token: family.decode_step(
            cfg, params, cache, token),
        stacked_prefixes=family.STACKED_PREFIXES,
    )


def params_from_reference(tree: Mapping[str, np.ndarray], *,
                          device="cuda") -> dict[str, torch.Tensor]:
    """The reference's parameters, flattened by leaf name (``layers/attn/
    wq`` ...), as the port's parameter map: same names, same stacked
    (L, ...) shapes, same leaf order, same dtypes."""
    device = resolve_device(device)
    from repro_torch.core.compartments import leaf_order

    return {name: torch.from_numpy(np.array(tree[name])).to(device)
            for name in leaf_order(tree)}


def pack_reference(tree: Mapping[str, np.ndarray], plan, *,
                   device="cuda") -> torch.Tensor:
    """The reference's parameters as the port's (q_packed,) buffer."""
    from repro_torch.core import projector

    return projector.pack_tree(params_from_reference(tree, device=device),
                               plan, plan.packed())


def slabs_from_reference(padded, slayout, *,
                         device="cuda") -> list[torch.Tensor]:
    """The reference's zero-padded (q_padded,) packed buffer (its
    ``prepare_params`` under a declared model axis) cut into the port's
    m (q_slab,) slabs, slab i for rank i of a model group."""
    device = resolve_device(device)
    buf = torch.from_numpy(np.array(padded, dtype=np.float32)).to(device)
    if tuple(buf.shape) != (slayout.q_padded,):
        raise ValueError(f"expected the ({slayout.q_padded},) padded "
                         f"buffer, got {tuple(buf.shape)}")
    return [buf[a:b].clone() for a, b in
            map(slayout.slab_range, range(slayout.n_shards))]


def rbd_state_from_reference(state, *, device="cuda"):
    """The reference's ``RBDState`` (numpy arrays: the step counter and,
    on the materialized path, the (total_dim, q_packed) basis) as the
    port's: a host step counter and the basis on ``device``, or ()."""
    device = resolve_device(device)
    from repro_torch.core.rbd import RBDState

    basis = state.basis
    if not isinstance(basis, tuple):
        basis = torch.from_numpy(np.array(basis, dtype=np.float32)).to(
            device)
    return RBDState(step=int(np.asarray(state.step)), basis=basis)


def opt_state_from_reference(state, *, device="cuda"):
    """The reference's coordinate optimizer state (numpy arrays) as the
    port's: its NamedTuples (``AdamState``, ``LBFGSState``,
    ``NewtonState``, ``ScheduleState``) by name, a ``chain``'s tuple
    item by item, each array as a tensor of its dtype on ``device``."""
    device = resolve_device(device)
    from repro_torch.optim import transforms as opt

    def convert(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return getattr(opt, type(x).__name__)(*map(convert, x))
        if isinstance(x, (tuple, list)):
            return type(x)(map(convert, x))
        return torch.from_numpy(np.array(x)).to(device)

    return convert(state)


# ---------------------------------------------------------------------------
# pjit-style parameter sharding: leaf shards over a model group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class LeafShards:
    """How a parameter map is cut over a model group of ``m`` ranks, as
    ``sharding.rules.param_specs`` says: leaf ``name`` in ``dims`` is cut
    into ``m`` equal parts along dimension ``dims[name]``, rank ``r``
    holding the contiguous index range ``r`` of it (GSPMD's layout of a
    divisible dimension); every other leaf is replicated.  ``shapes``
    are the whole leaves'.  ``group`` is the model process group; None
    when ``m`` is 1, or when the caller runs the shards one after the
    other itself (and sums their partials)."""

    shapes: Mapping[str, tuple]
    dims: Mapping[str, int]
    m: int
    r: int
    group: Any = None

    def sharded(self, name: str) -> bool:
        return self.m > 1 and name in self.dims

    def local_shape(self, name: str) -> tuple:
        shape = tuple(self.shapes[name])
        if not self.sharded(name):
            return shape
        d = self.dims[name]
        return shape[:d] + (shape[d] // self.m,) + shape[d + 1:]

    def cut(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf ``x`` (a copy)."""
        if not self.sharded(name):
            return x
        d = self.dims[name]
        n = x.shape[d] // self.m
        return x.narrow(d, self.r * n, n).contiguous()

    def with_rank(self, r: int) -> "LeafShards":
        """The same layout seen from rank ``r``, with no group (a model
        group run in turn on one device)."""
        return dataclasses.replace(self, r=int(r), group=None)

    def colmap(self, name: str, stacked: bool):
        """``(w, W, off)`` of the leaf's compartments: local position j of
        a compartment's shard is column ``(j // w) * W + off + j % w`` of
        the whole compartment (``kernels.rbd_project.shard_columns``), or
        None for a replicated leaf.  Raises when the cut falls on a
        stacked leaf's leading (layer) axis: no config's specs do that
        (``tests/test_torch_sharding_rules.py``)."""
        if not self.sharded(name):
            return None
        d = self.dims[name]
        if stacked and d == 0:
            raise ValueError(f"{name}: sharded on its stacked (layer) axis, "
                             "which would give a shard whole compartments")
        tail = tuple(self.shapes[name])[1 if stacked else 0:]
        td = d - (1 if stacked else 0)
        b = int(np.prod(tail[td + 1:], dtype=np.int64))
        n_k = tail[td]
        w = (n_k // self.m) * b
        return w, n_k * b, self.r * w

    def gather(self, name: str, x: torch.Tensor, lead: int = 0
               ) -> torch.Tensor:
        """The whole leaf from this rank's part ``x``, all-gathered over
        the model group, differentiably: the backward pass returns this
        rank's slice of the whole leaf's gradient.  ``lead``: leading
        axes ``x`` lacks against the stored leaf (1 for one layer of a
        stacked leaf).  A replicated leaf comes back as it is."""
        if not self.sharded(name):
            return x
        return _GatherLeaf.apply(x, self.dims[name] - lead, self.m, self.r,
                                 self.group)


class _GatherLeaf(torch.autograd.Function):
    """All-gather of a leaf's parts along one dimension over the model
    group.  Every rank of the group runs the same batch, so every rank
    holds the same whole gradient; its slice is what the reference's
    reduce-scatter of the m identical cotangents, then ``/ m``, gives
    (``src/repro/train/step.py:205-210``)."""

    @staticmethod
    def forward(ctx, x, dim, m, r, group):
        import torch.distributed as dist

        from repro_torch.core import distributed

        parts = [torch.empty_like(x) for _ in range(m)]
        dist.all_gather(parts, x.contiguous(), group=group)
        distributed.COLLECTIVES["leaf_all_gather"] += 1
        ctx.dim, ctx.r, ctx.n = dim, r, x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.r * ctx.n, ctx.n), None, None, None,
                None)


def leaf_shards(model: Model, model_size: int, rank: int = 0,
                group=None) -> LeafShards:
    """The :class:`LeafShards` of ``model``'s parameters over a model
    group of ``model_size`` ranks, seen from its rank ``rank`` (``group``
    the process group), by ``sharding.rules.param_specs`` (the pure_dp
    layout below ``PURE_DP_MAX_PARAMS`` parameters: nothing sharded)."""
    from repro_torch.sharding import rules

    shapes = model.param_shapes()
    specs = rules.param_specs(shapes, {"model": model_size}, model.cfg)
    dims = {k: rules.sharded_dim(spec) for k, spec in specs.items()
            if rules.sharded_dim(spec) is not None}
    return LeafShards(shapes, dims, int(model_size), int(rank), group)


def shard_params(params: Mapping[str, torch.Tensor],
                 shards: LeafShards) -> dict[str, torch.Tensor]:
    """A whole parameter map -> this rank's shards (names, order and
    dtypes unchanged; a replicated leaf as it is)."""
    return {k: shards.cut(k, v) for k, v in params.items()}


def gather_params(params: Mapping[str, torch.Tensor],
                  shards: LeafShards) -> dict[str, torch.Tensor]:
    """This rank's shards -> the whole parameter map, all-gathered over
    the model group (every rank of the group calls it)."""
    with torch.no_grad():
        return {k: shards.gather(k, v) for k, v in params.items()}
