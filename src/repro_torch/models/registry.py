"""Uniform model API (port of ``repro.models.registry``), plus the bridge
that carries the reference's parameters and optimizer state into the
port."""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

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
    forward: Callable            # (params, batch) -> (logits, aux)
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
        def forward(params, batch):
            return encdec.forward(cfg, params, batch["tokens"],
                                  batch["frames"])
    else:
        def forward(params, batch):
            return transformer.forward(cfg, params, batch["tokens"],
                                       extra_embeds=batch.get("patches"))

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
