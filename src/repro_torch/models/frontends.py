"""Stub modality frontends (port of ``audio_frames`` and
``vision_patches`` of ``repro.models.frontends``).

The audio conv feature extractor (whisper) and the vision tower and
projector (llava) are the reference's one sanctioned stub: the backbones
take precomputed frame or patch embeddings.  These draw them at scale
0.02 from a ``torch.Generator`` on ``device``, so their values are not
the reference's ``jax.random`` draws (the parity tests carry the
reference's frames and patches across).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import resolve_device


def _draw(shape, seed: int, device) -> torch.Tensor:
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device) * 0.02


def audio_frames(cfg: ModelConfig, batch: int, *, seed: int = 0,
                 device="cuda") -> torch.Tensor:
    """(B, enc_seq, d_model) float32 synthetic mel + conv output
    embeddings."""
    return _draw((batch, cfg.enc_seq, cfg.d_model), seed, device)


def vision_patches(cfg: ModelConfig, batch: int, *, seed: int = 1,
                   device="cuda") -> torch.Tensor:
    """(B, n_patches, d_model) float32 synthetic ViT + projector
    embeddings."""
    return _draw((batch, cfg.n_patches, cfg.d_model), seed, device)
