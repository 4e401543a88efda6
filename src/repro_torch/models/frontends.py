"""Stub modality frontend for the VLM (port of ``vision_patches`` of
``repro.models.frontends``).

The vision tower and projector of llava are the reference's one
sanctioned stub: the backbone takes precomputed patch embeddings.  This
draws them, (B, n_patches, d_model) at scale 0.02, from a
``torch.Generator``, so its values are not the reference's
``jax.random`` draws (the parity tests carry the reference's patches
across).  ``audio_frames`` waits for the encoder-decoder (ROADMAP.md
Queue A 22).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def vision_patches(cfg: ModelConfig, batch: int, *, seed: int = 1,
                   device="cpu") -> torch.Tensor:
    """(B, n_patches, d_model) float32 synthetic ViT + projector
    embeddings."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.n_patches, cfg.d_model), generator=gen,
                       device=device) * 0.02
