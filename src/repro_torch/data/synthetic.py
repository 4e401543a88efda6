"""Synthetic datasets (port of ``repro.data.synthetic``).

* ``mixture_images`` -- Gaussian-mixture image classification standing in
  for (F)MNIST / CIFAR-10 in the paper's experiments: each class is a
  smoothed random template plus noise, at the paper's input shapes.
* ``lm_batches`` -- a Zipf-distributed sparse Markov chain, so the loss
  is learnable.

The class templates and the transition table are the reference's (the
same numpy construction gives the same arrays, bit for bit); the labels,
noise, start tokens and branch choices are drawn from a CPU
``torch.Generator`` seeded per batch from ``(seed, step)``, so the
batches differ from the reference's ``jax.random`` draws.  Parity tests
feed both packages the reference's batches.
"""

from __future__ import annotations

import functools
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import rng


class CounterStream:
    """Iterator over a pure ``make(step)`` batch function: batch ``i`` is
    a function of ``(seed, i)`` alone, so :meth:`skip` is O(1)."""

    def __init__(self, make):
        self._make = make
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self):
        out = self._make(self.step)
        self.step += 1
        return out

    def skip(self, n: int) -> "CounterStream":
        """Advance past ``n`` batches without generating them (resume keeps
        the stream step-aligned with ``skip(start * n_accum)``)."""
        if n < 0:
            raise ValueError(f"cannot skip {n} < 0 batches")
        self.step += int(n)
        return self


@functools.lru_cache(maxsize=8)
def _class_templates(seed: int, n_classes: int,
                     shape: tuple[int, ...]) -> np.ndarray:
    """(n_classes, *shape) float32 templates, spatially smoothed, unit std
    per class (the reference's)."""
    gen = np.random.default_rng(seed)
    t = gen.normal(size=(n_classes,) + shape).astype(np.float32)
    # smooth spatially so classes have coherent low-frequency structure
    for _ in range(3):
        t = (t + np.roll(t, 1, axis=1) + np.roll(t, -1, axis=1)
             + np.roll(t, 1, axis=2) + np.roll(t, -1, axis=2)) / 5.0
    t /= t.std(axis=(1, 2, 3), keepdims=True)
    return t


def _batch_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of batch ``step`` of a stream seeded ``seed``."""
    key = int(rng.to_uint32(rng.fold_seed(seed, step)))
    return torch.Generator().manual_seed(key)


def mixture_images(gen: torch.Generator, batch: int, *, shape=(28, 28, 1),
                   n_classes: int = 10, noise: float = 1.0, seed: int = 0,
                   device="cuda"):
    """(x (B, *shape) float32, y (B,) int64) on ``device``: class ``y``'s
    template (templates of ``seed``) plus ``noise`` times N(0, 1), drawn
    from the CPU generator ``gen``."""
    from repro_torch.models.registry import resolve_device

    device = resolve_device(device)
    shape = tuple(shape)
    templates = torch.from_numpy(_class_templates(seed, n_classes, shape))
    y = torch.randint(0, n_classes, (batch,), generator=gen)
    x = templates[y] + noise * torch.randn((batch,) + shape, generator=gen)
    return x.to(device), y.to(device)


def mixture_dataset(seed: int, batch: int, *, shape=(28, 28, 1),
                    n_classes: int = 10, noise: float = 1.0,
                    device="cuda") -> Iterator:
    """Infinite iterator of (x, y) batches on ``device`` (O(1)
    ``skip``)."""

    def make(step):
        return mixture_images(_batch_generator(seed, step), batch,
                              shape=shape, n_classes=n_classes, noise=noise,
                              seed=seed, device=device)

    return CounterStream(make)


@functools.lru_cache(maxsize=8)
def _markov_table(seed: int, vocab: int, branch: int = 4) -> np.ndarray:
    """Each token has ``branch`` likely successors drawn from a Zipf
    prior (the reference's table)."""
    gen = np.random.default_rng(seed + 1)
    zipf_p = 1.0 / np.arange(1, vocab + 1)
    zipf_p /= zipf_p.sum()
    succ = gen.choice(vocab, size=(vocab, branch), p=zipf_p)
    return succ.astype(np.int32)


def token_stream(gen: torch.Generator, batch: int, seq_len: int, vocab: int,
                 *, seed: int = 0, branch: int = 4) -> torch.Tensor:
    """(B, S+1) int64 Markov chains (on the CPU)."""
    succ = torch.from_numpy(_markov_table(seed, vocab, branch)).long()
    first = torch.randint(0, vocab, (batch,), generator=gen)
    choices = torch.randint(0, branch, (batch, seq_len), generator=gen)
    toks = [first]
    for t in range(seq_len):
        toks.append(succ[toks[-1], choices[:, t]])
    return torch.stack(toks, dim=1)


def lm_batches(seed: int, batch: int, seq_len: int, vocab: int, *,
               device="cuda") -> Iterator:
    """Infinite iterator of {"tokens", "labels"} (B, S) int64 batches on
    ``device``."""
    from repro_torch.models.registry import resolve_device

    device = resolve_device(device)

    def make(step):
        toks = token_stream(_batch_generator(seed, step), batch, seq_len,
                            vocab, seed=seed).to(device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return CounterStream(make)
