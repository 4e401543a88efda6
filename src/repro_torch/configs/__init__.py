"""Config registry: ``--arch <id>`` -> ModelConfig.

The reference registers ten architectures; the port carries the two
dense decoders of its first slice.  The others are listed in ROADMAP.md
(Queue A, "the rest of the model zoo") and raise until they are ported.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, RBDConfig, TrainConfig

ARCH_IDS = {
    "qwen2-0.5b": "qwen2_05b",
    "tinyllama-1.1b": "tinyllama_11b",
}
UNPORTED_ARCH_IDS = (
    "gemma3-4b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "whisper-tiny",
    "rwkv6-1.6b", "llava-next-mistral-7b", "zamba2-2.7b", "granite-34b",
)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in UNPORTED_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md Queue A 18: "
            "the rest of the model zoo)")
    if arch_id not in ARCH_IDS:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")
    return mod.get_config()


__all__ = ["ARCH_IDS", "ModelConfig", "RBDConfig", "TrainConfig",
           "get_config"]
