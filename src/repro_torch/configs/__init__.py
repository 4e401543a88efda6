"""Config registry: ``--arch <id>`` -> ModelConfig.

The reference's ten architectures: nine decoder-only ones and the
encoder-decoder whisper-tiny (``models/encdec.py``).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      RBDConfig, TrainConfig)

ARCH_IDS = {
    "gemma3-4b": "gemma3_4b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-0.5b": "qwen2_05b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "rwkv6-1.6b": "rwkv6_16b",
    "tinyllama-1.1b": "tinyllama_11b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-2.7b": "zamba2_27b",
    "granite-34b": "granite_34b",
    "whisper-tiny": "whisper_tiny",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")
    return mod.get_config()


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "RBDConfig", "TrainConfig", "get_config"]
