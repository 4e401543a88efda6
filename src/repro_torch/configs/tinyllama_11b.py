"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 -- llama2-arch small [arXiv:2401.02385]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        arch_type="dense",
        citation="arXiv:2401.02385",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=64,
        d_ff=5632,
        vocab=32_000,
    )
