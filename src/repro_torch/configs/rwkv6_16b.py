"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 -- Finch, data-dependent decay [arXiv:2404.05892]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        arch_type="ssm",
        citation="arXiv:2404.05892",
        n_layers=24,
        d_model=2048,
        n_heads=32,            # head size 64, RWKV-6 convention
        n_kv_heads=32,
        d_ff=7168,
        vocab=65_536,
        block_kind="rwkv",
    )
