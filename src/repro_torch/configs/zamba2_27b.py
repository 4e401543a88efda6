"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 -- Mamba2 backbone + parameter-shared attention
blocks every 6 layers [arXiv:2411.15242]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        citation="arXiv:2411.15242",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=10240,
        vocab=32_000,
        block_kind="mamba",
        ssm_state=64,
        ssm_expand=2,
        hybrid_attn_every=6,   # 54 = 9 groups x 6 mamba layers + shared attn
    )
