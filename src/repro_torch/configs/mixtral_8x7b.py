"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        citation="arXiv:2401.04088",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=32_000,
        n_experts=8,
        top_k=2,
        window=4096,          # mistral-style SWA
        rope_theta=1_000_000.0,
    )
