"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        arch_type="moe",
        citation="hf:microsoft/Phi-3.5-MoE-instruct",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=6400,
        vocab=32_064,
        n_experts=16,
        top_k=2,
    )
