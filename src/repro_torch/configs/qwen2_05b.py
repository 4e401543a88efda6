"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias [arXiv:2407.10671]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        arch_type="dense",
        citation="arXiv:2407.10671",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_head=64,
        d_ff=4864,
        vocab=151_936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
