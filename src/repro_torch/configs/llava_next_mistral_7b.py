"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, anyres tiling; vision tower + projector are the sanctioned
STUB -- the backbone consumes precomputed patch embeddings
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        arch_type="vlm",
        citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=32_000,
        n_patches=576,         # 24x24 base grid (anyres adds tiles; fixed
                               # at base for the shape contract)
        rope_theta=1_000_000.0,
    )
