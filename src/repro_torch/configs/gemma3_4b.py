"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 -- 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt family]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        arch_type="dense",
        citation="hf:google/gemma-3-1b-pt",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=10240,
        vocab=262_144,
        window=1024,          # local layers
        global_every=6,       # every 6th layer is global -> 5:1 local:global
        rope_theta=1_000_000.0,  # long-context rope base (128k)
        tie_embeddings=True,
    )
