"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 -- llama-arch code model [arXiv:2405.04324]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        arch_type="dense",
        citation="arXiv:2405.04324",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,          # MQA
        d_head=128,
        d_ff=24576,
        vocab=49_152,
        act="gelu",            # gpt-bigcode-style ungated MLP (matches 34B)
    )
