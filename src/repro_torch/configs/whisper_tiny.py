"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865,
encoder-decoder with conv frontend STUB [arXiv:2212.04356]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        arch_type="audio",
        citation="arXiv:2212.04356",
        n_layers=4,            # decoder
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_head=64,
        d_ff=1536,
        vocab=51_865,
        is_encoder_decoder=True,
        enc_seq=1500,          # 30s audio -> 1500 conv-downsampled frames
        act="gelu",
    )
