"""Model / run configuration dataclasses (port of ``repro.configs.base``).

Field names and defaults match the reference.  ``RBDConfig.backend``
names the port's backends: ``"torch"`` (plain PyTorch, the reference's
``"jnp"``) and ``"cuda"`` (the hand-written Hopper kernels, the
reference's ``"pallas"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

BASIS_SPECS = ("random", "trajectory_pca", "gradient_informed")
KERNEL_BACKEND = "cuda"
BACKENDS = ("torch", KERNEL_BACKEND)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense|moe|ssm|hybrid|audio|vlm
    citation: str = ""

    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 32000
    qkv_bias: bool = False
    act: str = "silu"               # mlp activation (silu -> SwiGLU)
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # attention pattern
    window: Optional[int] = None    # sliding-window size (None = full)
    global_every: int = 0           # >0: every Nth layer is full/global

    # mixture of experts
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 16

    # recurrent blocks
    block_kind: str = "attn"        # attn | rwkv | mamba
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    hybrid_attn_every: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # vlm
    n_patches: int = 0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("GQA requires n_heads % n_kv_heads == 0")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or windowed) sequence mixing -> eligible for the
        long_500k decode shape."""
        return (
            self.block_kind in ("rwkv", "mamba")
            or self.window is not None
            or self.hybrid_attn_every > 0
        )

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 layers, d_model 128,
        <=4 experts, vocab 512 -- the same cut as the reference."""
        kv_ratio = max(1, self.n_heads // self.n_kv_heads)
        n_heads = 4
        n_kv = max(1, n_heads // kv_ratio)
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            window=min(self.window, 64) if self.window else None,
            global_every=self.global_every,
            hybrid_attn_every=(2 if self.hybrid_attn_every else 0),
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16 if self.is_encoder_decoder else self.enc_seq,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            n_patches=8 if self.n_patches else 0,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RBDConfig:
    """Integration of the paper's technique into a training run."""
    enabled: bool = True
    total_dim: int = 4096           # trainable coefficients across all comps
    granularity: str = "layer"      # global|even|leaf|layer
    allocation: str = "proportional"
    distribution: str = "normal"
    normalization: str = "rsqrt_dim"
    redraw: bool = True             # True=RBD, False=FPD
    mode: str = "shared_basis"      # shared_basis | independent_bases
    base_seed: int = 0
    backend: str = "torch"          # torch | cuda
    packed: str = "auto"            # auto | on | off; "auto" enables the
                                    # packed two-launch step on the cuda
                                    # backend
    prng_impl: str = "threefry"     # threefry | hw | hw_emulated
    basis: str = "random"           # random | trajectory_pca |
                                    # gradient_informed
    basis_refresh_every: int = 0
    steps_fpd: int = 0              # fixed basis for the first N steps
    switch_policy: str = "reset"    # reset | carry at the FPD -> RBD switch

    def __post_init__(self):
        # the ONE validation point for the basis-layer knobs
        if self.basis not in BASIS_SPECS:
            raise ValueError(
                f"RBDConfig.basis={self.basis!r}; expected one of "
                f"{BASIS_SPECS}")
        if self.basis_refresh_every < 0:
            raise ValueError("RBDConfig.basis_refresh_every must be >= 0")
        if self.steps_fpd < 0:
            raise ValueError("RBDConfig.steps_fpd must be >= 0")
        if self.switch_policy not in ("reset", "carry"):
            raise ValueError(
                f"RBDConfig.switch_policy={self.switch_policy!r}; "
                "expected 'reset' or 'carry'")
        if self.basis != "random" and self.steps_fpd:
            raise ValueError(
                "steps_fpd schedules the RANDOM basis seed; it does not "
                f"compose with basis={self.basis!r} (the materialized "
                "basis is already fixed between collector refreshes)")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"RBDConfig.backend={self.backend!r}; expected one of "
                f"{BACKENDS}")

    @property
    def use_packed(self) -> bool:
        if self.packed == "auto":
            return self.backend == KERNEL_BACKEND
        return self.packed == "on"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    rbd: RBDConfig = RBDConfig()
    optimizer: str = "sgd"          # paper: plain SGD, no momentum
    learning_rate: float = 0.5
    weight_decay: float = 0.0
    momentum_beta: float = 0.9
    nesterov: bool = False
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    lbfgs_history: int = 8
    coord_clip_norm: float = 0.0
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    steps: int = 100
    batch_size: int = 32
    seq_len: int = 128
    grad_accum_steps: int = 1
    seed: int = 0
    log_update_norm: bool = True    # costs one extra read of the old and
                                    # new parameter buffers per step
