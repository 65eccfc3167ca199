"""Model configuration for the PyTorch port.

A copy of the JAX package's `ModelConfig` (`repro/configs/base.py`), kept
here so that the port imports nothing of that package.  Each ported
`repro_torch/configs/<arch>.py` exports `CONFIG` (the published shape) and
`smoke_config()` (the reduced variant the CPU tests run).  `INPUT_SHAPES`
are the JAX package's named input shapes (`launch/specs.py` reads them).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "silu_glu"  # silu_glu | sq_relu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "einsum"

    # SSM (RWKV-6 / Mamba-in-Hymba)
    ssm_state: int = 0
    wkv_chunk: int = 32

    # Encoder-decoder (audio)
    encoder_layers: int = 0
    encoder_frames: int = 1536

    # VLM
    vlm_patches: int = 0

    # Attention variants
    sliding_window: int = 0  # 0 = full causal attention
    long_context_window: int = 4096

    # numerics / structure
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    seq_parallel: bool = False
    attention_impl: str = "naive"
    attention_block: int = 1024
    vocab_pad_multiple: int = 1024
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"
    # Route prefill attention and the prefill wkv scan through the
    # hand-written CUDA kernels.  The JAX
    # package's field is `use_pallas` (default False there); the port's
    # kernels are its point, so they are on by default here.
    use_kernels: bool = True

    source: str = ""  # citation (paper / model card)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_groups(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not a multiple of n_kv_heads {self.n_kv_heads}")
        return self.n_heads // self.n_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
