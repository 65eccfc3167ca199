"""Qwen1.5-110B — dense, GQA kv=8, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    activation="silu_glu",
    source="QKV bias [hf:Qwen/Qwen1.5-110B]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab_size=512, vocab_pad_multiple=64, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
