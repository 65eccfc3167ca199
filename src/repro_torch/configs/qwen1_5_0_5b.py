"""Qwen1.5-0.5B — small dense, MHA (kv=16), QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    activation="silu_glu",
    source="QKV bias [hf:Qwen/Qwen1.5-0.5B]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, vocab_pad_multiple=64, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
