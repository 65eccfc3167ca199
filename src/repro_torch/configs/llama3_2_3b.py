"""Llama-3.2 3B — small llama3: dense, GQA kv=8, RoPE theta 500k.
[hf:meta-llama/Llama-3.2-3B]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    activation="silu_glu",
    rope_theta=500_000.0,
    source="small llama3 [hf:meta-llama/Llama-3.2-1B]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=384, n_heads=6, n_kv_heads=2, d_ff=768,
        vocab_size=512, vocab_pad_multiple=64, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
