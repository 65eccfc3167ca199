"""Hymba-1.5B — hybrid: parallel attention + Mamba heads per layer.
[arXiv:2411.13676]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    activation="silu_glu",
    sliding_window=1024,  # Hymba uses SWA in most layers
    source="parallel attn+mamba heads [arXiv:2411.13676]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
        ssm_state=8, vocab_size=512, vocab_pad_multiple=64, sliding_window=32,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
