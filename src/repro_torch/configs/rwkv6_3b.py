"""RWKV-6 "Finch" 3B — attention-free SSM with data-dependent decay.
[arXiv:2404.05892]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # 2560 / 64 — RWKV-6 uses head_size 64
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    activation="sq_relu",  # RWKV channel-mix uses squared ReLU
    source="Finch — data-dependent decay [arXiv:2404.05892]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, vocab_pad_multiple=64, param_dtype="float32",
        compute_dtype="float32", scan_layers=True, remat=False,
    )
