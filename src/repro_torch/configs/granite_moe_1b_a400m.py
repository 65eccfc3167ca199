"""Granite-3.0 1B-A400M — MoE, 32 experts top-8, GQA kv=8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,  # per-expert FFN width
    vocab_size=49155,
    n_experts=32,
    moe_top_k=8,
    activation="silu_glu",
    moe_dispatch="hybrid",  # §Perf hillclimb: gather dispatch + einsum combine
    source="32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, d_ff=64,
        n_experts=4, moe_top_k=2, vocab_size=512, vocab_pad_multiple=64,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
