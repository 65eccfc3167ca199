"""Qwen3-MoE 30B-A3B — 128 experts, top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,  # per-expert FFN width
    vocab_size=151936,
    n_experts=128,
    moe_top_k=8,
    activation="silu_glu",
    moe_dispatch="hybrid",  # §Perf hillclimb: gather dispatch + einsum combine
    rope_theta=1_000_000.0,
    source="128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=64,
        n_experts=4, moe_top_k=2, vocab_size=512, vocab_pad_multiple=64,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
