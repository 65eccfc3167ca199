"""PaliGemma-3B language backbone — Gemma decoder consuming SigLIP patch
embeddings (the vision tower is a stub: input_specs provides (B, P, d_model)
patch embeddings).  MQA (kv=1), head_dim 256.  [arXiv:2407.07726]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    vlm_patches=256,
    activation="gelu",
    source="SigLIP + gemma [arXiv:2407.07726]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, head_dim=64,
        d_ff=512, vocab_size=512, vocab_pad_multiple=64, vlm_patches=16,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
