"""Nemotron-4 340B — dense, GQA kv=8, squared-ReLU MLP.  [arXiv:2402.16819]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="sq_relu",
    source="GQA, squared-ReLU [arXiv:2402.16819]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=384, n_heads=8, n_kv_heads=2, d_ff=768,
        vocab_size=512, vocab_pad_multiple=64, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
