"""SeamlessM4T-medium backbone — encoder-decoder, multimodal (audio).
The conv/mel frontend is a stub: input_specs provides precomputed frame
embeddings (B, F, d_model).  [arXiv:2308.11596]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="encdec",
    n_layers=12,  # decoder layers
    encoder_layers=12,
    encoder_frames=1536,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    activation="gelu",
    source="enc-dec, multimodal [arXiv:2308.11596]",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, encoder_layers=2, encoder_frames=32, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=512,
        vocab_pad_multiple=64, param_dtype="float32", compute_dtype="float32",
        remat=False,
    )
