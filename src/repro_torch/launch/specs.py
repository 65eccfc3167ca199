"""Shape-and-dtype stand-ins for every model input: the port of
`repro/launch/specs.py`.

`input_specs(cfg, shape)` returns tensors on PyTorch's ``meta`` device where
the JAX package returns `jax.ShapeDtypeStruct`s: each has the shape and dtype
of the real input and holds no storage (a long_500k decode cache of a large
arch allocates nothing), and, unlike a plain (shape, dtype) tuple, it can be
passed through the model's functions to propagate shapes.  The modality
frontends are stubs, as in the JAX package: vlm takes precomputed patch
embeddings, encdec precomputed frame embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import layers, transformer

META = torch.device("meta")


def window_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Attention-window policy per input shape.

    long_500k needs memory that grows slower than the sequence: SSM archs
    need nothing; every attention-bearing arch switches to its sliding-window
    variant (cfg.long_context_window) so the KV cache is window-sized.  Other
    shapes use the architecture's own window (hymba ships with one; the rest
    run full attention)."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.sliding_window or cfg.long_context_window
    return cfg.sliding_window


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    w = window_for(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _extras(cfg: ModelConfig, batch: int, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.family == "vlm":
        out["patches"] = _spec((batch, cfg.vlm_patches, cfg.d_model), dtype)
    if cfg.family == "encdec":
        out["frames"] = _spec((batch, cfg.encoder_frames, cfg.d_model), dtype)
    return out


def stub_inputs(cfg: ModelConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    """The frontend stubs as the JAX package's example and train CLI feed
    them: f32 zero patches (vlm) or frames (encdec) of `_extras`' shapes;
    {} otherwise.  Zero frames leave the encoder's memory 0, so the
    cross-attention adds 0: a check of those paths needs other inputs."""
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=device)
            for k, v in _extras(cfg, batch, torch.float32).items()}


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Batch stand-ins for the given input shape (train and prefill: a token
    batch; decode: one token, the decode cache and the position)."""
    b, t = shape.global_batch, shape.seq_len
    cdt = layers._dtype(cfg.compute_dtype)
    if shape.kind == "train":
        return {"tokens": _spec((b, t), torch.int32), "targets": _spec((b, t), torch.int32), **_extras(cfg, b, cdt)}
    if shape.kind == "prefill":
        return {"tokens": _spec((b, t), torch.int32), **_extras(cfg, b, cdt)}
    # decode: ONE new token against a seq_len-deep cache.  vlm's patches are
    # already in the cache; only encdec's frames (the encoder's static
    # memory) remain a decode-time input.
    extras = _extras(cfg, b, cdt)
    extras.pop("patches", None)
    return {
        "token": _spec((b, 1), torch.int32),
        "cache": transformer.init_cache(cfg, b, t, window_for(cfg, shape), device=META),
        "pos": _spec((), torch.int32),
        **extras,
    }
