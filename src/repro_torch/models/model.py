"""Top-level serving API of the port: build_model(cfg, device) ->
Model(prefill, decode_step, init_cache).

A port of the serving half of `repro/models/model.py::build_model`, for
the families in `transformer.PORTED_FAMILIES` (dense and ssm).  The
training entry (`loss_fn`, chunked cross-entropy) waits for the training
slice, and parameters come from `repro_torch.checkpoint.convert`
(`init` on the card, or `params_from_jax`).

Batch contract, as in the JAX package:
  prefill: {tokens (B,T) int}
  decode:  token (B,1) int, cache, pos (int) = number of tokens already cached
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """Raises if `device` names CUDA and there is no card, or the family is not ported."""
    dev = resolve_device(device)
    transformer.check_family(cfg)

    @torch.inference_mode()
    def prefill(params, batch, *, window: Optional[int] = None):
        """Returns (last-position logits (B, Vpad) f32, cache)."""
        w = cfg.sliding_window if window is None else window
        tokens = batch["tokens"].to(dev)
        x = layers.embed(params, cfg, tokens)
        pos = torch.arange(x.shape[1], device=dev)
        x, cache = transformer.run_stack_prefill(params["layers"], cfg, x, pos, window=w)
        x = layers.rmsnorm(params["final_norm"], x)
        lg = layers.logits(params, cfg, x[:, -1:])
        return lg[:, 0], cache

    @torch.inference_mode()
    def decode_step(params, token, cache, pos: int, *, window: int = 0):
        """One token: token (B,1) int.  Returns (logits (B, Vpad) f32, cache),
        the cache updated in place."""
        x = layers.embed(params, cfg, token.to(dev))
        x, cache = transformer.run_stack_decode(params["layers"], cache, cfg, x, pos, window=window)
        x = layers.rmsnorm(params["final_norm"], x)
        lg = layers.logits(params, cfg, x)
        return lg[:, 0], cache

    def init_cache(batch: int, cache_len: int, window: int = 0):
        return transformer.init_cache(cfg, batch, cache_len, window, device=dev)

    return Model(cfg=cfg, device=dev, prefill=prefill, decode_step=decode_step, init_cache=init_cache)
