"""Parameters of the port: JAX weights carried across, or drawn on the card,
and the simulation engine's inputs carried across (`engine_inputs`).

The tree is the JAX package's (`repro/models/model.py::build_model().init`):
  {"embed" (Vpad,D), "lm_head" (D,Vpad) unless tied,
   "layers": stacked (L, ...), by family
     dense: {"ln1": {"scale"}, "attn": {"wq","wk","wv","wo"}, "ln2": {"scale"},
             "mlp": {"w_gate","w_in","w_out"}}
     moe:   {"ln1": {"scale"}, "attn": {...}, "ln2": {"scale"},
             "moe": {"router" (L,D,E) f32, "w_gate","w_in" (L,E,D,F), "w_out" (L,E,F,D)}}
     ssm:   {"ln1": {"scale"}, "tmix": {"mu","wr","wk","wv","wg","wo","decay_w0",
             "decay_a1","decay_a2","bonus_u","ln_out"}, "ln2": {"scale"},
             "cmix": {"mu_c","w_in","w_out","w_recept"}},
     hybrid: {"ln1": {"scale"}, "mix": {"attn": {...}, "ssm": {"w_xs","w_dt","dt_bias",
             "a_log","w_b","w_c","w_os","skip_d"}, "norm_attn" (L,D), "norm_ssm" (L,D)},
             "ln2": {"scale"}, "mlp": {...}},
     encdec (the decoder): dense's, with {"ln_x": {"scale"}, "xattn": {...}}
     vlm: dense's,
   "final_norm": {"scale"},
   encdec only: "encoder": a dense stack of encoder_layers, "enc_norm": {"scale"}}
as plain dicts of torch tensors with the same names, shapes and dtypes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch.from_numpy does not take
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: Mapping[str, Any], device="cuda") -> dict:
    """The port's parameters from a JAX parameter tree whose leaves are numpy
    arrays (e.g. `jax.tree.map(np.asarray, params)`).  Bits are kept."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, dev)

    return walk(tree)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters drawn on `device` from `generator` (which must live
    on that device), from the distributions of the JAX package's init:
    N(0, 1/fan_in) dense weights, unit norm scales, and for ssm the constant
    lerp weights (0.5), decay bias (-1) and groupnorm scale (1), with the
    decay LoRA and bonus u N(0, 1/fan_in) in f32; for moe an f32 router;
    for hybrid the SSM branch's zero dt bias and log-decay, unit skip and
    branch-norm scales, and an f32 step-size projection; for encdec the
    decoder's cross-attention and a dense encoder stack.  JAX's bits cannot
    be reproduced; use `params_from_jax` for that."""
    dev = resolve_device(device)
    is_encdec = cfg.family == "encdec"
    params = {
        **layers.embed_init(generator, cfg, dev),
        "layers": transformer.init_layer_stack(generator, cfg, cfg.n_layers, dev, cross=is_encdec),
        "final_norm": layers.rmsnorm_init(cfg, dev),
    }
    if is_encdec:
        params["encoder"] = transformer.init_layer_stack(generator, cfg.replace(family="dense"), cfg.encoder_layers,
                                                         dev)
        params["enc_norm"] = layers.rmsnorm_init(cfg, dev)
    return params


def engine_inputs(keys, params0, X, y, device="cuda"):
    """The simulation engine's inputs carried across from the JAX package:
    replica keys (numpy uint32 (R, 2), e.g. `np.asarray(jax.random.split(...))`),
    a `params0` pytree and the data `(X, y)` as numpy arrays.  Returns
    `(keys, params0, (X, y))` as the port's tensors on `device`: keys int64
    holding the same uint32 words, arrays with their bits and dtypes kept."""
    dev = resolve_device(device)
    return (prng.as_key(keys, dev), tree_map(lambda a: _tensor(a, dev), params0),
            (_tensor(X, dev), _tensor(y, dev)))
