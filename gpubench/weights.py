"""Inputs the benchmark makes from the seed, on the device, and hands to both
the program and the reference: a model's weights and token batches.

The weights fill the port's parameter tree (the JAX package's layout,
`repro_torch/checkpoint/convert.py` names it), one leaf a call, drawn in
the dtype they are served in: N(0, 1 / fan_in) for every dense weight,
ones for the norms' scales, and the router in float32.
"""

from __future__ import annotations

import math

import torch

from gpubench import flops


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def moe_param_shapes(cfg: dict) -> dict:
    """{path: (shape, dtype name, fan_in or None for ones)} of a decoder-only
    MoE model's tree."""
    d, l_, e, f = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_local_experts"], cfg["intermediate_size"]
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], flops.head_dim(cfg)
    v = flops.padded_vocab(cfg)
    p = cfg["param_dtype"]
    return {
        "embed": ((v, d), p, d),
        "lm_head": ((d, v), p, d),
        "layers.ln1.scale": ((l_, d), "float32", None),
        "layers.attn.wq": ((l_, d, h, hd), p, d),
        "layers.attn.wk": ((l_, d, kv, hd), p, d),
        "layers.attn.wv": ((l_, d, kv, hd), p, d),
        "layers.attn.wo": ((l_, h, hd, d), p, h * hd),
        "layers.ln2.scale": ((l_, d), "float32", None),
        "layers.moe.router": ((l_, d, e), "float32", d),
        "layers.moe.w_in": ((l_, e, d, f), p, d),
        "layers.moe.w_out": ((l_, e, f, d), p, f),
        "layers.moe.w_gate": ((l_, e, d, f), p, d),
        "final_norm.scale": ((d,), "float32", None),
    }


def make_params(cfg: dict, gen: torch.Generator, dev) -> dict:
    """The nested parameter dict of ``cfg``'s shapes, drawn from ``gen``."""
    tree: dict = {}
    for path, (shape, dt, fan_in) in moe_param_shapes(cfg).items():
        if fan_in is None:
            leaf = torch.ones(shape, dtype=_dtype(dt), device=dev)
        else:
            leaf = torch.randn(shape, generator=gen, dtype=_dtype(dt), device=dev).mul_(1.0 / math.sqrt(fan_in))
        node = tree
        *parents, name = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def leaves(tree: dict, prefix: str = "") -> dict:
    """{dotted path: tensor} of a nested dict."""
    out = {}
    for k, v in tree.items():
        out.update(leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def markov_tokens(batch: int, seq: int, vocab: int, gen: torch.Generator, dev, follow_p: float = 0.8):
    """(tokens, targets), each (batch, seq) int64: a walk over the vocabulary
    that goes to the next id with probability ``follow_p`` and jumps to a
    uniform id otherwise (the port's synthetic token stream's law, drawn
    here from ``gen``); targets are the tokens shifted by one."""
    base = torch.randint(0, vocab, (batch, seq + 1), generator=gen, device=dev)
    follow = torch.rand((batch, seq + 1), generator=gen, device=dev) < follow_p
    idx = torch.arange(seq + 1, device=dev).expand(batch, -1)
    last_jump = torch.cummax(torch.where(follow, -1, idx), dim=1).values
    walked = (base.gather(1, last_jump.clamp_min(0)) + idx - last_jump) % vocab
    seq_ = torch.where(last_jump >= 0, walked, (base[:, :1] + idx + 1) % vocab)
    return seq_[:, :-1].contiguous(), seq_[:, 1:].contiguous()
