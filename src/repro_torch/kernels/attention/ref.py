"""Plain PyTorch version of the flash-attention kernel's function.

A port of `repro/kernels/attention/ref.py::attention_ref`, with one addition
taken from the kernel: a query row that sees no key outputs 0 (the kernel
clamps its denominator to 1e-30 and its accumulator stays 0), where a plain
softmax over an all-masked row would average every value row.
"""

from __future__ import annotations

import math

import torch


def visible_mask(t: int, s: int, *, causal: bool, window: int, device=None) -> torch.Tensor:
    """(T,S) bool: query i may see key j.  Positions of both start at 0."""
    qpos = torch.arange(t, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = kpos <= qpos if causal else torch.ones((t, s), dtype=torch.bool, device=device)
    if window:
        mask = mask & (qpos - kpos < window)
    return mask


def attention_ref(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, t, kvh, g, hd)
    scores = torch.einsum("btngk,bsnk->bngts", qg, k).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    mask = None
    if causal or window:
        mask = visible_mask(t, s, causal=causal, window=window, device=q.device)
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngts,bsnk->btngk", probs, v)
    if mask is not None:
        seen = mask.any(dim=-1)  # (T,)
        out = torch.where(seen[None, :, None, None, None], out, torch.zeros((), dtype=out.dtype))
    return out.reshape(b, t, h, hd)
