"""Hymba-style hybrid block: parallel attention + SSM heads in every layer.

A port of `repro/models/hybrid.py` (arXiv:2411.13676): each layer feeds the
same normed input to an attention branch and a Mamba2-style SSM branch
(scalar per-head decay, `linear_scan.ssm_chunked`) in parallel; the two
outputs are normalized each on its own, averaged, and projected.  Parameter
names, shapes and dtypes are the JAX package's (`norm_attn` and `norm_ssm`
are bare (D,) scales); every init takes a `lead` shape, e.g. (L,) for a
stack of layers.  The attention branch reaches the flash-attention kernel
through `layers.attention_full`, as dense layers do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, linear_scan
from repro_torch.models.layers import _dense_init, _dtype, project_heads, project_out
from repro_torch.shardctx import constrain_alt, is_dtensor, on_local_shards


def ssm_branch_init(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    d = cfg.d_model
    h, hd, n = cfg.n_heads, cfg.resolved_head_dim, cfg.ssm_state
    dt = _dtype(cfg.param_dtype)
    f32 = torch.float32
    return {
        "w_xs": _dense_init(gen, lead + (d, h, hd), dt, d, device),  # per-head input proj
        "w_dt": _dense_init(gen, lead + (d, h), f32, d, device),  # step-size proj
        "dt_bias": torch.zeros(lead + (h,), dtype=f32, device=device),
        "a_log": torch.zeros(lead + (h,), dtype=f32, device=device),  # A = -exp(a_log)
        "w_b": _dense_init(gen, lead + (d, h, n), dt, d, device),
        "w_c": _dense_init(gen, lead + (d, h, n), dt, d, device),
        "w_os": _dense_init(gen, lead + (h, hd, d), dt, h * hd, device),
        "skip_d": torch.ones(lead + (h, hd), dtype=f32, device=device),  # D skip connection
    }


def _ssm_chunked(xs, dt, a, bmat, cmat, s0, *, chunk: int):
    """`linear_scan.ssm_chunked`; on DTensors, on each rank's (batch, heads)
    shard (`shardctx.on_local_shards`): DTensor's views of the scan's
    chunked tensors do not match their local shards where the heads do not
    divide the mesh."""
    if is_dtensor(xs):
        return on_local_shards(lambda *zs: linear_scan.ssm_chunked(*zs, chunk=chunk), (xs, dt, a, bmat, cmat, s0),
                               [(0, 2), (0, 2), (None, 0), (0, 2), (0, 2), (0, 1)], (xs.shape[2],),
                               [(0, 2), (0, 1)])
    return linear_scan.ssm_chunked(xs, dt, a, bmat, cmat, s0, chunk=chunk)


def _ssm_step(x, dt, a, bvec, cvec, s):
    """`linear_scan.ssm_step`; on DTensors, on each rank's (batch, heads)
    shard, as `_ssm_chunked`: DTensor cannot flatten (batch, heads) with
    the heads sharded (torch 2.11)."""
    if is_dtensor(x):
        return on_local_shards(linear_scan.ssm_step, (x, dt, a, bvec, cvec, s),
                               [(0, 1), (0, 1), (None, 0), (0, 1), (0, 1), (0, 1)], (x.shape[1],), [(0, 1), (0, 1)])
    return linear_scan.ssm_step(x, dt, a, bvec, cvec, s)


def ssm_branch(params, cfg: ModelConfig, x: torch.Tensor,
               s0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,D) -> (y (B,T,D), final state (B,H,N,P) f32)."""
    h, hd, n = cfg.n_heads, cfg.resolved_head_dim, cfg.ssm_state
    xs = constrain_alt(project_heads(x, params["w_xs"]),
                       ("batch", "none", "tp", "none"), ("batch", "none", "none", "tp"))
    dt = F.softplus(x.float() @ params["w_dt"] + params["dt_bias"])  # (B,T,H)
    a = -torch.exp(params["a_log"])
    bmat = project_heads(x, params["w_b"])
    cmat = project_heads(x, params["w_c"])

    if x.shape[1] == 1:  # decode
        if s0 is None:
            s0 = torch.zeros((x.shape[0], h, n, hd), dtype=torch.float32, device=x.device)
        y1, s_new = _ssm_step(xs[:, 0], dt[:, 0], a, bmat[:, 0], cmat[:, 0], s0)
        y = y1[:, None]
    else:
        chunk = min(cfg.wkv_chunk, x.shape[1])
        y, s_new = _ssm_chunked(xs, dt, a, bmat, cmat, s0, chunk=chunk)

    y = y.to(x.dtype) + xs * params["skip_d"].to(x.dtype)
    out = project_out(y, params["w_os"])
    return out, s_new


def hymba_mix_init(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    return {
        "attn": layers.attention_init(gen, cfg, device, lead),
        "ssm": ssm_branch_init(gen, cfg, device, lead),
        "norm_attn": torch.ones(lead + (cfg.d_model,), dtype=torch.float32, device=device),
        "norm_ssm": torch.ones(lead + (cfg.d_model,), dtype=torch.float32, device=device),
    }


def _branch_norm(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(torch.square(yf), dim=-1, keepdim=True) + 1e-6)
    return (yf * scale).to(y.dtype)


def hymba_mix_full(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                   window: int = 0, return_kv: bool = False):
    """Training/prefill: returns (y, final ssm state[, (k, v)])."""
    y_attn, kv = layers.attention_full(
        params["attn"], cfg, x, positions, causal=True, window=window, return_kv=True
    )
    y_ssm, s_new = ssm_branch(params["ssm"], cfg, x)
    y = 0.5 * (_branch_norm(y_attn, params["norm_attn"]) + _branch_norm(y_ssm, params["norm_ssm"]))
    if return_kv:
        return y, s_new, kv
    return y, s_new


def hymba_mix_decode(params, cfg: ModelConfig, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     ssm_state: torch.Tensor, pos: int, *, window: int = 0):
    """x (B,1,D).  Returns (y, cache_k, cache_v, ssm_state): the kv cache
    written in place (`layers.attention_decode`), the new state a new tensor."""
    y_attn, cache_k, cache_v = layers.attention_decode(
        params["attn"], cfg, x, cache_k, cache_v, pos, window=window
    )
    y_ssm, ssm_state = ssm_branch(params["ssm"], cfg, x, ssm_state)
    y = 0.5 * (_branch_norm(y_attn, params["norm_attn"]) + _branch_norm(y_ssm, params["norm_ssm"]))
    return y, cache_k, cache_v, ssm_state
