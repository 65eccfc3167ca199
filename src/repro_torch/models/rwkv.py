"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

A port of `repro/models/rwkv.py`: token-shift lerp inputs, per-channel
data-dependent decay w_t = exp(-exp(w0 + lora(x))) in f32, current-token
bonus u, per-head group normalization, and squared-ReLU channel mix with
receptance gating.  Parameter names, shapes and dtypes are the JAX
package's; every init takes a `lead` shape, e.g. (L,) for a stack of layers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import linear_scan
from repro_torch.models.layers import _dense_init, _dtype, project_heads, project_out
from repro_torch.shardctx import constrain, constrain_alt, gather_dims, grad_like, is_dtensor, on_local_shards

DECAY_LORA = 64
# r, k, v, g layouts: heads on the model axis, else the head dim
HEAD_LAYOUTS = (("batch", "none", "tp", "none"), ("batch", "none", "none", "tp"))


def _head_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, T, H, hd) in the first of `HEAD_LAYOUTS` that fits whole,
    else in the last one dim by dim.  Where none fits whole (a batch the
    data axis does not divide: long_500k's batch of 1), the reference leaves
    the layout to the compiler; DTensor would keep the FSDP contraction's
    partial sum and reduce-scatter it onto rwkv6-3b's 40 heads, which no
    16-way axis divides, and the output projection could not flatten them.
    No-op without a mesh."""
    y = constrain_alt(x, *HEAD_LAYOUTS)
    return constrain(y, *HEAD_LAYOUTS[-1]) if y is x else y


def time_mix_init(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    dt = _dtype(cfg.param_dtype)
    f32 = torch.float32
    return {
        "mu": torch.full(lead + (5, d), 0.5, dtype=f32, device=device),  # lerp weights for r,k,v,w,g
        "wr": _dense_init(gen, lead + (d, h, hd), dt, d, device),
        "wk": _dense_init(gen, lead + (d, h, hd), dt, d, device),
        "wv": _dense_init(gen, lead + (d, h, hd), dt, d, device),
        "wg": _dense_init(gen, lead + (d, h, hd), dt, d, device),
        "wo": _dense_init(gen, lead + (h, hd, d), dt, d, device),
        # data-dependent decay: w0 + tanh(x @ a1) @ a2
        "decay_w0": torch.full(lead + (h, hd), -1.0, dtype=f32, device=device),
        "decay_a1": _dense_init(gen, lead + (d, DECAY_LORA), f32, d, device),
        "decay_a2": _dense_init(gen, lead + (DECAY_LORA, h, hd), f32, DECAY_LORA, device),
        "bonus_u": _dense_init(gen, lead + (h, hd), f32, hd, device),
        "ln_out": torch.ones(lead + (h, hd), dtype=f32, device=device),  # per-head groupnorm scale
    }


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} sequence; position 0 uses x_prev (decode carry) or zeros."""
    if x.shape[1] == 1:
        return torch.zeros_like(x) if x_prev is None else x_prev[:, None, :]
    # a cat, not F.pad: torch 2.11's DTensor fails to propagate the pad of a
    # sequence-sharded x (an IndexError); the values are the same
    first = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _wkv6_chunked(r, k, v, w, u, s0, *, chunk: int):
    """`linear_scan.wkv6_chunked`; on DTensors, on each rank's (batch,
    heads) shard, or (batch, V) shard where the head dim is sharded
    (`shardctx.on_local_shards`, `linear_scan.WKV6_DIMS`), as the kernel's
    wrapper runs: DTensor's views of the scan's chunked tensors do not match
    their local shards where the heads do not divide the mesh."""
    if is_dtensor(r):
        return on_local_shards(lambda *xs: linear_scan.wkv6_chunked(*xs, chunk=chunk), (r, k, v, w, u, s0),
                               linear_scan.WKV6_DIMS[0], (r.shape[2],), linear_scan.WKV6_DIMS[1])
    return linear_scan.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)


def time_mix(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B,T,D)
    x_prev: Optional[torch.Tensor] = None,  # (B,D) carry
    s0: Optional[torch.Tensor] = None,  # (B,H,K,V) wkv state carry
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, new_x_prev, new_state): new_x_prev is x's last row."""
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    xs = _token_shift(x, x_prev)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xs, mu[i]) for i in range(5))

    r = _head_layout(project_heads(xr, params["wr"]))
    k = _head_layout(project_heads(xk, params["wk"]))
    v = _head_layout(project_heads(xv, params["wv"]))
    g = _head_layout(project_heads(xg, params["wg"]))
    # data-dependent decay (f32 for stability); on a mesh the LoRA's inner
    # activation keeps the batch's layout, and its product with decay_a2
    # the head layout of decay_w0 (`layers.project_heads`)
    lora = torch.tanh(constrain(xw.float() @ params["decay_a1"], "batch", "none", "none"))
    lora = project_heads(lora, params["decay_a2"])
    w = torch.exp(-torch.exp(params["decay_w0"][None, None] + lora))  # (B,T,H,hd) in (0,1)

    if x.shape[1] == 1:  # decode
        if s0 is None:
            s0 = torch.zeros((x.shape[0], h, hd, hd), dtype=torch.float32, device=x.device)
        y1, s_new = linear_scan.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], params["bonus_u"], s0)
        y = _head_layout(y1[:, None])  # a partial sum over the head dim's shards, reduced
    elif cfg.use_kernels:
        # imported here, as in the JAX package: kernels.wkv's plain version
        # imports this package's linear_scan
        from repro_torch.kernels.wkv import ops as wkv_ops

        y, s_new = wkv_ops.wkv6(r, k, v, w, params["bonus_u"], s0, chunk=cfg.wkv_chunk)
    else:
        y, s_new = _wkv6_chunked(r, k, v, w, params["bonus_u"], s0, chunk=min(cfg.wkv_chunk, x.shape[1]))

    # per-head groupnorm (scale only) + silu(g) gating.  On a mesh, where the
    # scan leaves y sharded on V, the mean over V is a sum across the ranks,
    # all-reduced, and the mean and the gated y keep their layouts in the
    # backward pass too (`shardctx.grad_like`), so that it gathers none of
    # y's operands; a decode step's y keeps DTensor's own layouts
    y = y.float()
    ms = torch.mean(torch.square(y), dim=-1, keepdim=True)
    if x.shape[1] > 1:
        ms = grad_like(gather_dims(ms, -1))
    y = y * torch.rsqrt(ms + 1e-6)
    y = (y * params["ln_out"]).to(x.dtype) * F.silu(g)
    if x.shape[1] > 1:
        y = grad_like(y)
    out = project_out(y, params["wo"])
    return out, x[:, -1], s_new


def channel_mix_init(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    return {
        "mu_c": torch.full(lead + (2, d), 0.5, dtype=torch.float32, device=device),
        "w_in": _dense_init(gen, lead + (d, f), dt, d, device),
        "w_out": _dense_init(gen, lead + (f, d), dt, f, device),
        "w_recept": _dense_init(gen, lead + (d, d), dt, d, device),
    }


def channel_mix(params, cfg: ModelConfig, x, x_prev=None):
    """Returns (y, new_x_prev)."""
    xs = _token_shift(x, x_prev)
    xk = _lerp(x, xs, params["mu_c"][0])
    xr = _lerp(x, xs, params["mu_c"][1])
    h = torch.square(F.relu(xk @ params["w_in"]))
    y = torch.sigmoid(xr @ params["w_recept"]) * (h @ params["w_out"])
    return y, x[:, -1]
