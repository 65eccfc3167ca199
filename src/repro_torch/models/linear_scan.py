"""Chunked linear-attention scans, plain PyTorch: RWKV-6 and the
Mamba2-style SSM of Hymba.

A port of `repro/models/linear_scan.py`.  RWKV-6:

      S_t = diag(w_t) S_{t-1} + k_t v_t^T          S in R^{K x V} per head
      y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

computed chunkwise, as the JAX package's `lax.scan` over the T/C chunks:
the intra-chunk term is a decay-weighted attention-like product, the
inter-chunk term applies the carried state.  Every term but the state's
recurrence is computed for all chunks at once; a Python loop over the
chunks carries only the state (two operations a chunk).
These are the plain versions of the wkv CUDA kernel (`kernels/wkv`), and
what the model runs with `use_kernels=False`.  `ssm_chunked` and
`ssm_step` (Hymba's SSM heads) are plain PyTorch on every device, as the
JAX package's are XLA-level: no TPU kernel lies behind them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


# The (batch, head[, value]) dims of each scan's arguments and outputs, as
# `shardctx.on_local_shards` takes them: the scans are independent across
# the batch, the heads and the value side of a head (wkv's V: y[..., v] and
# S[..., :, v] read only v[..., v], with r, k, w and u whole; the SSM's P:
# y[..., p] and its state read only x[..., p], with dt, a, B and C whole).
WKV6_DIMS = ([(0, 2), (0, 2), (0, 2, 3), (0, 2), (None, 0), (0, 1, 3)], [(0, 2, 3), (0, 1, 3)])
SSM_DIMS = ([(0, 2, 3), (0, 2), (None, 0), (0, 2), (0, 2), (0, 1, 3)], [(0, 2, 3), (0, 1, 3)])


def _straddle_levels(chunk: int):
    """Host-side (chunk is static) straddle-boundary pairing: every ordered
    pair tau < t straddles a unique power-of-two-aligned boundary (the odd
    multiple of the largest 2^j in (tau, t]).  Factoring each score as
    exp(lwe_t - li_ref) * exp(li_ref - lwi_tau) with the reference at that
    boundary keeps both exponents <= 0 (partial decay sums), so nothing can
    overflow f32 at any decay strength.  Returns [(is_q, mref, pair_mask)]."""
    pos = np.arange(chunk)
    levels = []
    lev = 1
    while lev < chunk:
        blkpos = pos // lev
        is_q = (blkpos % 2) == 1  # second half of its 2*lev-block -> query side
        mref = np.where(is_q, blkpos * lev, (blkpos + 1) * lev) - 1  # (C,)
        # A key-side block that runs past the end of a chunk that is not a
        # power of two has no query partner: clamp its reference row, as
        # JAX's gather clamps an index past the end.
        mref = np.minimum(mref, chunk - 1)
        tb, taub = blkpos[:, None], blkpos[None, :]
        pair_mask = (tb // 2 == taub // 2) & (tb % 2 == 1) & (taub % 2 == 0)
        levels.append((is_q, mref, pair_mask))
        lev *= 2
    return levels


def wkv6_chunked(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    w: torch.Tensor,  # (B, T, H, K)  decay in (0,1)
    u: torch.Tensor,  # (H, K)        current-token bonus
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V) initial state
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 wkv with data-dependent diagonal decay.  Returns (y (B,T,H,V)
    f32, s_T (B,H,K,V) f32).

    Computed in float32; decays in log space with log(max(w, 1e-20)); the
    intra-chunk scores use the straddle-boundary factorization of the JAX
    package (one masked product per power-of-two level, every exponent <= 0).

    The chunks' own terms (the decay sums, the scores, the u bonus, the
    intra-chunk output and each chunk's state contribution) are batched
    over a chunk axis, then a loop carries the state, then the inter-chunk
    output is one product.  On the CPU the result is that of a loop doing
    every term chunk by chunk bit for bit, and so are the gradients but u's
    (one sum over every chunk, where the loop added chunk by chunk) and, at
    B = 1, r's and w's: within 3e-7 of their max
    (tests/test_torch_lane_invariance.py).
    """
    b, t, h, kdim = k.shape
    vdim = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    nc = t // chunk
    f32 = torch.float32
    r, k, v, w = (a.to(f32) for a in (r, k, v, w))
    u = u.to(f32)
    dev = k.device

    rs = r.reshape(b, nc, chunk, h, kdim)
    ks = k.reshape(b, nc, chunk, h, kdim)
    vs = v.reshape(b, nc, chunk, h, vdim)
    ws = w.reshape(b, nc, chunk, h, kdim)

    logw = torch.log(torch.clamp(ws, min=1e-20))
    lw_inc = torch.cumsum(logw, dim=2)  # inclusive cumulative log-decay, (B,NC,C,H,K)
    lw_exc = lw_inc - logw  # exclusive
    lwt = lw_inc[:, :, -1]  # (B,NC,H,K): a whole chunk's log-decay
    # the inter-chunk factor before the levels: autograd sums a gradient in
    # the reverse order of its input's uses, and with this order of uses it
    # sums them as a chunk-by-chunk loop does (bit for bit on the CPU)
    r_inter = rs * torch.exp(lw_exc)

    # intra-chunk: scores[t,tau] = sum_k r_t[k] k_tau[k] exp(lwe_t[k]-lwi_tau[k]), tau < t
    neg_inf = torch.tensor(-torch.inf, dtype=f32, device=dev)
    scores = torch.zeros((b, nc, h, chunk, chunk), dtype=f32, device=dev)  # c=query d=key
    for is_q, mref, pair_mask in _straddle_levels(chunk):
        qsel = torch.from_numpy(is_q).to(dev)[:, None, None]
        li_ref = lw_inc[:, :, torch.from_numpy(mref).to(dev)]  # (B,NC,C,H,K): reference row per position
        # exponents are <= 0 by construction for active rows; exp(-inf)=0
        # silences the opposite side (its pairs are masked out anyway).
        e_q = torch.where(qsel, torch.clamp(lw_exc - li_ref, max=0.0), neg_inf)
        e_k = torch.where(qsel, neg_inf, torch.clamp(li_ref - lw_inc, max=0.0))
        part = torch.einsum("bzchk,bzdhk->bzhcd", rs * torch.exp(e_q), ks * torch.exp(e_k))
        scores = scores + torch.where(torch.from_numpy(pair_mask).to(dev), part, 0.0)
    # current-token bonus: the diagonal term u
    bonus = torch.einsum("bzchk,hk,bzchk->bzch", rs, u, ks)
    y_intra = torch.einsum("bzhcd,bzdhv->bzchv", scores, vs) + bonus[..., None] * vs
    # each chunk's own state contribution: sum_tau (prod_{tau<l<=C} w_l) k_tau v_tau^T
    k_carry = ks * torch.exp(lwt[:, :, None] - lw_inc)  # (B,NC,C,H,K)
    ds = torch.einsum("bzchk,bzchv->bzhkv", k_carry, vs)  # (B,NC,H,K,V)

    # the state carried into each chunk: S' = diag(exp(lwt)) S + ds
    decay = torch.exp(lwt)[..., None]  # (B,NC,H,K,1)
    s = torch.zeros((b, h, kdim, vdim), dtype=f32, device=dev) if s0 is None else s0.to(f32)
    carried = []
    for c in range(nc):
        carried.append(s)
        s = decay[:, c] * s + ds[:, c]
    # inter-chunk: y_t += (r_t * exp(lw_exc_t)) @ S
    y_inter = torch.einsum("bzchk,bzhkv->bzchv", r_inter, torch.stack(carried, dim=1))
    y = (y_inter + y_intra).reshape(b, t, h, vdim)
    return y, s


def wkv6_step(r, k, v, w, u, s):
    """Single-token RWKV-6 update (decode).  Shapes: r/k/w (B,H,K), v (B,H,V),
    u (H,K), s (B,H,K,V).  Returns (y (B,H,V), s'), both f32."""
    f32 = torch.float32
    r, k, v, w = (a.to(f32) for a in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = torch.einsum("bhk,bhkv->bhv", r, s + u.to(f32)[None, :, :, None] * kv)
    s_new = w[..., None] * s + kv
    return y, s_new


def ssm_chunked(
    x: torch.Tensor,  # (B, T, H, P)  per-head inputs
    dt: torch.Tensor,  # (B, T, H)     positive step sizes
    a: torch.Tensor,  # (H,)          negative decay rates (A)
    bmat: torch.Tensor,  # (B, T, H, N) input projections  (B_t)
    cmat: torch.Tensor,  # (B, T, H, N) output projections (C_t)
    s0: Optional[torch.Tensor] = None,  # (B, H, N, P)
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2-style chunked scan with a scalar per-head decay a_t = exp(a *
    dt_t) (Hymba's SSM heads):

          S_t = a_t S_{t-1} + dt_t b_t x_t^T        S in R^{N x P} per head
          y_t = c_t S_t

    The reference's per-chunk terms, with the chunk loop split by what
    depends on the carried state: the intra-chunk outputs and each chunk's
    own state contribution for all chunks at once, then a loop over the T/C
    chunks that carries the state (two operations a chunk), then the
    inter-chunk outputs at once.  Returns (y (B,T,H,P) f32, s_T (B,H,N,P)
    f32)."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    nc = t // chunk
    f32 = torch.float32
    x, dt, bmat, cmat = (z.to(f32) for z in (x, dt, bmat, cmat))
    a = a.to(f32)
    dev = x.device

    xs_ = x.reshape(b, nc, chunk, h, p)
    dts = dt.reshape(b, nc, chunk, h)
    bs = bmat.reshape(b, nc, chunk, h, n)
    cs = cmat.reshape(b, nc, chunk, h, n)

    la = a * dts  # log-decay per step (B,NC,C,H), <= 0
    li = torch.cumsum(la, dim=2)  # inclusive
    lt = li[:, :, -1]  # (B,NC,H)

    # intra-chunk: y_t reads the post-update state S_t, so tau <= t
    cm = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    liq = li.transpose(2, 3)  # (B,NC,H,C)
    # masked (future) exponents are positive and can overflow: where, not *
    pair = torch.exp(torch.where(cm, liq[..., :, None] - liq[..., None, :], 0.0))
    scores = torch.where(cm, torch.einsum("bzchn,bzdhn->bzhcd", cs, bs) * pair, 0.0)
    xin = xs_ * dts[..., None]  # (B,NC,C,H,P)
    y_intra = torch.einsum("bzhcd,bzdhp->bzchp", scores, xin)
    # each chunk's own contribution to the state: sum_tau exp(lt - li_tau) dt_tau b_tau x_tau^T
    b_carry = bs * torch.exp(lt[:, :, None] - li)[..., None]
    ds = torch.einsum("bzchn,bzchp->bzhnp", b_carry, xin)  # (B,NC,H,N,P)

    # the state carried into each chunk: S' = exp(lt) S + ds
    decay = torch.exp(lt)[..., None, None]  # (B,NC,H,1,1)
    s = torch.zeros((b, h, n, p), dtype=f32, device=dev) if s0 is None else s0
    carried = []
    for c in range(nc):
        carried.append(s)
        s = decay[:, c] * s + ds[:, c]
    # inter-chunk: the carried state decays by the inclusive cumulative decay li
    y_inter = torch.einsum("bzchn,bzhnp->bzchp", cs * torch.exp(li)[..., None], torch.stack(carried, dim=1))
    y = (y_inter + y_intra).reshape(b, t, h, p)
    return y, s


def ssm_step(x, dt, a, bvec, cvec, s):
    """Single-token SSM update.  x (B,H,P), dt (B,H), a (H,), b/c (B,H,N),
    s (B,H,N,P) -> (y (B,H,P), s'), both f32."""
    f32 = torch.float32
    x, dt, bvec, cvec = (z.to(f32) for z in (x, dt, bvec, cvec))
    decay = torch.exp(a.to(f32)[None, :] * dt)  # (B,H)
    s_new = decay[..., None, None] * s + torch.einsum("bhn,bhp->bhnp", bvec, x * dt[..., None])
    y = torch.einsum("bhn,bhnp->bhp", cvec, s_new)
    return y, s_new
