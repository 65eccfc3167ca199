"""Shared layers of the port: norms, RoPE, GQA attention (prefill and
KV-cache decode, self- and cross-attention), MLP variants, embeddings.

A port of `repro/models/layers.py`.  Functions
are pure over plain dicts of tensors whose leaf names and layouts are the
JAX package's: activations (B, T, H, hd), `wq` (d, h, hd), `wo` (h, hd, d).
The sharding hints (`shardctx.constrain`, `constrain_alt`) sit where the JAX
package has them; without a resolver, or on a plain tensor, each returns
its input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.shardctx import (all_reduce, block_of, constrain, constrain_alt, gather_dims, global_of, heads_step,
                                  is_dtensor, local_of, on_attention_shards, on_local_shards)

# ----------------------------------------------------------------------------
# init helpers


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _dense_init(gen: torch.Generator, shape, dtype, in_axis_size: int, device) -> torch.Tensor:
    """N(0, 1/in_axis_size) drawn in f32, as `layers._dense_init` of the JAX
    package; the bits differ from jax.random's.  A leaf of rank 3 or more
    (a stacked or per-head weight) is drawn slice by slice along its leading
    axis into a leaf of `dtype`, so no f32 temporary outgrows one slice:
    qwen3-moe-30b-a3b's stacked expert weights, (48, 128, 2048, 768), would
    need 38.7 GB in f32 at once."""
    scale = 1.0 / math.sqrt(in_axis_size)
    if len(shape) < 3:
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, dtype=torch.float32, device=device).mul_(scale)
    return out


# ----------------------------------------------------------------------------
# norms


def rmsnorm_init(cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    return {"scale": torch.ones(lead + (cfg.d_model,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * params["scale"]).to(dt)


# ----------------------------------------------------------------------------
# rotary embeddings


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, n, head_dim); positions: (T,) or broadcastable to (..., T).

    Rotates the two halves of the head (not interleaved pairs), with no
    frequency scaling, as the JAX package does."""
    hd = x.shape[-1]
    half = hd // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * freq  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over the head axis
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# attention


def attention_init(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    """`lead` prefixes every shape, e.g. (L,) for a stack of layers."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg.param_dtype)
    p = {
        "wq": _dense_init(gen, lead + (d, h, hd), dt, d, device),
        "wk": _dense_init(gen, lead + (d, kv, hd), dt, d, device),
        "wv": _dense_init(gen, lead + (d, kv, hd), dt, d, device),
        "wo": _dense_init(gen, lead + (h, hd, d), dt, h * hd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (h, hd), dtype=torch.float32, device=device)
        p["bk"] = torch.zeros(lead + (kv, hd), dtype=torch.float32, device=device)
        p["bv"] = torch.zeros(lead + (kv, hd), dtype=torch.float32, device=device)
    return p


def _head_dim_sharded(w: torch.Tensor, dim: int) -> bool:
    """Whether DTensor ``w`` shards its head dim ``dim`` (the sharding
    rules' alternative where the heads do not divide the model axis)."""
    return is_dtensor(w) and any(p.is_shard(dim) for p in w.placements)


def _project_heads_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`project_heads` where DTensor ``w`` shards its head dim: the einsum
    of each rank's batch rows of ``x`` with its head-dim columns of ``w``,
    every other dim gathered, and the (B, T, H, hd) result sharded as those
    two.  DTensor's own forms of this product fail on torch 2.11: it cannot
    flatten (heads, head dim) with the inner dim sharded ("Attempted to
    flatten multiple dimensions"), the backward of a matmul over (head dim,
    heads) views a transposed local gradient ("Cannot view a tensor"), and
    rwkv's decay LoRA came out partial where its bias is sharded
    ("redistribute from S(3) to P(sum)").  The gradients are partial sums:
    x's over the mesh dims that shard w, w's over those that shard x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    mesh = w.device_mesh
    wp = tuple(p if p.is_shard(2) else Replicate() for p in w.placements)
    xps = x.placements if is_dtensor(x) else (Replicate(),) * len(wp)
    xp = tuple(p if p.is_shard(0) and q.is_replicate() else Replicate() for p, q in zip(xps, wp))
    w_loc = w.redistribute(mesh, wp).to_local(grad_placements=tuple(
        Partial() if q.is_shard() else p for p, q in zip(wp, xp)))
    if is_dtensor(x):
        # no redistribute where x is laid out already: its backward would
        # reduce x's partial gradient here, once a projection, where the
        # caller's sum over q, k and v can reduce it once
        x_loc = (x if tuple(x.placements) == xp else x.redistribute(mesh, xp)).to_local(grad_placements=tuple(
            Partial() if q.is_shard() else p for p, q in zip(xp, wp)))
    else:
        x_loc = distribute_tensor(x, mesh, xp, src_data_rank=None).to_local()
    y = torch.einsum("btd,dhk->bthk", x_loc, w_loc)
    shape = torch.Size((x.shape[0], x.shape[1], w.shape[1], w.shape[2]))
    out = tuple(Shard(0) if p.is_shard() else Shard(3) if q.is_shard() else Replicate() for p, q in zip(xp, wp))
    return DTensor.from_local(y, mesh, out, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk", x, w): the projection to heads; on each
    rank's shard where ``w`` shards its head dim (its heads do not divide
    the model axis; `_project_heads_local`)."""
    if _head_dim_sharded(w, 2):
        return _project_heads_local(x, w)
    return torch.einsum("btd,dhk->bthk", x, w)


def project_out(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bthk,hkd->btd", y, w): the projection from heads, one matmul
    over the (head dim, heads) rows where ``w`` shards its head dim, the
    head dim outer (DTensor cannot flatten (heads, head dim) with the inner
    dim sharded), with y's head dim on the model axis as w's: the matmul
    flattens (batch, sequence), which torch 2.11 refuses where a
    context-parallel y shards the sequence."""
    if _head_dim_sharded(w, 1):
        h, k, d = w.shape
        y = constrain(y, "batch", "none", "none", "tp")
        # contiguous: torch 2.11's DTensor cannot view the transposed local
        # gradient back in the backward pass
        return y.transpose(-1, -2).contiguous().flatten(-2) @ w.transpose(0, 1).reshape(k * h, d)
    return torch.einsum("bthk,hkd->btd", y, w)


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor | None = None):
    """Project to q, k, v.  kv_x (if given) is the cross-attention memory
    that k and v are projected from."""
    src = x if kv_x is None else kv_x
    q = project_heads(x, params["wq"])
    k = project_heads(src, params["wk"])
    v = project_heads(src, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = constrain(q, "batch", "none", "tp", "none")
    k = constrain(k, "batch", "none", "tp", "none")
    v = constrain(v, "batch", "none", "tp", "none")
    return q, k, v


def _scale(hd: int) -> torch.Tensor:
    return torch.tensor(math.sqrt(hd), dtype=torch.float32)


def _sdpa(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """Scaled dot-product attention with GQA (kv repeated to H heads).

    Sharding strategy (constrain_alt picks the first divisible layout):
      1. head (tensor) parallel — H % |model| == 0 (qwen, nemotron, seamless)
      2. sequence/context parallel over the query axis — otherwise
         (llama 24H, hymba 25H, paligemma 8H on a 16-way model axis)
    q: (B,T,H,hd); k,v: (B,S,KV,hd); mask broadcastable to (B,H,T,S).

    On DTensors each rank runs its piece of that layout
    (`shardctx.on_attention_shards`): its q heads and the kv heads they
    read, or its rows of q and of the mask with k and v whole; a decode
    step (T = 1) runs on the cache's own layout (`_sdpa_decode_sharded`).
    DTensor lowers these einsums to views that flatten (batch, heads),
    which it refuses for sharded heads."""
    if is_dtensor(q):
        if q.shape[1] == 1:
            return _sdpa_decode_sharded(cfg, q, k, v, mask)
        out = on_attention_shards(lambda ql, kl, vl, t0: _sdpa(cfg, ql, kl, vl, _mask_rows(mask, t0, ql.shape[1])),
                                  q, k, v)
        return constrain_alt(out, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if t == 1:
        return _sdpa_decode_grouped(q, k, v, mask, kvh, g, hd)
    if g > 1:  # jnp.repeat: each kv head g times in a row
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    q = constrain_alt(q, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))
    k = constrain_alt(k, ("batch", "none", "tp", "none"), ("batch", "none", "none", "none"))
    v = constrain_alt(v, ("batch", "none", "tp", "none"), ("batch", "none", "none", "none"))
    scores = torch.einsum("bthk,bshk->bhts", q, k).float()
    scores = scores / _scale(hd)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    scores = constrain_alt(scores, ("batch", "tp", "none", "none"), ("batch", "none", "tp", "none"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshk->bthk", probs, v)
    return constrain_alt(out, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))


def _sdpa_decode_grouped(q, k, v, mask, kvh: int, g: int, hd: int) -> torch.Tensor:
    """Decode attention without the GQA repeat: q heads grouped per kv
    head, so the cache keeps its own layout — kv-head-sharded when kv
    divides |model|, sequence-sharded otherwise."""
    b, t = q.shape[:2]
    k = constrain_alt(k, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))
    v = constrain_alt(v, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))
    qg = q.reshape(b, t, kvh, g, hd)
    scores = torch.einsum("btngk,bsnk->bngts", qg, k).float()
    scores = scores / _scale(hd)
    if mask is not None:  # (..., T, S)-broadcastable
        m = mask[:, None] if mask.dim() == 4 else mask
        scores = torch.where(m, scores, torch.finfo(torch.float32).min)
    scores = constrain_alt(scores, ("batch", "tp", "none", "none", "none"), ("batch", "none", "none", "none", "tp"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngts,bsnk->btngk", probs, v)
    return out.reshape(b, t, kvh * g, hd)


def _mask_rows(mask, t0: int, t: int):
    """Query rows [t0, t0 + t) of a mask broadcastable to (B, H, T, S)."""
    if mask is None or mask.dim() < 2 or mask.shape[-2] == 1:
        return mask
    return mask[..., t0:t0 + t, :]


def _sdpa_decode_sharded(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """`_sdpa` of one query position on DTensors, in the layout the cache
    already has (`launch.sharding.CACHE_ALTS` places it), as the
    reference's `_sdpa_decode_grouped` keeps it: where its kv heads are
    sharded, each rank attends to its kv heads with their q groups; where
    its sequence is, each rank scores its own slots and the softmax runs
    across the shards (`_sdpa_decode_partial`), so the cache is never
    gathered.  Elsewhere the cache's heads are gathered
    (`on_local_shards`)."""
    from torch.distributed.tensor import Replicate, Shard

    kp = tuple(k.placements) if is_dtensor(k) else ()
    by_heads = [i for i, p in enumerate(kp) if p.is_shard(2)]
    by_slots = [i for i, p in enumerate(kp) if p.is_shard(1)]
    if any(p.is_partial() or p.is_shard(3) for p in kp) or bool(by_heads) == bool(by_slots):
        return on_local_shards(lambda *qkv: _sdpa(cfg, *qkv, mask), (q, k, v), [(0, 2)] * 3,
                               (q.shape[2], k.shape[2]), [(0, 2)])
    mesh = k.device_mesh
    rank, extent = block_of(mesh, by_heads or by_slots)
    qp = tuple(Shard(0) if p.is_shard(0) else Shard(2) if i in by_heads else Replicate() for i, p in enumerate(kp))
    ql, kl, vl = local_of(q, mesh, qp), local_of(k, mesh, kp), local_of(v, mesh, kp)
    if by_heads:
        out = heads_step(lambda *qkv: _sdpa(cfg, *qkv[:3], mask), ql, kl, vl, q.shape[2], k.shape[2], rank, extent)
    else:
        out = _sdpa_decode_partial(ql, kl, vl, _mask_slots(mask, rank * kl.shape[1], kl.shape[1], k.shape[1]),
                                   [(mesh, i) for i in by_slots])
    return global_of(out, mesh, qp)


def _mask_slots(mask, s0: int, sl: int, s: int):
    """Cache slots [s0, s0 + sl) of a mask broadcastable to (..., S)."""
    if mask is None or mask.shape[-1] != s:
        return mask
    return mask[..., s0:s0 + sl]


def _sdpa_decode_partial(q, k, v, mask, groups) -> torch.Tensor:
    """Grouped decode attention (`_sdpa_decode_grouped`) over one rank's
    cache slots, the rest on the ranks of ``groups``: the scores' max is
    all-reduced, then the sum of exp(score - max) and the f32 numerator
    P·V in one all-reduce, (B, H) and (B, H, hd) a rank and layer."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, hd)
    scores = torch.einsum("btngk,bsnk->bngts", qg, k).float() / _scale(hd)
    if mask is not None:
        scores = torch.where(mask[:, None] if mask.dim() == 4 else mask, scores, torch.finfo(torch.float32).min)
    top = all_reduce(scores.amax(dim=-1), "max", groups)
    p = torch.exp(scores - top[..., None])
    num = torch.einsum("bngts,bsnk->btngk", p, v.float())
    sums = all_reduce(torch.cat([num, p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]], dim=-1), "sum", groups)
    return (sums[..., :hd] / sums[..., hd:]).reshape(b, t, h, hd).to(v.dtype)


def _sdpa_blocked(cfg: ModelConfig, q, k, v, *, causal: bool, window: int, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over key blocks (a plain-PyTorch flash
    equivalent, the model's own algorithm as the JAX package writes it at
    XLA level, not a kernel).

    Never materializes the (T,S) score matrix: a loop over S/blk key blocks
    carries the running max m, denominator l and numerator acc in f32, the
    flash kernel's recurrence.  ``blk = min(cfg.attention_block, S)``, and a
    single block when it does not divide S.  Each block's body is recomputed
    in the backward pass (`torch.utils.checkpoint`, the reference's
    `jax.checkpoint`), so the peak transient is (B,H,T,blk) instead of
    (B,H,T,S).  ``q_offset`` is the position of q's first row.  On DTensors
    each rank runs its piece of `_sdpa`'s layout, its rows of q offset by
    their first position.
    """
    if is_dtensor(q):
        out = on_attention_shards(lambda ql, kl, vl, t0: _sdpa_blocked(cfg, ql, kl, vl, causal=causal, window=window,
                                                                       q_offset=t0), q, k, v)
        return constrain_alt(out, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))
    b, t, h, hd = q.shape
    s = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    q = constrain_alt(q, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))
    blk = min(cfg.attention_block, s)
    if s % blk:
        blk = s  # fallback: single block
    qf = q.float() / _scale(hd)
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]

    def body(m_prev, l_prev, acc, kc, vc, ki: int):
        scores = torch.einsum("bthk,bshk->bhts", qf, kc.float())
        kpos = ki * blk + torch.arange(blk, device=q.device)[None, :]
        mask = torch.ones((t, blk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (qpos - kpos < window)
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m_prev, scores.amax(dim=-1))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l_new = l_prev * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhts,bshk->bthk", p.to(vc.dtype), vc).float().permute(0, 2, 1, 3)
        return m_new, l_new, acc

    # jax.checkpoint's counterpart; it is unreliable under a torch.func
    # transform, where the body runs as it is
    remat = torch.is_grad_enabled() and torch._C._functorch.maybe_current_level() is None
    m = torch.full((b, h, t), -1e30, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, hd), dtype=torch.float32, device=q.device)
    for i in range(s // blk):
        kc, vc = k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk]
        if remat:
            m, l_sum, acc = torch.utils.checkpoint.checkpoint(body, m, l_sum, acc, kc, vc, i, use_reentrant=False)
        else:
            m, l_sum, acc = body(m, l_sum, acc, kc, vc, i)
    out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
    out = out.permute(0, 2, 1, 3).to(q.dtype)  # (B,T,H,hd)
    return constrain_alt(out, ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none"))


def causal_window_mask(t: int, s: int, offset: int, window: int, device=None) -> torch.Tensor:
    """(T,S) mask: query position i (global pos offset+i) may see key j
    iff j <= offset+i and (window==0 or offset+i-j < window)."""
    qpos = offset + torch.arange(t, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (qpos - kpos < window)
    return m


def attention_full(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    kv_x: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    return_kv: bool = False,
):
    """Full-sequence attention: training, prefill, the bidirectional encoder
    (``causal=False``) and cross-attention over the memory ``kv_x`` (no RoPE,
    no mask).  Causal self-attention over a multiple of 128 positions goes
    through the flash-attention kernel when `cfg.use_kernels`, as the JAX
    package's `use_pallas` path does; otherwise ``attention_impl="blocked"``
    takes `_sdpa_blocked` for self-attention over more than one position,
    and the rest the naive path."""
    q, k, v = _qkv(params, cfg, x, kv_x)
    if kv_x is None:  # self-attention: RoPE on both sides
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_positions is None else kv_positions, cfg.rope_theta)
    if cfg.use_kernels and kv_x is None and causal and x.shape[1] % 128 == 0:
        out = attn_ops.flash_attention(q, k, v, causal=True, window=window)
    elif cfg.attention_impl == "blocked" and kv_x is None and x.shape[1] > 1:
        out = _sdpa_blocked(cfg, q, k, v, causal=causal, window=window)
    else:
        mask = causal_window_mask(x.shape[1], k.shape[1], 0, window, x.device) if causal else None
        out = _sdpa(cfg, q, k, v, mask)
    y = project_out(out, params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache_k: torch.Tensor,  # (B, S, KV, hd)
    cache_v: torch.Tensor,
    pos: int,  # number of tokens already in the cache
    *,
    window: int = 0,
    kv_x: torch.Tensor | None = None,
):
    """Single-token decode against a KV cache.

    With window > 0 the cache is a ring buffer of length `window` (slot =
    pos % window); otherwise the cache has length seq_len and slot = pos.
    Unlike the JAX package, which returns updated copies, this writes the new
    k, v into `cache_k`, `cache_v` in place (saving a copy of the cache per
    layer and step) and returns them.  A slot past the cache's end raises,
    where jax.lax.dynamic_update_slice would clamp it to the last slot.
    With ``kv_x`` (cross-attention over a static memory) the token attends to
    the memory and the cache is returned untouched.
    """
    if kv_x is not None:
        return _cross_decode(params, cfg, x, kv_x), cache_k, cache_v
    pos = int(pos)
    q, k, v = _qkv(params, cfg, x)
    posv = torch.tensor([pos], device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)

    s = cache_k.shape[1]
    slot = pos % window if window else pos
    if slot >= s:
        raise ValueError(f"decode slot {slot} is past the cache length {s}; pad the cache first")
    _write_slot(cache_k, slot, k)
    _write_slot(cache_v, slot, v)

    kpos = torch.arange(s, device=x.device)
    if window:
        # ring buffer: valid slots are those written within the last `window` steps
        valid = (kpos <= slot) | (pos >= s)  # once full, all slots valid
    else:
        valid = kpos <= pos
    mask = valid[None, None, None, :]  # (1,1,1,S) -> broadcast over (B,H,T)
    y = _sdpa(cfg, q, cache_k, cache_v, mask)
    y = project_out(y, params["wo"])
    return y, cache_k, cache_v


def _write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """cache[:, slot] = new[:, 0], in place.  On a DTensor cache each rank
    writes into its own shard, and where the cache's sequence is sharded
    only the rank that holds the slot writes."""
    if not is_dtensor(cache):
        cache[:, slot] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    split = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
    rank, _ = block_of(mesh, split)
    local = cache.to_local()
    sl = local.shape[1]
    if slot // sl == rank:
        want = tuple(Replicate() if p.is_shard(1) else p for p in cache.placements)
        local[:, slot - rank * sl] = local_of(new, mesh, want)[:, 0].to(cache.dtype)


def _cross_decode(params, cfg: ModelConfig, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over the whole memory: k and v are
    projected from it on every call, as the JAX package does."""
    q, k, v = _qkv(params, cfg, x, memory)
    out = _sdpa(cfg, q, k, v, None)
    return project_out(out, params["wo"])


# ----------------------------------------------------------------------------
# MLPs


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    if cfg.activation == "silu_glu":
        return {
            "w_gate": _dense_init(gen, lead + (d, f), dt, d, device),
            "w_in": _dense_init(gen, lead + (d, f), dt, d, device),
            "w_out": _dense_init(gen, lead + (f, d), dt, f, device),
        }
    return {
        "w_in": _dense_init(gen, lead + (d, f), dt, d, device),
        "w_out": _dense_init(gen, lead + (f, d), dt, f, device),
    }


def mlp(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "silu_glu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_in"])
    elif cfg.activation == "sq_relu":  # Nemotron-4: squared ReLU
        h = torch.square(F.relu(x @ params["w_in"]))
    elif cfg.activation == "gelu":  # jax.nn.gelu defaults to the tanh form
        h = F.gelu(x @ params["w_in"], approximate="tanh")
    else:
        raise ValueError(f"unknown activation {cfg.activation}")
    return h @ params["w_out"]


# ----------------------------------------------------------------------------
# embedding / unembedding


def embed_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    dt = _dtype(cfg.param_dtype)
    p = {"embed": _dense_init(gen, (v, d), dt, d, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense_init(gen, (d, v), dt, d, device)
    return p


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]
    if is_dtensor(table):
        # The lookup runs on the vocab-gathered table: DTensor's
        # vocab-parallel F.embedding (a masked partial sum) fails to combine
        # with the tied logits' partial gradient, and masks the wrong rows
        # for batch-sharded token ids.
        return F.embedding(gather_dims(tokens, 0), gather_dims(table, 0)).to(_dtype(cfg.compute_dtype))
    return table[tokens].to(_dtype(cfg.compute_dtype))


def logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """All padded-vocab columns, unmasked, in f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w.to(x.dtype)).float()
