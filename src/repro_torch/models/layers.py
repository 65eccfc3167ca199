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
from repro_torch.shardctx import constrain, constrain_alt, gather_dims, is_dtensor, on_local_shards

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


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk", x, w): the projection to heads.  Where ``w``
    shards its head dim (its heads do not divide the model axis), the
    product is one matmul over the (head dim, heads) columns, the head dim
    outer: DTensor cannot flatten (heads, head dim) with the inner dim
    sharded (torch 2.11: "Attempted to flatten multiple dimensions"), nor
    unflatten it (torch 2.13), and einsum orders the two dims as it likes."""
    if _head_dim_sharded(w, 2):
        d, h, k = w.shape
        y = x @ w.transpose(1, 2).reshape(d, k * h)
        return y.unflatten(-1, (k, h)).transpose(-1, -2)
    return torch.einsum("btd,dhk->bthk", x, w)


def project_out(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bthk,hkd->btd", y, w): the projection from heads, one matmul
    over the (head dim, heads) rows where ``w`` shards its head dim (see
    `project_heads`), with y's head dim on the model axis as w's: the
    matmul flattens (batch, sequence), which torch 2.11 refuses where a
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

    On DTensors it runs on each rank's (batch, heads) shard
    (`shardctx.on_local_shards`; other layouts are gathered first): the
    attention of a (batch row, head) needs no other, and DTensor lowers
    these einsums to views that flatten (batch, heads), which it refuses
    for sharded heads."""
    if is_dtensor(q):
        out = on_local_shards(lambda *qkv: _sdpa(cfg, *qkv, mask), (q, k, v), [(0, 2)] * 3,
                              (q.shape[2], k.shape[2]), [(0, 2)])
        if q.shape[1] == 1:
            return out
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


def _sdpa_blocked(cfg: ModelConfig, q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """Online-softmax attention over key blocks (a plain-PyTorch flash
    equivalent, the model's own algorithm as the JAX package writes it at
    XLA level, not a kernel).

    Never materializes the (T,S) score matrix: a loop over S/blk key blocks
    carries the running max m, denominator l and numerator acc in f32, the
    flash kernel's recurrence.  ``blk = min(cfg.attention_block, S)``, and a
    single block when it does not divide S.  Each block's body is recomputed
    in the backward pass (`torch.utils.checkpoint`, the reference's
    `jax.checkpoint`), so the peak transient is (B,H,T,blk) instead of
    (B,H,T,S).  On DTensors it runs on each rank's (batch, heads) shard,
    as `_sdpa` does.
    """
    if is_dtensor(q):
        out = on_local_shards(lambda *qkv: _sdpa_blocked(cfg, *qkv, causal=causal, window=window), (q, k, v),
                              [(0, 2)] * 3, (q.shape[2], k.shape[2]), [(0, 2)])
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
    qpos = torch.arange(t, device=q.device)[:, None]

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
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

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
