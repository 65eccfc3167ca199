"""Mixture-of-Experts layer: top-k router + GShard-style capacity-based
dispatch and combine.

A port of `repro/models/moe.py`.  Tokens are grouped by batch row; tokens
routed beyond an expert's capacity C = max(int(cf * S * top_k / E), 1) are
dropped (their combine weight is zero).  The four `moe_dispatch` forms of
the JAX package are kept: "einsum" (one-hot dispatch and combine), "gather"
(index dispatch, gathered combine), "hybrid" (index dispatch, one-hot
combine; what both MoE configs use) and "scatter" (index dispatch,
scatter-add combine).  The JAX package's sharding hints are no-ops without
a mesh and are left out.

Routing must match the reference exactly: the top-k takes ties lowest index
first (a stable descending sort, as `lax.top_k`), and queue positions are
integers.  The reference carries each expert's fill across the K slots in
a loop; here all slots are computed at once from its closed form (see
`route`).  The (G, S, E, C) one-hot contractions are built by one scatter
each, as each token's K experts differ.  Every scatter is out of place, so
`torch.autograd` and `torch.func.vmap` (LMSource) go through the layer.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, _dtype
from repro_torch.shardctx import constrain, is_dtensor, on_local_shards


def moe_init(gen: torch.Generator, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    """The router in f32, the experts in the parameter dtype; `lead`
    prefixes every shape, e.g. (L,) for a stack of layers."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = _dtype(cfg.param_dtype)
    p = {
        "router": _dense_init(gen, lead + (d, e), torch.float32, d, device),
        "w_in": _dense_init(gen, lead + (e, d, f), dt, d, device),
        "w_out": _dense_init(gen, lead + (e, f, d), dt, f, device),
    }
    if cfg.activation == "silu_glu":
        p["w_gate"] = _dense_init(gen, lead + (e, d, f), dt, d, device)
    return p


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(cfg.capacity_factor * tokens_per_group * cfg.moe_top_k / cfg.n_experts)
    return max(c, 1)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params, cfg: ModelConfig, x: torch.Tensor):
    """The router and the capacity assignment of `moe_layer`.

    x (G, S, D) -> (idxs, gates, positions, aux): idxs (K, G, S) expert ids,
    gates (K, G, S) f32 normalised top-k probabilities, zero where the
    token was dropped, positions (K, G, S) each token's place in its
    expert's queue (>= C when dropped), and the f32 load-balance loss."""
    g, s, _ = x.shape
    e, top_k = cfg.n_experts, cfg.moe_top_k
    c = _capacity(cfg, s)

    router_logits = x.float() @ params["router"]  # (G,S,E) f32
    probs = torch.softmax(router_logits, dim=-1)
    # lax.top_k: ties lowest index first
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :top_k], top_idx[..., :top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # capacity assignment.  The reference runs the K slots in turn: a token's
    # position is its rank among the slot's tokens routed to the same expert
    # (in sequence order) plus the expert's fill, and fill grows by the
    # tokens kept (position < C).  Since fill <= C, the kept count of slot j
    # is min(count_j, C - fill_j), so fill_k = min(sum_{j<k} count_j, C):
    # every slot at once, in the same integers.
    idxs = top_idx.permute(2, 0, 1)  # (K,G,S)
    onehot = (idxs[:, :, None, :] == torch.arange(e, device=x.device)[:, None]).to(torch.int32)  # (K,G,E,S)
    counts = onehot.sum(dim=-1)  # (K,G,E)
    fill = torch.clamp(torch.cumsum(counts, dim=0) - counts, max=c)
    rank = torch.gather(torch.cumsum(onehot, dim=-1), 2, idxs[:, :, None, :])[:, :, 0] - 1  # (K,G,S)
    positions = (rank + torch.gather(fill, 2, idxs)).to(torch.int64)
    gates = top_p.permute(2, 0, 1) * (positions < c).to(top_p.dtype)

    # load-balance aux loss (Switch/GShard): E * sum_e f_e * p_e
    f_e = _one_hot(top_idx[..., 0], e, torch.float32).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f_e * p_e)
    return idxs, gates, positions, aux


def moe_layer(params, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (y, aux_loss).  Groups = batch rows."""
    c = _capacity(cfg, x.shape[1])
    idxs, gates, positions, aux = route(params, cfg, x)
    if cfg.moe_dispatch == "gather":
        y = _dispatch_gather(params, cfg, x, idxs, gates, positions, c, combine="gather")
    elif cfg.moe_dispatch == "hybrid":
        # gather dispatch (no one-hot flops) + einsum combine
        y = _dispatch_gather(params, cfg, x, idxs, gates, positions, c, combine="einsum")
    elif cfg.moe_dispatch == "scatter":
        # gather dispatch + scatter-add combine: no (G,S,E,C) one-hot
        y = _dispatch_gather(params, cfg, x, idxs, gates, positions, c, combine="scatter")
    else:
        y = _dispatch_einsum(params, cfg, x, idxs, gates, positions, c)
    return y, aux


def _expert_ffn(params, cfg: ModelConfig, xin: torch.Tensor) -> torch.Tensor:
    """xin: (E, G, C, D) -> (E, G, C, D) through the per-expert MLP, as one
    batched product per weight over the experts."""
    e, g, c, d = xin.shape
    xe = xin.reshape(e, g * c, d)
    if cfg.activation == "silu_glu":
        h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_in"])
    else:  # jax.nn.gelu defaults to the tanh form
        h = F.gelu(torch.bmm(xe, params["w_in"]), approximate="tanh")
    return torch.bmm(h, params["w_out"]).reshape(e, g, c, d)


def _combine_weights(idxs, values, positions, e: int, c: int, dtype) -> torch.Tensor:
    """The (G, S, E, C) tensor sum_k onehot(e_k) onehot(pos_k) value_k, where
    a position >= C has a zero one-hot (`jax.nn.one_hot`).  Each token's K
    experts differ, so at most one k lands on any (g, s, e, c): one scatter
    builds it exactly (a dropped slot writes its zero at the clamped
    position, which no other k of the token shares)."""
    k, g, s = idxs.shape
    slot = (idxs * c + torch.clamp(positions, max=c - 1)).permute(1, 2, 0)  # (G,S,K)
    vals = torch.where(positions < c, values.to(dtype), 0).permute(1, 2, 0)
    return torch.zeros((g, s, e * c), dtype=dtype, device=idxs.device).scatter(2, slot, vals).reshape(g, s, e, c)


def _combine_einsum(comb: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """einsum("gsec,egcd->gsd"): one product per group over the E*C slots."""
    g, s, e, c = comb.shape
    out_g = out.permute(1, 0, 2, 3).reshape(g, e * c, out.shape[-1])
    return torch.bmm(comb.reshape(g, s, e * c), out_g)


def _dispatch_einsum(params, cfg, x, idxs, gates, positions, c):
    g, s, d = x.shape
    e = cfg.n_experts
    # dispatch/combine tensors (G, S, E, C); a dropped token's position is
    # >= C, so its position one-hot is zero and it is dispatched nowhere
    combine = _combine_weights(idxs, gates, positions, e, c, x.dtype)
    dispatch = _combine_weights(idxs, torch.ones_like(gates), positions, e, c, x.dtype)
    # tokens to experts: xin[e, g, c] = sum_s dispatch[g, s, e, c] x[g, s]
    xin = torch.bmm(dispatch.reshape(g, s, e * c).transpose(1, 2), x)  # (G, E*C, D)
    xin = xin.reshape(g, e, c, d).permute(1, 0, 2, 3)
    # expert-parallel over 'model': the dispatch is the all-to-all across it
    xin = constrain(xin, "experts", "batch", "none", "none")
    out = _expert_ffn(params, cfg, xin)
    out = constrain(out, "experts", "batch", "none", "none")
    return constrain(_combine_einsum(combine, out), "batch", "none", "none")


def _per_group(fn, xs, batch_dims, out_batch_dims):
    """``fn(*xs)``; on DTensors, on each rank's shard of the groups (the
    batch rows, dim ``batch_dims[j]`` of ``xs[j]``), with the groups on
    the batch axes first (`shardctx.on_local_shards`).  For the index work
    of the dispatch and the combine, which stays within a group: DTensor
    cannot flatten a (top-k, group, sequence) index with the groups
    sharded (torch 2.11)."""
    if not any(is_dtensor(x) for x in xs):
        return fn(*xs)
    xs = [constrain(x, *("batch" if i == bd else "none" for i in range(x.ndim))) for x, bd in zip(xs, batch_dims)]
    return on_local_shards(fn, xs, [(bd, None) for bd in batch_dims], (), [(bd, None) for bd in out_batch_dims])


def _slots(idxs, gates, positions, e: int, c: int):
    """to_slots(values, dtype) -> (G, E, C): the (K, G, S) ``values`` of
    the kept assignments in their expert slots, zero in empty slots.
    Dropped assignments go to a spare slot c == C, sliced off; every kept
    (g, e, c) is written once."""
    kk, g, s = idxs.shape
    dev = idxs.device
    g_ix = torch.arange(g, device=dev)[None, :, None].expand(kk, g, s)
    c_ix = torch.where(gates > 0, positions, c)
    flat = ((g_ix * e + idxs) * (c + 1) + c_ix).reshape(-1)

    def to_slots(values, dtype):
        zeros = torch.zeros(g * e * (c + 1), dtype=dtype, device=dev)
        return zeros.scatter(0, flat, values.reshape(-1)).reshape(g, e, c + 1)[:, :, :c]

    return to_slots


def _dispatch_local(x, idxs, gates, positions, e: int, c: int):
    """The dispatch on (G, S, D) tokens: xin (E, G, C, D), each expert
    slot's token (zero where the slot is empty), and token_source (G, E*C),
    the token each slot reads."""
    g, s, d = x.shape
    kk = idxs.shape[0]
    to_slots = _slots(idxs, gates, positions, e, c)
    s_ix = torch.arange(s, device=x.device)[None, None, :].expand(kk, g, s)
    token_source = to_slots(s_ix, torch.int64)
    slot_filled = to_slots(gates > 0, torch.bool)
    # one gather along S (within each group)
    idx_flat = token_source.reshape(g, e * c)
    xin = torch.gather(x, 1, idx_flat[:, :, None].expand(g, e * c, d))  # (G, E*C, D)
    xin = xin.reshape(g, e, c, d) * slot_filled[..., None].to(x.dtype)
    return xin.permute(1, 0, 2, 3), idx_flat


def _combine_scatter(out, idx_flat, idxs, gates, positions, s: int):
    """Scatter-add each filled slot's gated output (E, G, C, D) back to its
    token: (G, S, D)."""
    e, g, c, d = out.shape
    gate_slot = _slots(idxs, gates, positions, e, c)(gates.to(out.dtype), out.dtype)
    weighted = out.permute(1, 0, 2, 3) * gate_slot[..., None]  # (G, E, C, D)
    return torch.zeros((g, s, d), dtype=out.dtype, device=out.device).scatter_add(
        1, idx_flat[:, :, None].expand(g, e * c, d), weighted.reshape(g, e * c, d))


def _combine_gather(out, idxs, gates, positions):
    """One gather of all K expert outputs (E, G, C, D) per token, then a
    gate-weighted contraction over K: (G, S, D)."""
    e, g, c, d = out.shape
    top_k, _, s = idxs.shape
    out_gc = out.permute(1, 0, 2, 3).reshape(g, e * c, d)
    flat_slot = idxs * c + torch.clamp(positions, max=c - 1)  # (K,G,S)
    slot_gk = flat_slot.permute(1, 0, 2).reshape(g, top_k * s)
    picked = torch.gather(out_gc, 1, slot_gk[:, :, None].expand(g, top_k * s, d)).reshape(g, top_k, s, d)
    gates_gk = gates.permute(1, 0, 2).to(out.dtype)  # (G, K, S)
    return torch.einsum("gks,gksd->gsd", gates_gk, picked)


def _dispatch_gather(params, cfg, x, idxs, gates, positions, c, combine: str = "gather"):
    """Index-based dispatch: one gather along S per group.  The index work
    runs on each rank's groups (`_per_group`); the experts' FFN on the
    ("experts", "batch") layout.

    idxs/gates/positions: (K, G, S); dropped tokens have gate == 0."""
    s = x.shape[1]
    e = cfg.n_experts
    route_ = (idxs, gates, positions)
    xin, idx_flat = _per_group(lambda *a: _dispatch_local(*a, e, c), (x,) + route_, (0, 1, 1, 1), (1, 0))
    xin = constrain(xin, "experts", "batch", "none", "none")
    out = _expert_ffn(params, cfg, xin)
    out = constrain(out, "experts", "batch", "none", "none")

    if combine == "einsum":
        # the combine weights per group; the contraction over the experts'
        # slots is DTensor's, a partial sum over the experts' shards
        comb = _per_group(lambda *a: _combine_weights(*a, e, c, x.dtype), route_, (1, 1, 1), (0,))
        y = _combine_einsum(comb, out)
    elif combine == "scatter":
        y = _per_group(lambda *a: _combine_scatter(*a, s), (out, idx_flat) + route_, (1, 0, 1, 1, 1), (0,))
    else:
        y = _per_group(_combine_gather, (out,) + route_, (1, 1, 1, 1), (0,))
    return constrain(y, "batch", "none", "none")
