"""Analytic per-rank memory model for the dry-run report.

The port of `repro/roofline/memory.py`, on the port's sharding specs
(`launch/sharding.py`'s `Named` leaves, a spec tuple per leaf).  Beside the
traced peak of live storage (`launch/dryrun.py`) it reports what a rank of
the mesh holds by the model's own accounting:

  state      params + optimizer moments + controller prev_grad (exact, from
             the sharded state tree)
  grads      one transient params-sized buffer (worst case)
  residuals  train only: L x B_loc x T x D saved block inputs
             (remat: save block boundaries, recompute inside)
  transient  the largest single-block working set (attention score tile /
             MoE dispatch buffers / MLP hidden), one layer live at a time
  cache      decode only: KV cache / SSM state per rank

`fits_80gb` checks the total against one H100's 80 GB.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.sharding import MeshAxes

H100_BYTES = 80e9


def _sizes(mesh) -> Dict[str, int]:
    axes = MeshAxes.of(mesh)
    return dict(zip(axes.names, axes.sizes))


def _shard_factor(sharding, mesh) -> int:
    factor = 1
    spec = getattr(sharding, "spec", None)
    if spec is None:
        return 1
    sizes = _sizes(mesh)
    for dim_axes in spec:
        if dim_axes is None:
            continue
        axes = dim_axes if isinstance(dim_axes, tuple) else (dim_axes,)
        for a in axes:
            factor *= sizes[a]
    return factor


def sharded_bytes(tree: Any, shardings: Any, mesh) -> int:
    """Exact per-rank bytes of a tensor tree under its shardings (None
    leaves hold nothing)."""
    total = 0
    for leaf, sh in zip(tree_leaves(tree), tree_leaves(shardings), strict=True):
        if leaf is not None:
            total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // _shard_factor(sh, mesh)
    return total


def analytic_memory(
    cfg: ModelConfig,
    shape: InputShape,
    mesh,
    state: Any,
    state_shardings: Any,
    params: Any = None,
    params_shardings: Any = None,
    cache: Any = None,
    cache_shardings: Any = None,
    n_micro: int = 1,
) -> Dict[str, Any]:
    sizes = _sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    tp = sizes.get("model", 1)
    act_bytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    b_loc = max(shape.global_batch // dp // max(n_micro, 1), 1)
    t = shape.seq_len if shape.kind != "decode" else 1
    d = cfg.d_model

    out: Dict[str, Any] = {}
    out["state_bytes"] = sharded_bytes(state, state_shardings, mesh)

    if shape.kind == "train" and params is not None:
        gb = sharded_bytes(params, params_shardings, mesh)
        if n_micro > 1:  # accumulated grads are f32
            gb = sum(int(np.prod(leaf.shape)) * 4 // _shard_factor(sh, mesh)
                     for leaf, sh in zip(tree_leaves(params), tree_leaves(params_shardings)))
        out["grad_bytes"] = gb
        n_blocks = cfg.n_layers + cfg.encoder_layers
        sp = tp if (cfg.seq_parallel and t % tp == 0) else 1
        out["residual_bytes"] = n_blocks * b_loc * t * d * act_bytes // sp

    # largest transient inside one block (per rank).  Attention scores are
    # head-parallel when H divides |model|, else sequence(context)-parallel
    # when T divides; only if neither applies (decode with indivisible
    # heads) are they replicated across the model axis.
    h = cfg.n_heads
    attn_shard = tp if (h % tp == 0 or (t > 1 and t % tp == 0)) else 1
    s_ctx = t if shape.kind != "decode" else shape.seq_len
    if cfg.sliding_window:
        s_ctx = min(s_ctx, cfg.sliding_window)
    if cfg.attention_impl == "blocked" and t > 1:
        # online softmax over key blocks: live scores are (..., T, blk) and
        # the f32 accumulator is (..., T, hd)
        s_ctx = min(s_ctx, cfg.attention_block)
    ff_loc = cfg.d_ff // tp if cfg.d_ff % tp == 0 else cfg.d_ff
    attn_bytes = 0.0
    if cfg.family != "ssm":
        attn_bytes = 2.0 * b_loc * h * t * s_ctx * 4 / attn_shard
        if cfg.attention_impl == "blocked" and t > 1:
            attn_bytes += 2.0 * b_loc * h * t * cfg.resolved_head_dim * 4 / attn_shard
    candidates = [
        attn_bytes,
        3.0 * b_loc * t * ff_loc * act_bytes,
    ]
    if cfg.n_experts:
        e_loc = max(cfg.n_experts // tp, 1)
        cap = max(int(cfg.capacity_factor * t * cfg.moe_top_k / cfg.n_experts), 1)
        candidates.append(3.0 * e_loc * b_loc * cap * d * act_bytes)
    out["block_transient_bytes"] = float(max(candidates))

    if cache is not None:
        out["cache_bytes"] = sharded_bytes(cache, cache_shardings, mesh)

    out["total_bytes"] = float(
        sum(v for k, v in out.items() if k.endswith("_bytes") and k != "total_bytes")
    )
    out["fits_80gb"] = bool(out["total_bytes"] < H100_BYTES)
    return out
