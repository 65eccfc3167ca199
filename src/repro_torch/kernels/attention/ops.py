"""Public wrapper of the flash-attention kernel, in the model's layout.

The port of `repro/kernels/attention/ops.py::flash_attention`.  It takes
(B, T, H, hd) q and (B, S, KV, hd) k, v as the model holds them and hands the
kernel transposed views, so nothing is copied.  A CUDA tensor launches the
kernel (or raises); a CPU tensor, and only a CPU tensor, goes to the plain
version in `ref.py`, which autograd can differentiate.  The kernel is
forward-only: on a CUDA tensor under grad mode with an input that requires
grad it raises (`kernels.forbid_autograd`).  On the card the dtype picks the kernel
(`kernel.ROUTES`): bf16 the tensor-core kernel, f32 the scalar one.  The JAX
wrapper's `block_q`/`block_k` have no counterpart: each CUDA kernel fixes its
own tiles and masks ragged edges.

Under a mesh it takes DTensors (k and v may be plain tensors that every rank
holds whole).  A layout that shards T, S or hd is first redistributed to one
that shards only the batch and the heads (an explicit gather: the kernel
needs whole sequences), and the heads stay sharded only where H and KV both
divide by the mesh extent, so each rank's q heads keep their kv head.  The
kernel then runs on each rank's local shard, each launch counted.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.attention import kernel
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.shardctx import is_dtensor, on_local_shards

# Kernel launches (either route) since import or since a caller last set it to 0.
launches = 0


def flash_attention(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    global launches
    if is_dtensor(q):
        return _flash_attention_sharded(q, k, v, causal=causal, window=window)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kernel.check_inputs(qt, kt, vt, causal=causal)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    forbid_autograd("flash_attention", q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    kernel.flash_attention_bhtd(qt, kt, vt, causal=causal, window=window, out=out.transpose(1, 2))
    launches += 1
    return out


def _flash_attention_sharded(q, k, v, *, causal: bool, window: int):
    """`flash_attention` on DTensor q: each rank's (batch, heads) shard
    through the kernel (`shardctx.on_local_shards`)."""

    def local(ql, kl, vl):
        if ql.device.type == "cuda":
            ql, kl, vl = (_tma_ready(x) for x in (ql, kl, vl))
        return flash_attention(ql, kl, vl, causal=causal, window=window)

    return on_local_shards(local, (q, k, v), [(0, 2)] * 3, (q.shape[2], k.shape[2]), [(0, 2)])


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, T, H, hd), or a contiguous copy where the kernel's (B, H,
    T, hd) view of it is not a layout TMA reads."""
    xt = x.transpose(1, 2)
    if kernel.tma_layout_error(xt.shape, xt.stride(), xt.data_ptr(), xt.element_size()) is None:
        return x
    return x.contiguous()
