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

The CUDA launch is the custom op ``repro_torch::flash_attention``
(`torch.library`) wherever a dispatch mode is active, so a trace on fake
CUDA tensors (the dry run, `launch/dryrun.py`) or under the roofline's
counter passes through the card's program, without launching on fakes:
its fake implementation gives the output's shape, dtype and layout, and its
FLOP formula (`torch.utils.flop_counter`) the count the bound in PERF.md
uses, 4 hd flops for each visible (query, key) pair.  The launch count rises
in the CUDA implementation alone, so a fake trace counts none.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.attention import kernel
from repro_torch.kernels.attention.ref import attention_ref, visible_pairs
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
    if is_dtensor(q):
        return _flash_attention_sharded(q, k, v, causal=causal, window=window)
    kernel.check_inputs(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    forbid_autograd("flash_attention", q, k, v)
    if is_fake(q) or torch._C._len_torch_dispatch_stack():  # a trace or a counter sees the op
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """One launch of the kernel of q's dtype: (B, T, H, hd) out.  Called
    directly where no dispatch mode is active: the custom op's dispatch
    costs ~70 us of host time a call, more than the kernel at the llama
    shape (PERF.md §6)."""
    global launches
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    kernel.flash_attention_bhtd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                                window=window, out=out.transpose(1, 2))
    launches += 1
    return out


_op = torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")(_launch)


@_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_attention_flops(q_shape, k_shape, v_shape, causal, window, *, out_shape=None, **kwargs) -> int:
    """4 hd flops (two products, a multiply-add each) for each visible
    (query, key) pair of each (batch, head)."""
    b, t, h, hd = q_shape
    return 4 * hd * b * h * visible_pairs(t, k_shape[1], causal=causal, window=window)


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
    T, hd) view of it is not a layout TMA reads.  A fake tensor has no
    address: its strides alone decide."""
    xt = x.transpose(1, 2)
    ptr = 0 if is_fake(x) else xt.data_ptr()
    if kernel.tma_layout_error(xt.shape, xt.stride(), ptr, xt.element_size()) is None:
        return x
    return x.contiguous()
