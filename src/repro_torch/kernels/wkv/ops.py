"""Public wrapper of the wkv6 kernels, in the model's layout.

The port of `repro/kernels/wkv/ops.py::wkv6`: (B, T, H, K) r, k, w and
(B, T, H, V) v in, y (B, T, H, V) f32 and the final state (B, H, K, V) f32
out.  The CUDA kernels read the model's layout through strides, so nothing
is folded or copied.  A CUDA tensor launches the kernel that
`kernel.route` picks from the shapes (or raises); a CPU tensor, and only a
CPU tensor, goes to the plain version in `ref.py`, which autograd can
differentiate.  The kernels are forward-only: on CUDA tensors under grad
mode with an input that requires grad the wrapper raises
(`kernels.forbid_autograd`).

Under a mesh it takes DTensors (u and s0 may be plain tensors that every
rank holds whole), laid out by `shardctx.on_local_shards`: the batch and
the heads stay sharded where the heads divide their mesh dims; where v
shards its head dim instead (rwkv6-3b's 40 heads on a 16-way model axis,
which shards hd: the reference's layout), v, s0, y and the final state
stay sharded on V and r, k, w and u are gathered whole, since the scan's
V columns are independent; a layout that shards T, or K alone, is
gathered.  Then the kernel runs once on each rank's (batch shard, heads,
K, V piece), each launch counted: at V/m < 64 that is the scalar route.

The CUDA launch is the custom op ``repro_torch::wkv6`` (`torch.library`)
wherever a dispatch mode is active, so a trace on fake CUDA tensors (the
dry run, `launch/dryrun.py`) or under the roofline's counter passes through
the card's program, without launching on fakes: its fake implementation gives
y and the final state, and its FLOP formula the operation count of the
bound in PERF.md (`wkv6_flops`).  The launch counts rise in the CUDA
implementation alone, so a fake trace counts none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.wkv import kernel, ref
from repro_torch.models.linear_scan import WKV6_DIMS
from repro_torch.shardctx import is_dtensor, on_local_shards

# Kernel launches since import or since a caller last set them to 0: all of
# them, and by route.
launches = 0
route_launches = {"wkv6": 0, "wkv6_sm90": 0}


def reset_counts() -> None:
    global launches
    launches = 0
    for name in route_launches:
        route_launches[name] = 0


def wkv6(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, T, H, V)
    w: torch.Tensor,  # (B, T, H, K) f32
    u: torch.Tensor,  # (H, K) f32
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V) f32; None means zeros
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_dtensor(r):
        return _wkv6_sharded(r, k, v, w, u, s0, chunk=chunk)
    run = min(chunk, r.shape[1])
    if run > kernel.MAX_DIM:
        # The JAX package caps the Pallas kernel's chunk at 64 for its VMEM
        # budget; the CUDA kernels stage chunk x 64 tiles in shared memory.
        raise ValueError(f"wkv6 chunk must be <= {kernel.MAX_DIM}, got {run}")
    kernel.check_inputs(r, k, v, w, u, s0, chunk=run)
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0, chunk=run)
    forbid_autograd("wkv6", r, k, v, w, u, s0)
    name = kernel.route(r.shape[1], r.shape[-1], v.shape[-1], chunk)
    if is_fake(r) or torch._C._len_torch_dispatch_stack():  # a trace or a counter sees the op
        return tuple(torch.ops.repro_torch.wkv6(r, k, v, w, u, s0, run, name))
    return _launch(r, k, v, w, u, s0, run, name)


def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
            s0: Optional[torch.Tensor], chunk: int, route: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel ``route`` at ``chunk``: y (B, T, H, V) and s_T
    (B, H, K, V), both f32.  Called directly where no dispatch mode is
    active (the custom op's dispatch is host time, `attention.ops._launch`)."""
    global launches
    out = kernel.wkv6_bthk(r, k, v, w, u, s0, chunk=chunk, kernel=route)
    launches += 1
    route_launches[route] += 1
    return out


_op = torch.library.custom_op("repro_torch::wkv6", mutates_args=(), device_types="cuda")(_launch)


@_op.register_fake
def _(r, k, v, w, u, s0, chunk, route):
    b, t, h, kdim = r.shape
    vdim = v.shape[-1]
    return (r.new_empty((b, t, h, vdim), dtype=torch.float32),
            r.new_empty((b, h, kdim, vdim), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv6)
def wkv6_flops(r_shape, k_shape, v_shape, w_shape, u_shape, s0_shape, chunk, route, *, out_shape=None,
               **kwargs) -> int:
    """Per chunk of C and per (b, h): 4 C K V for the state's application
    to r and its update (a multiply-add each), and C (C + 1) (K + V) for
    the scores and their application to v over tau <= t.  The exps are not
    counted."""
    b, t, h, kdim = r_shape
    vdim = v_shape[-1]
    return (t // chunk) * b * h * (4 * chunk * kdim * vdim + chunk * (chunk + 1) * (kdim + vdim))


def _wkv6_sharded(r, k, v, w, u, s0, *, chunk: int):
    """`wkv6` on DTensor r: each rank's (batch, heads) or (batch, V) piece
    through the kernel, one launch a rank (`shardctx.on_local_shards`,
    `linear_scan.WKV6_DIMS`); u (H, K) and s0 (B, H, K, V) follow the
    layout r, k, v and w decide."""
    return on_local_shards(lambda *xs: wkv6(*xs, chunk=chunk), (r, k, v, w, u, s0), WKV6_DIMS[0], (r.shape[2],),
                           WKV6_DIMS[1])


def wkv6_piece(r, k, v, w, u, s0, rank: int, extent: int, *, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block ``rank`` of ``extent`` of `wkv6` over V, from whole tensors, as
    a rank of the value-side layout runs it (`_wkv6_sharded`): r, k, w and u
    whole, v's and s0's V/extent columns, one launch.  v's columns are a
    view read through its strides; s0's are copied (the kernels take a
    contiguous s0).  Returns (y, s_T) of the piece: columns [rank V/extent,
    (rank + 1) V/extent) of the whole call's."""
    if v.shape[-1] % extent:
        raise ValueError(f"V={v.shape[-1]} does not split into {extent} pieces")
    vl = v.shape[-1] // extent
    cols = slice(rank * vl, (rank + 1) * vl)
    return wkv6(r, k, v[..., cols], w, u, None if s0 is None else s0[..., cols].contiguous(), chunk=chunk)
