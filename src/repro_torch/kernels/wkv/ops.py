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
rank holds whole).  A layout that shards T, K or V is first redistributed
to one that shards only the batch and the heads (an explicit gather: the
scan needs whole sequences and whole K x V states; rwkv6-3b's 40 heads on
a model axis that does not divide them shard hd, which is gathered here),
then the kernel runs on each rank's local shard, each launch counted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.wkv import kernel, ref
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
    global launches
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
    out = kernel.wkv6_bthk(r, k, v, w, u, s0, chunk=run, kernel=name)
    launches += 1
    route_launches[name] += 1
    return out


def _wkv6_sharded(r, k, v, w, u, s0, *, chunk: int):
    """`wkv6` on DTensor r: each rank's (batch, heads) shard through the
    kernel (`shardctx.on_local_shards`); u (H, K) and s0 (B, H, K, V)
    follow the layout r, k, v and w decide."""
    return on_local_shards(lambda *xs: wkv6(*xs, chunk=chunk), (r, k, v, w, u, s0),
                           [(0, 2)] * 4 + [(None, 0), (0, 1)], (r.shape[2],), [(0, 2), (0, 1)])
