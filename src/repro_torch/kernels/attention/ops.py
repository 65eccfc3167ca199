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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.attention import kernel
from repro_torch.kernels.attention.ref import attention_ref

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
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kernel.check_inputs(qt, kt, vt, causal=causal)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    forbid_autograd("flash_attention", q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    kernel.flash_attention_bhtd(qt, kt, vt, causal=causal, window=window, out=out.transpose(1, 2))
    launches += 1
    return out
