"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Sources live in `<kernel>/csrc/*.cu` and are compiled by `_build` at first use.
The kernels are forward-only: `forbid_autograd` stops a gradient from
silently stopping at one."""

from __future__ import annotations

import torch


def forbid_autograd(name: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through kernel ``name``:
    grad mode is on and an input requires grad.  The kernels write their
    outputs through ctypes, so the outputs have no ``grad_fn`` and the
    inputs would get no gradient.  None entries are skipped."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only, and an input requires grad with grad mode on; autograd "
            "would send no gradient into it. Run under torch.no_grad() or torch.inference_mode(), or take the "
            "plain path (use_kernels=False); backward kernels come with the training path (ROADMAP Queue 1 "
            "item 6)")
