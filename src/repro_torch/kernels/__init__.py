"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Sources live in `<kernel>/csrc/*.cu` and are compiled by `_build` at first use.
The kernels are forward-only, in the port as in the JAX package (whose
`pallas_call`s `jax.grad` cannot pass): the training path differentiates the
plain path (`use_kernels=False`), and `forbid_autograd` stops a gradient
from silently stopping at a kernel."""

from __future__ import annotations

import torch


def forbid_autograd(name: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through kernel ``name``:
    grad mode is on and an input requires grad.  The kernels write their
    outputs through ctypes, so the outputs have no ``grad_fn`` and the
    inputs would get no gradient.  Under `torch.func.grad` the inputs are
    wrapped tensors that require grad, so it raises there too.  None
    entries are skipped."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward-only, and an input requires grad with grad mode on; autograd "
            "would send no gradient into it. Run under torch.no_grad() or torch.inference_mode(), or take the "
            "plain path (use_kernels=False), as the training path does to differentiate: this port, like the JAX "
            "package, has no backward kernel")
