"""PyTorch/CUDA port of the `repro` package (the JAX reference beside it).

Entry points take an explicit `device`, which defaults to "cuda"; they raise
when no card is present, and run on the CPU only when asked to
(`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
