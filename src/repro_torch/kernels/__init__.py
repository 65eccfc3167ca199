"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Sources live in `<kernel>/csrc/*.cu` and are compiled by `_build` at first use."""
