"""Plain PyTorch version of the wkv6 kernel's function: the chunked linear
scan in `repro_torch.models.linear_scan`, as `repro/kernels/wkv/ref.py`
re-exports the JAX package's."""

from repro_torch.models.linear_scan import wkv6_chunked as wkv6_ref  # noqa: F401
from repro_torch.models.linear_scan import wkv6_step  # noqa: F401
