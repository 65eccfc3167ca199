from repro_torch.kernels.wkv import ops, ref  # noqa: F401
from repro_torch.kernels.wkv.ops import wkv6  # noqa: F401
