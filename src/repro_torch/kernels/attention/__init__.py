from repro_torch.kernels.attention import ops, ref  # noqa: F401
from repro_torch.kernels.attention.ops import flash_attention  # noqa: F401
