from repro_torch.checkpoint.convert import init, params_from_jax  # noqa: F401
from repro_torch.checkpoint.io import latest_step, restore, save  # noqa: F401
