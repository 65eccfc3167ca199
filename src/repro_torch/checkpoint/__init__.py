from repro_torch.checkpoint.convert import init, params_from_jax  # noqa: F401
