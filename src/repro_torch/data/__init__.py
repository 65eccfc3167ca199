from repro_torch.data.synthetic import LinRegData, make_linreg_data, worker_major_batch  # noqa: F401
