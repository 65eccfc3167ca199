from repro_torch.data.synthetic import (  # noqa: F401
    LinRegData,
    TokenStream,
    make_linreg_data,
    worker_major_batch,
)
