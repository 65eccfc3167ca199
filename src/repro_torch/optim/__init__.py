"""Pytree optimizers of the port (no torch.optim), the JAX package's
`repro.optim`:

    opt = adamw(lr=...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)   # the reference's interface
    params = apply_updates(params, updates)
    params, state = opt.apply(grads, state, params)     # the same arithmetic, in place
"""

from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState,
    Optimizer,
    SGDState,
    adam,
    adamw,
    apply_updates,
    chain_clip,
    clip_by_global_norm,
    get_optimizer,
    sgd,
)
