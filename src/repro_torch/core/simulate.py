"""Single-trajectory (R = 1) wrapper over the Monte-Carlo engine, in torch.

The port of `repro.core.simulate`: ``simulate_fastest_k`` runs one replica
of `run_monte_carlo` for one key and returns its history as Python lists,
recorded every ``eval_every`` iterations (and at ``num_iters``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.core import aggregation, prng
from repro_torch.core.montecarlo import run_monte_carlo

__all__ = ["simulate_fastest_k"]


def simulate_fastest_k(
    per_example_loss_fn: Callable,
    params0,
    X,
    y,
    n_workers: int,
    controller,
    straggler,
    eta: float,
    num_iters: int,
    key,
    comm: aggregation.CommModel | None = None,
    eval_every: int = 10,
    mode: str = "sync",
    device="cuda",
) -> Dict[str, List[float]]:
    """Run adaptive/fixed fastest-k SGD for one key (a (2,) key, numpy
    uint32 from JAX or a `prng` key) in ``mode`` ("sync", "kasync" or
    "kbatch"); returns {'time', 'loss', 'k'}."""
    result = run_monte_carlo(
        per_example_loss_fn, params0, X, y, n_workers=n_workers, controller=controller,
        straggler=straggler, eta=eta, num_iters=num_iters, keys=prng.as_key(key)[None], comm=comm,
        eval_every=eval_every, mode=mode, device=device,
    )
    return {
        "time": [float(t) for t in result.time[0].tolist()],
        "loss": [float(v) for v in result.loss[0].tolist()],
        "k": [int(k) for k in result.k[0].tolist()],
    }
