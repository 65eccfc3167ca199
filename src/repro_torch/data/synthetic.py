"""Synthetic data, in torch: the paper's linear-regression task (§V-A).

X uniform over {1..10}^d, w_bar uniform over {1..100}^d, y ~ N(<x, w_bar>, 1),
drawn with the port's threefry from one key, so X and w_bar are the JAX
package's bits; y differs from it only where torch's erfinv does from XLA's
(a few tens of ulp of the unit noise).  The token stream of the LM path
waits for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import prng

__all__ = ["LinRegData", "make_linreg_data", "worker_major_batch"]


class LinRegData(NamedTuple):
    X: torch.Tensor  # (m, d) float32
    y: torch.Tensor  # (m,)
    w_star: torch.Tensor  # least-squares solution (for excess-risk curves)
    f_star: float  # minimal mean loss


def make_linreg_data(key, m: int = 2000, d: int = 100, device="cuda") -> LinRegData:
    """The paper's synthetic linear regression, on ``device``; ``key`` a
    (2,) key (numpy uint32 from JAX or a `prng` key).  The least-squares
    optimum is solved in float32, as the reference does."""
    dev = resolve_device(device)
    k1, k2, k3 = prng.split(prng.as_key(key, dev), 3).unbind(0)
    X = prng.randint(k1, (m, d), 1, 11).to(torch.float32)
    w_bar = prng.randint(k2, (d,), 1, 101).to(torch.float32)
    y = X @ w_bar + prng.normal(k3, (m,))
    w_star = torch.linalg.lstsq(X, y[:, None]).solution[:, 0]
    f_star = float(((X @ w_star - y) ** 2).mean())
    return LinRegData(X=X, y=y, w_star=w_star, f_star=f_star)


def worker_major_batch(tokens: torch.Tensor, n_workers: int) -> torch.Tensor:
    """Check that a (B, ...) batch splits into n_workers worker-major blocks."""
    b = tokens.shape[0]
    if b % n_workers:
        raise ValueError(f"batch {b} not divisible by n_workers {n_workers}")
    return tokens
