"""Synthetic data, in torch: the paper's linear-regression task (§V-A) and
the LM path's token stream.

Linear regression: X uniform over {1..10}^d, w_bar uniform over
{1..100}^d, y ~ N(<x, w_bar>, 1), drawn with the port's threefry from one
key, so X and w_bar are the JAX package's bits; y differs from it only
where torch's erfinv does from XLA's (a few tens of ulp of the unit noise).

`TokenStream`: the deterministic next-token stream the LM trainer and
`LMSource` consume, the JAX package's bit for bit (integer draws only).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import prng

__all__ = ["LinRegData", "make_linreg_data", "least_squares", "worker_major_batch", "TokenStream"]


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
    w_star = least_squares(X, y)
    f_star = float(((X @ w_star - y) ** 2).mean())
    return LinRegData(X=X, y=y, w_star=w_star, f_star=f_star)


def least_squares(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """argmin_w ||X w - y||^2 for a full-rank (m, d) X, m >= d, by QR
    (LAPACK's gels, the one routine CUDA has).  Not the CPU's default gelsy:
    its pivoted QR gives another solution from run to run in one process,
    one thread (9 distinct f32 solutions in 300 calls at m=80, d=4, f* up
    to 4.5e-5 relative apart), where gels gives one."""
    return torch.linalg.lstsq(X, y[:, None], driver="gels").solution[:, 0]


def worker_major_batch(tokens: torch.Tensor, n_workers: int) -> torch.Tensor:
    """Check that a (B, ...) batch splits into n_workers worker-major blocks."""
    b = tokens.shape[0]
    if b % n_workers:
        raise ValueError(f"batch {b} not divisible by n_workers {n_workers}")
    return tokens


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic LM token stream on ``device``.

    ``batch_at(step)`` gives (tokens, targets), both (global_batch, seq_len)
    int32, targets the tokens shifted by one.  Each row is a seeded walk
    with Markov structure, so the LM loss is learnable: with probability
    ``correlation`` the next token is the previous one plus 1 (mod vocab),
    else a fresh uniform token.  Rows are worker-major: worker i of n owns
    rows [i*s, (i+1)*s), the layout the fastest-k weights assume."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    correlation: float = 0.8
    device: str = "cuda"

    def batches(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = resolve_device(self.device)
        key = prng.fold_in(prng.PRNGKey(self.seed, device=dev), step)
        k1, k2 = prng.split(key).unbind(0)
        b, t, v = self.global_batch, self.seq_len, self.vocab_size
        base = prng.randint(k1, (b, t + 1), 0, v)
        follow = prng.bernoulli(k2, self.correlation, (b, t + 1))
        # the reference's lax.scan over positions, vectorised over rows
        seq = torch.empty_like(base)
        prev = base[:, 0]
        for i in range(t + 1):
            prev = torch.where(follow[:, i], (prev + 1) % v, base[:, i])
            seq[:, i] = prev
        return seq[:, :-1], seq[:, 1:]
