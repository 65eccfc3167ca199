"""Plain reference of fastest-k SGD on the paper's linear regression.

Each lane is one replica of one case: parameters w (d,) from zero, a
threefry key, a simulated clock, and a controller (Pflug's test, or a
fixed k).  One iteration, as Algorithm 1 of arXiv:2002.11005 runs it:

    key -> (next key, sub); k decided before the step;
    response times of the n workers ~ Exponential(rate) from sub;
    the k fastest workers' shards give the eq.-(2) gradient
        g = (2 / (k s)) sum over their rows a of (x_a . w - y_a) x_a;
    w <- w - eta g; clock += the k-th fastest time;
    Pflug: the counter rises on g . g_prev < 0 and falls otherwise; after
    the burn-in, a counter above thresh raises k by step (up to k_max) and
    both counters reset.

Every ``eval_every`` iterations (and at the end) it records each lane's
clock, its mean squared error over all m rows, and the k of the last
iteration.  All lanes advance together as tensors; the products go through
`precision.matmul`, so the same code is the control at a lower precision.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from gpubench.reference import precision as prec
from gpubench.reference import threefry

PFLUG, FIXED = 0, 1


class Lane(NamedTuple):
    """One lane's controller: kind PFLUG or FIXED, and its parameters."""

    kind: int
    k0: int
    step: int = 0
    thresh: int = 0
    burnin: int = 0
    k_max: int = 0


def lanes_of(cases: Sequence[dict], replicas: int) -> list:
    """Cell-major lanes: each case's controller ``replicas`` times."""
    out = []
    for c in cases:
        if c["controller"] == "pflug":
            lane = Lane(PFLUG, c["k0"], c["step"], c["thresh"], c["burnin"], c["k_max"])
        elif c["controller"] == "fixed":
            lane = Lane(FIXED, c["k"])
        else:
            raise ValueError(f"unknown controller {c['controller']!r}")
        out += [lane] * replicas
    return out


def simulate(X: torch.Tensor, y: torch.Tensor, lanes: Sequence[Lane], keys: torch.Tensor, n_workers: int,
             eta: float, rate: float, num_iters: int, eval_every: int, precision: str = "fp32"):
    """(time, loss, k), each (lanes, n_evals), for lanes started from w = 0
    with the given keys (lanes, 2)."""
    dev = X.device
    m, d = X.shape
    s = m // n_workers
    n_lanes = len(lanes)
    col = lambda f, dt: torch.tensor([getattr(l, f) for l in lanes], dtype=dt, device=dev)  # noqa: E731
    is_pflug = col("kind", torch.int64) == PFLUG
    k = col("k0", torch.int64)
    step, thresh, burnin, k_max = (col(f, torch.int64) for f in ("step", "thresh", "burnin", "k_max"))
    count_neg = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    count_iter = torch.ones(n_lanes, dtype=torch.int64, device=dev)
    have_prev = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    prev = torch.zeros((n_lanes, d), dtype=torch.float32, device=dev)
    w = torch.zeros((n_lanes, d), dtype=torch.float32, device=dev)
    clock = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    key = keys.to(device=dev, dtype=torch.int64)
    Xt = X.T.contiguous()
    times, losses, ks = [], [], []

    def mse(w):
        r = prec.matmul(w, Xt, precision) - y
        return (r * r).mean(dim=1)

    for it in range(1, num_iters + 1):
        pair = threefry.split(key)
        key, sub = pair[:, 0], pair[:, 1]
        t = threefry.exponential_times(sub, n_workers, rate)
        mask, kth = threefry.fastest_k(t, k)
        r = prec.matmul(w, Xt, precision) - y  # (lanes, m)
        wrow = (mask / (k.to(torch.float32)[:, None] * s)).repeat_interleave(s, dim=1)
        g = prec.matmul(2.0 * wrow * r, X, precision)  # (lanes, d)
        w = w - eta * g
        clock = clock + kth
        dot = (prec.operand(g, precision) * prec.operand(prev, precision)).sum(dim=1)
        event = torch.where(have_prev, torch.where(dot < 0, 1, -1), 0)
        cneg = count_neg + event
        switch = is_pflug & (cneg > thresh) & (count_iter > burnin) & (k + step <= k_max)
        k_used = k
        k = torch.where(switch, k + step, k)
        count_neg = torch.where(switch, 0, cneg)
        count_iter = torch.where(switch, 0, count_iter) + 1
        prev, have_prev = g, torch.ones_like(have_prev)
        if it % eval_every == 0 or it == num_iters:
            times.append(clock.clone())
            losses.append(mse(w))
            ks.append(k_used.clone())
    return torch.stack(times, 1), torch.stack(losses, 1), torch.stack(ks, 1)
