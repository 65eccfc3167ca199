"""Theoretical analysis, host-side numpy: Lemma 1 (error vs wall-clock
bound), Theorem 1 (bound-optimal switching times) and Example 1.  The port
of `repro.core.theory`, line for line; it consumes the port's straggler
models and feeds `ScheduleController`.

Heterogeneous fleets: Theorem 1 needs only the order-statistic moments, so
``hetero_order_stat_moments`` computes them exactly for independent,
non-identical workers (``straggler.WorkerFleet``) by integrating the
Poisson-binomial count recurrence over the per-worker CDFs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.straggler import Exponential, StragglerModel

__all__ = [
    "SGDSystem",
    "error_bound",
    "switching_times",
    "adaptive_bound_curve",
    "hetero_order_stat_moments",
]


def hetero_order_stat_moments(
    models: Sequence[StragglerModel], k: int, num: int = 4001, tail: float = 1e-7
):
    """(E[X_(k)], E[X_(k)^2]) for independent, non-identical worker times.

    With X_i ~ F_i independent, the k-th order statistic's CDF is the
    Poisson-binomial tail  F_(k)(t) = P(#{i: X_i <= t} >= k), evaluated by
    the O(n^2) count recurrence at every quadrature node; the moments follow
    from the survival-function identities for non-negative variables,

        E[X_(k)]   = int_0^inf (1 - F_(k)(t)) dt,
        E[X_(k)^2] = int_0^inf 2 t (1 - F_(k)(t)) dt,

    on a grid that is linear through the bulk and log-spaced into the tail
    (heavy-tailed fleets concentrate their k=n mass far out).  For n iid
    models this is the same quantity the Beta-quadrature default computes.
    Second moments require every model's tail to have finite variance
    (e.g. Pareto needs alpha > 2) — the integral is truncated at the
    (1 - tail) quantile either way.
    """
    n = len(models)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside 1..{n}")
    hi = max(float(np.max(m.quantile(np.asarray([1.0 - tail])))) for m in models)
    mid = max(float(np.max(m.quantile(np.asarray([0.95])))) for m in models)
    mid = min(max(mid, 1e-12), hi)
    grid = np.concatenate([np.linspace(0.0, mid, num)[:-1],
                           np.geomspace(max(mid, 1e-12), max(hi, 1e-12), num)])
    grid = np.unique(grid)
    # Poisson-binomial recurrence, vectorized over the grid: c[j] = P(count=j).
    c = np.zeros((n + 1, grid.size))
    c[0] = 1.0
    for i, m in enumerate(models):
        fi = np.clip(np.asarray(m.cdf(grid), np.float64), 0.0, 1.0)
        for j in range(i + 1, 0, -1):
            c[j] = c[j] * (1.0 - fi) + c[j - 1] * fi
        c[0] = c[0] * (1.0 - fi)
    surv = 1.0 - np.sum(c[k:], axis=0)  # P(X_(k) > t)
    m1 = np.trapezoid(surv, grid)
    m2 = np.trapezoid(2.0 * grid * surv, grid)
    return float(m1), float(m2)


@dataclasses.dataclass(frozen=True)
class SGDSystem:
    """The paper's system parameters (Proposition 1 / Lemma 1 notation).

    eta:    fixed step size
    L, c:   Lipschitz-smoothness and strong-convexity constants of F
    sigma2: variance bound on the per-sample gradient estimate
    s:      samples per worker (= m/n)
    F0_gap: F(w_0) − F*
    n:      number of workers
    straggler: response-time model (gives mu_k = E[X_(k)]); a heterogeneous
        ``straggler.WorkerFleet`` with n active models works too — its order
        statistics come from ``hetero_order_stat_moments``, so Theorem-1
        switch times remain available on non-iid fleets.
    """

    eta: float
    L: float
    c: float
    sigma2: float
    s: int
    F0_gap: float
    n: int
    straggler: StragglerModel = Exponential(rate=1.0)

    def mu(self, k: int) -> float:
        return self.straggler.mean_order_statistic(k, self.n)

    def error_floor(self, k: int) -> float:
        """Stationary-phase bound: eta*L*sigma^2 / (2*c*k*s)."""
        return self.eta * self.L * self.sigma2 / (2.0 * self.c * k * self.s)


def error_bound(sys: SGDSystem, k: int, t: np.ndarray, F_start_gap: float | None = None,
                t0: float = 0.0) -> np.ndarray:
    """Lemma 1 evaluated at wall-clock times t (with epsilon dropped, as in the paper).

        bound(t) = floor_k + (1 − ηc)^{(t−t0)/μ_k} (F_start_gap − floor_k)

    `F_start_gap` = F(w_{t0}) − F*  (defaults to F0_gap with t0 = 0).
    """
    t = np.asarray(t, dtype=np.float64)
    floor = sys.error_floor(k)
    gap0 = sys.F0_gap if F_start_gap is None else F_start_gap
    decay = (1.0 - sys.eta * sys.c) ** ((t - t0) / sys.mu(k))
    return floor + decay * (gap0 - floor)


def switching_times(sys: SGDSystem, k_values: Sequence[int] | None = None,
                    step: int = 1) -> List[float]:
    """Theorem 1: bound-optimal times t_k to switch from k to k + step.

    For the paper's unit step:

    t_k = t_{k−1} + μ_k/(−ln(1−ηc)) · [ ln(μ_{k+1} − μ_k) − ln(ηLσ²μ_k)
          + ln( 2ck(k+1)s(F(w_{t_{k−1}}) − F*) − ηL(k+1)σ² ) ]

    With step > 1 (a ScheduleController jumping k -> k+step) every k+1 above
    becomes k+step: the comparison is between staying at k and jumping to the
    next scheduled level, whose floor and μ are those of k+step.

    F(w_{t_{k−1}}) − F* is evaluated recursively from the Lemma-1 bound along
    the adaptive trajectory.  Returns the list [t_1, ..., t_{n−1}] (a switch
    whose argument is non-positive or whose bound is already below the next
    floor yields t_k = t_{k−1}, i.e. switch immediately).
    """
    ks = list(k_values) if k_values is not None else list(range(1, sys.n))
    eta, L, c, s, sig2 = sys.eta, sys.L, sys.c, sys.s, sys.sigma2
    neg_log = -np.log(1.0 - eta * c)

    times: List[float] = []
    t_prev = 0.0
    gap_prev = sys.F0_gap  # F(w_{t_{k-1}}) − F* at the previous switch
    for k in ks:
        k_next = min(k + step, sys.n)
        mu_k, mu_k1 = sys.mu(k), sys.mu(k_next)
        arg3 = 2.0 * c * k * k_next * s * gap_prev - eta * L * k_next * sig2
        if arg3 <= 0 or (mu_k1 - mu_k) <= 0:
            # Bound already at/below the next floor — switch immediately.
            t_k = t_prev
        else:
            dt = (mu_k / neg_log) * (
                np.log(mu_k1 - mu_k) - np.log(eta * L * sig2 * mu_k) + np.log(arg3)
            )
            t_k = t_prev + max(dt, 0.0)
        times.append(float(t_k))
        # Error gap at the switch point, following the k-trajectory from t_prev.
        gap_prev = float(error_bound(sys, k, np.asarray([t_k]), gap_prev, t_prev)[0])
        t_prev = t_k
    return times


def adaptive_bound_curve(sys: SGDSystem, t_grid: np.ndarray,
                         k_values: Sequence[int] | None = None) -> np.ndarray:
    """The Lemma-1 bound along the Theorem-1 adaptive trajectory.

    Piecewise: on [t_{k−1}, t_k) the bound follows error_bound(k) seeded at the
    gap reached at t_{k−1}.  This is the 'adaptive' envelope of Fig. 1.
    """
    ks = list(k_values) if k_values is not None else list(range(1, sys.n + 1))
    switches = switching_times(sys, ks[:-1])
    t_grid = np.asarray(t_grid, dtype=np.float64)
    out = np.empty_like(t_grid)

    seg_starts = [0.0] + switches
    gaps = [sys.F0_gap]
    for i, t_k in enumerate(switches):
        gaps.append(float(error_bound(sys, ks[i], np.asarray([t_k]), gaps[i], seg_starts[i])[0]))

    seg_ends = switches + [np.inf]
    for i, k in enumerate(ks):
        m = (t_grid >= seg_starts[i]) & (t_grid < seg_ends[i])
        if np.any(m):
            out[m] = error_bound(sys, k, t_grid[m], gaps[i], seg_starts[i])
    return out


def example1_system() -> SGDSystem:
    """Example 1 of the paper: n=5, Exp response times, η=0.001, σ²=10,
    F(w0)−F*=100, L=2, c=1, s=10.  (The paper states μ=5 but evaluates
    μ_k = H_n − H_{n−k}, i.e. unit rate — we follow the evaluated formula.)"""
    return SGDSystem(eta=0.001, L=2.0, c=1.0, sigma2=10.0, s=10, F0_gap=100.0,
                     n=5, straggler=Exponential(rate=1.0))
