"""Worker response-time (straggler) models, in torch.

The port of `repro.core.straggler`: the five families as inverse-CDF
transforms of one shared base draw, the per-worker packed-parameter
protocol (`WorkerFleet`, `RateSchedule`), the async modes' renewal rule,
and the numpy host analytics (quantiles, CDFs, order-statistic moments).

Samplers take keys of `repro_torch.core.prng` ((..., 2), or one (2,) key
under `torch.func.vmap`) and return float32 times of shape (..., n).  They
build no tensor from host data, so a sampler can be captured in a CUDA
graph: scalar parameters enter as Python floats holding float32 values, a
fleet's as tensors already on the device.

Base randomness is shared across families as in the reference: one split
of the key gives the primary uniform `u` (and `l = log1p(-u)`) and, only
when a two-draw family is present, the secondary uniform `v`.  The
transforms multiply by reciprocals (`-1/rate` computed once in float32),
so scalar and per-row parameters give the same bits.  torch's `log1p` and
`exp` differ from XLA's by at most 1 ulp, so times agree with the
reference to that, not bit for bit; Deterministic and Bimodal's mode
select are exact.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng

__all__ = [
    "StragglerModel",
    "Exponential",
    "ShiftedExponential",
    "Pareto",
    "Bimodal",
    "Deterministic",
    "RateSchedule",
    "WorkerFleet",
    "get_straggler_model",
    "SWEEP_FAMILIES",
    "N_STRAGGLER_PARAMS",
    "INACTIVE_FAMILY",
    "pack_params",
    "pack_params_per_worker",
    "pack_schedule",
    "family_index",
    "family_select_masks",
    "sample_times_selected",
    "sample_times_per_worker",
    "schedule_multiplier",
    "apply_rate_schedule",
    "onset_mask",
    "renewal_remaining",
]

N_STRAGGLER_PARAMS = 3


class _BaseDraws(NamedTuple):
    """Shared base randomness: primary uniform `u`, its log factor
    `l = log1p(-u)`, and the secondary uniform `v` (None unless needed)."""

    u: torch.Tensor
    l: torch.Tensor
    v: Optional[torch.Tensor]


def _base_draws(key: torch.Tensor, n: int, with_secondary: bool) -> _BaseDraws:
    """One split of the key, whichever families are present: `u` from the
    first subkey, `v` (only when asked) from the second."""
    sub = prng.split(key)
    u = prng.uniform(sub[..., 0, :], (n,))
    l = torch.log1p(-u)
    v = prng.uniform(sub[..., 1, :], (n,)) if with_secondary else None
    return _BaseDraws(u=u, l=l, v=v)


def _col(p, j: int):
    """Column j of packed parameters: a Python float (the float32 value) for
    a numpy vector, `p[..., j]` for a per-worker tensor."""
    if isinstance(p, torch.Tensor):
        return p[..., j]
    return float(np.asarray(p, np.float32)[..., j])


def _neg_recip(x):
    """-1/x in float32, for a float or a tensor (the same IEEE division)."""
    if isinstance(x, torch.Tensor):
        return -1.0 / x
    return float(np.float32(-1.0) / np.float32(x))


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Base class: iid worker response times."""

    NEEDS_SECONDARY = False

    def sample(self, key: torch.Tensor, n: int) -> torch.Tensor:
        """Draw n iid response times (float32, shape (..., n))."""
        return type(self)._sample_packed(key, n, pack_params(self))

    @staticmethod
    def _from_base(base: _BaseDraws, p) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def _sample_packed(cls, key, n: int, p) -> torch.Tensor:
        return cls._from_base(_base_draws(key, n, cls.NEEDS_SECONDARY), p)

    @classmethod
    def _sample_packed_rows(cls, key, pmat: torch.Tensor) -> torch.Tensor:
        """Per-worker form: row i of pmat parameterizes worker i's draw."""
        return cls._from_base(_base_draws(key, pmat.shape[0], cls.NEEDS_SECONDARY), pmat)

    def packed(self) -> np.ndarray:
        raise NotImplementedError

    # --- host-side analytics (numpy) ---
    def quantile(self, u: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def cdf(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def mean_order_statistic(self, k: int, n: int) -> float:
        """E[X_(k)] for n iid draws, by Beta quadrature over quantiles."""
        m1, _ = _order_stat_moments(self.quantile, k, n)
        return float(m1)

    def var_order_statistic(self, k: int, n: int) -> float:
        m1, m2 = _order_stat_moments(self.quantile, k, n)
        return float(m2 - m1 * m1)


def _order_stat_moments(quantile, k: int, n: int, num: int = 20001):
    """First two moments of X_(k) by quadrature over the Beta(k, n-k+1)
    density, in u = (1 - cos(pi theta))/2 (nodes clustered at both ends)."""
    from math import lgamma

    theta = np.linspace(0.0, 1.0, num)[1:-1]
    u = 0.5 * (1.0 - np.cos(np.pi * theta))
    du = 0.5 * np.pi * np.sin(np.pi * theta)
    logb = lgamma(n + 1) - lgamma(k) - lgamma(n - k + 1)
    logpdf = logb + (k - 1) * np.log(u) + (n - k) * np.log1p(-u)
    w = np.exp(logpdf) * du
    x = quantile(u)
    m1 = np.trapezoid(w * x, theta)
    m2 = np.trapezoid(w * x * x, theta)
    return m1, m2


def _harmonic(n: int) -> float:
    return float(np.sum(1.0 / np.arange(1, n + 1))) if n > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class Exponential(StragglerModel):
    """X ~ Exp(rate); mean 1/rate.  E[X_(k)] = (H_n - H_{n-k})/rate."""

    rate: float = 1.0

    @staticmethod
    def _from_base(base, p):
        return base.l * _neg_recip(_col(p, 0))

    def packed(self):
        return np.array([self.rate, 0.0, 0.0], np.float32)

    def quantile(self, u):
        return -np.log1p(-u) / self.rate

    def cdf(self, x):
        x = np.asarray(x, np.float64)
        return np.where(x > 0, -np.expm1(-self.rate * np.maximum(x, 0.0)), 0.0)

    def mean_order_statistic(self, k: int, n: int) -> float:
        return (_harmonic(n) - _harmonic(n - k)) / self.rate

    def var_order_statistic(self, k: int, n: int) -> float:
        i = np.arange(n - k + 1, n + 1)
        return float(np.sum(1.0 / i**2) / self.rate**2)


@dataclasses.dataclass(frozen=True)
class ShiftedExponential(StragglerModel):
    """X ~ shift + Exp(rate)."""

    shift: float = 1.0
    rate: float = 1.0

    @staticmethod
    def _from_base(base, p):
        return _col(p, 0) + base.l * _neg_recip(_col(p, 1))

    def packed(self):
        return np.array([self.shift, self.rate, 0.0], np.float32)

    def quantile(self, u):
        return self.shift - np.log1p(-u) / self.rate

    def cdf(self, x):
        x = np.asarray(x, np.float64)
        return np.where(
            x > self.shift,
            -np.expm1(-self.rate * np.maximum(x - self.shift, 0.0)),
            0.0,
        )

    def mean_order_statistic(self, k: int, n: int) -> float:
        return self.shift + (_harmonic(n) - _harmonic(n - k)) / self.rate


@dataclasses.dataclass(frozen=True)
class Pareto(StragglerModel):
    """X ~ Pareto(x_m, alpha): (1-u)^(-1/alpha) = exp(l * (-1/alpha))."""

    x_m: float = 1.0
    alpha: float = 2.5

    @staticmethod
    def _from_base(base, p):
        return _col(p, 0) * torch.exp(base.l * _neg_recip(_col(p, 1)))

    def packed(self):
        return np.array([self.x_m, self.alpha, 0.0], np.float32)

    def quantile(self, u):
        return self.x_m * (1.0 - u) ** (-1.0 / self.alpha)

    def cdf(self, x):
        x = np.asarray(x, np.float64)
        return np.where(
            x >= self.x_m, 1.0 - (self.x_m / np.maximum(x, self.x_m)) ** self.alpha, 0.0
        )


@dataclasses.dataclass(frozen=True)
class Bimodal(StragglerModel):
    """Mixture: with prob p_slow a worker is in the slow mode.  v selects
    the mode, u realizes a unit exponential scaled by the mode's mean."""

    fast_mean: float = 1.0
    slow_mean: float = 10.0
    p_slow: float = 0.1

    NEEDS_SECONDARY = True

    @staticmethod
    def _from_base(base, p):
        slow = base.v < _col(p, 2)
        mean = torch.where(slow, _col(p, 1), _col(p, 0))
        return -base.l * mean

    def packed(self):
        return np.array([self.fast_mean, self.slow_mean, self.p_slow], np.float32)

    def quantile(self, u):
        x = np.linspace(1e-9, self.slow_mean * 30, 200001)
        cdf = (1 - self.p_slow) * (1 - np.exp(-x / self.fast_mean)) + self.p_slow * (
            1 - np.exp(-x / self.slow_mean)
        )
        return np.interp(u, cdf, x)

    def cdf(self, x):
        x = np.asarray(x, np.float64)
        xm = np.maximum(x, 0.0)
        c = (1 - self.p_slow) * -np.expm1(-xm / self.fast_mean) + self.p_slow * (
            -np.expm1(-xm / self.slow_mean)
        )
        return np.where(x > 0, c, 0.0)


@dataclasses.dataclass(frozen=True)
class Deterministic(StragglerModel):
    """Constant response time (no straggling)."""

    value: float = 1.0

    @staticmethod
    def _from_base(base, p):
        if isinstance(p, torch.Tensor):
            return torch.broadcast_to(p[..., 0].to(torch.float32), base.u.shape)
        return torch.full_like(base.u, _col(p, 0))

    @classmethod
    def _sample_packed(cls, key, n, p):
        # consumes no randomness
        return torch.full(key.shape[:-1] + (n,), _col(p, 0), dtype=torch.float32, device=key.device)

    @classmethod
    def _sample_packed_rows(cls, key, pmat):
        return pmat[:, 0].to(torch.float32)

    def packed(self):
        return np.array([self.value, 0.0, 0.0], np.float32)

    def quantile(self, u):
        return np.full_like(np.asarray(u, dtype=np.float64), self.value)

    def cdf(self, x):
        return (np.asarray(x, np.float64) >= self.value).astype(np.float64)

    def mean_order_statistic(self, k: int, n: int) -> float:
        return self.value

    def var_order_statistic(self, k: int, n: int) -> float:
        return 0.0


_REGISTRY = {
    "exponential": Exponential,
    "shifted_exponential": ShiftedExponential,
    "pareto": Pareto,
    "bimodal": Bimodal,
    "deterministic": Deterministic,
}

# Index order is the reference's (packed kind indices): append, never reorder.
SWEEP_FAMILIES = (Exponential, ShiftedExponential, Pareto, Bimodal, Deterministic)


def family_index(model: StragglerModel) -> int:
    """Index of this model's family in SWEEP_FAMILIES."""
    for i, cls in enumerate(SWEEP_FAMILIES):
        if type(model) is cls:
            return i
    raise ValueError(
        f"{type(model).__name__} is not sweepable; families: "
        f"{[c.__name__ for c in SWEEP_FAMILIES]}"
    )


def pack_params(model: StragglerModel) -> np.ndarray:
    """The model's packed (N_STRAGGLER_PARAMS,) float32 parameter vector."""
    p = model.packed()
    if p.shape != (N_STRAGGLER_PARAMS,):
        raise ValueError(f"packed parameters of shape {p.shape}")
    return p


def get_straggler_model(name: str, **kwargs) -> StragglerModel:
    if name not in _REGISTRY:
        raise ValueError(f"unknown straggler model {name!r}; options: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


# --------------------------------------------------------------------------
# Per-worker (heterogeneous) protocol: an (n_slots, 3) float32 matrix and an
# (n_slots,) int32 family vector; slots past n_active hold the INACTIVE row
# (Deterministic +inf), which ranks after every active worker.
# --------------------------------------------------------------------------

INACTIVE_FAMILY = SWEEP_FAMILIES.index(Deterministic)
_INACTIVE_ROW = np.array([np.inf, 0.0, 0.0], np.float32)

SCHEDULE_MODES = {"step": 0, "linear": 1}


@dataclasses.dataclass(frozen=True)
class RateSchedule:
    """Time-varying drift of one packed-parameter leaf.

    The multiplier m(t) of simulated time t scales column ``leaf`` of the
    per-worker parameter matrix before each iteration's draw: ``"step"`` is
    piecewise constant (scales[j] from times[j] on, 1.0 before times[0]),
    ``"linear"`` interpolates through the knots, constant past the ends.
    """

    times: Sequence[float]
    scales: Sequence[float]
    mode: str = "step"
    leaf: int = 0

    def __post_init__(self):
        times = tuple(float(t) for t in self.times)
        scales = tuple(float(s) for s in self.scales)
        object.__setattr__(self, "times", times)
        object.__setattr__(self, "scales", scales)
        if len(times) != len(scales):
            raise ValueError(f"{len(times)} times vs {len(scales)} scales")
        if list(times) != sorted(times):
            raise ValueError(f"schedule times must be non-decreasing: {times}")
        if self.mode not in SCHEDULE_MODES:
            raise ValueError(f"unknown mode {self.mode!r}; options {sorted(SCHEDULE_MODES)}")
        if not 0 <= self.leaf < N_STRAGGLER_PARAMS:
            raise ValueError(f"leaf {self.leaf} outside [0, {N_STRAGGLER_PARAMS})")


@dataclasses.dataclass(frozen=True)
class WorkerFleet:
    """A heterogeneous fleet: one straggler model per worker slot, and an
    optional schedule the engine applies from the carried simulated time."""

    models: Sequence[StragglerModel]
    schedule: Optional[RateSchedule] = None

    def __post_init__(self):
        object.__setattr__(self, "models", tuple(self.models))
        if not self.models:
            raise ValueError("WorkerFleet needs at least one model")
        for m in self.models:
            family_index(m)

    @property
    def n_active(self) -> int:
        return len(self.models)

    def sample(self, key: torch.Tensor, n: int) -> torch.Tensor:
        """One response time per slot at the nominal (t = 0) parameters."""
        pmat, kinds, _ = pack_params_per_worker(self, n)
        return sample_times_per_worker(
            torch.from_numpy(kinds).to(key.device), torch.from_numpy(pmat).to(key.device), key
        )

    def mean_order_statistic(self, k: int, n: int) -> float:
        m1, _ = self._moments(k, n)
        return float(m1)

    def var_order_statistic(self, k: int, n: int) -> float:
        m1, m2 = self._moments(k, n)
        return float(m2 - m1 * m1)

    def _moments(self, k: int, n: int):
        if n != self.n_active:
            raise ValueError(f"order statistic over n={n} workers but fleet has "
                             f"{self.n_active} active models")
        from repro_torch.core import theory  # theory imports this module

        return theory.hetero_order_stat_moments(self.models, k)


def pack_params_per_worker(spec, n_slots: int, n_active: Optional[int] = None):
    """``(pmat (n_slots, 3) f32, kinds (n_slots,) i32, n_active)`` for a
    fleet, or a scalar model broadcast over ``n_active`` slots (default all)."""
    if isinstance(spec, WorkerFleet):
        if n_active is not None and n_active != spec.n_active:
            raise ValueError(f"n_active={n_active} but fleet has {spec.n_active} models")
        models = spec.models
    else:
        models = (spec,) * (n_slots if n_active is None else n_active)
    if len(models) > n_slots:
        raise ValueError(f"{len(models)} active workers > {n_slots} slots")
    pmat = np.tile(_INACTIVE_ROW, (n_slots, 1))
    kinds = np.full((n_slots,), INACTIVE_FAMILY, np.int32)
    for i, m in enumerate(models):
        pmat[i] = pack_params(m)
        kinds[i] = family_index(m)
    return pmat, kinds, len(models)


def pack_schedule(schedule: Optional[RateSchedule], n_slots: int):
    """(mode, leaf, times, scales) as fixed-width leaves: times +inf-padded,
    scales last-value-padded; None packs to a multiplier of exactly 1.0."""
    i32, f32 = np.int32, np.float32
    times = np.full((n_slots,), np.inf, f32)
    scales = np.ones((n_slots,), f32)
    if schedule is None or not len(schedule.times):
        return i32(SCHEDULE_MODES["step"]), i32(0), times, scales
    st = np.asarray(schedule.times, f32)
    sc = np.asarray(schedule.scales, f32)
    if st.size > n_slots:
        raise ValueError(f"{st.size} schedule knots > {n_slots} slots")
    times[: st.size] = st
    scales[: sc.size] = sc
    scales[sc.size:] = sc[-1]
    return i32(SCHEDULE_MODES[schedule.mode]), i32(schedule.leaf), times, scales


def _pick(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[index] for a 1-D tensor and a scalar index, as a masked sum (one
    term, so exact; safe under vmap and in a captured graph)."""
    hit = torch.arange(values.shape[0], device=values.device) == index
    return torch.where(hit, values, 0.0).sum()


def _interp(x, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """`jnp.interp(x, xp, fp)` for scalar x (same arithmetic, +inf knots ok)."""
    n = xp.shape[0]
    i = torch.clamp((xp <= x).sum(), 1, n - 1)
    im1 = torch.where(i - 1 < 0, i - 1 + n, i - 1)
    xp_i, xp_im1, fp_i, fp_im1 = _pick(xp, i), _pick(xp, im1), _pick(fp, i), _pick(fp, im1)
    df = fp_i - fp_im1
    dx = xp_i - xp_im1
    delta = x - xp_im1
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp_im1, fp_im1 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def schedule_multiplier(mode, times, scales, t) -> torch.Tensor:
    """m(t) for packed schedule leaves; both modes computed, one selected."""
    t = torch.as_tensor(t, dtype=torch.float32)
    s = times.shape[0]
    n_passed = (t >= times).sum().to(torch.int32)
    m_step = torch.where(n_passed == 0, 1.0, _pick(scales, torch.clamp(n_passed - 1, 0, s - 1)))
    m_linear = _interp(t, times, scales)
    return torch.where(mode == SCHEDULE_MODES["linear"], m_linear, m_step)


def apply_rate_schedule(pmat, mode, leaf, times, scales, t) -> torch.Tensor:
    """Scale column ``leaf`` of the per-worker matrix by m(t); every other
    column is multiplied by exactly 1.0."""
    mult = schedule_multiplier(mode, times, scales, t)
    col = torch.arange(pmat.shape[1], device=pmat.device) == leaf
    return pmat * torch.where(col, mult, 1.0)[None, :]


def onset_mask(onset_times, t) -> torch.Tensor:
    """Per-slot bool: has simulated time ``t`` reached each slot's onset?"""
    return torch.as_tensor(t, dtype=torch.float32) >= onset_times


def sample_times_per_worker(kinds, pmat, key) -> torch.Tensor:
    """One response time per slot from per-slot families and parameters:
    every family's transform of one base draw, selected per slot."""
    return sample_times_selected(family_select_masks(kinds), pmat, key)


def family_select_masks(kinds) -> tuple:
    """Per-family slot masks (the last family is the chain's default)."""
    return tuple(kinds == j for j in range(len(SWEEP_FAMILIES) - 1))


def sample_times_selected(masks, pmat, key) -> torch.Tensor:
    """Select among every family's transform of the shared base draws."""
    classes = SWEEP_FAMILIES
    base = _base_draws(key, pmat.shape[0], any(c.NEEDS_SECONDARY for c in classes))
    out = classes[-1]._from_base(base, pmat)
    for j in range(len(classes) - 2, -1, -1):
        out = torch.where(masks[j], classes[j]._from_base(base, pmat), out)
    return out


def renewal_remaining(fresh: torch.Tensor, pending: torch.Tensor, remaining: torch.Tensor) -> torch.Tensor:
    """The async modes' residual clocks: a slot with ``pending`` set keeps its
    clock, every other slot takes the ``fresh`` draw (its task's whole
    duration, drawn once at dispatch).  Carried clocks are exact for every
    family; an inactive (+inf) slot draws +inf and is never dispatched."""
    return torch.where(pending, remaining, fresh)
