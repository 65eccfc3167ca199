"""Adaptive-k controllers, in torch (the port of `repro.core.controller`).

All five share one interface, so the engine's step is policy-agnostic:

    state  = controller.init(params_like)
    state, k = controller.update(state, grads, sim_time, stats)

States are named tuples of tensors and `k` is an int32 tensor.  Every
branch is a `torch.where`: no `.item()`, no Python `if` on a tensor, so an
update can be mapped over replicas with `torch.func.vmap` and captured in a
CUDA graph.  For the same reason nothing in `update` builds a tensor from
host data: the schedule's switch times live in its state.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, NamedTuple, Sequence

import torch
from torch.utils._pytree import tree_map

from repro_torch.core import prng
from repro_torch.core.tree import first_leaf, leaves_with_path, tree_dot

__all__ = [
    "PflugState",
    "PflugController",
    "SketchedPflugState",
    "SketchedPflugController",
    "FixedState",
    "FixedKController",
    "ScheduleState",
    "ScheduleController",
    "VarianceRatioState",
    "VarianceRatioController",
    "get_controller",
]


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def _zeros_like_f32(tree):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


def _sign_event(dot: torch.Tensor, have_prev: torch.Tensor) -> torch.Tensor:
    """+1 for a negative inner product, -1 for a non-negative one, 0 before
    the first previous gradient exists."""
    return torch.where(have_prev, torch.where(dot < 0, 1, -1), 0).to(torch.int32)


class PflugState(NamedTuple):
    k: torch.Tensor  # int32: workers waited for
    count_negative: torch.Tensor  # int32: (#negative - #positive) sign events
    count_iter: torch.Tensor  # int32: iterations since the last switch
    prev_grad: Any  # pytree: the previous aggregated gradient
    have_prev: torch.Tensor  # bool
    n_switches: torch.Tensor  # int32


@dataclasses.dataclass(frozen=True)
class PflugController:
    """Algorithm 1: Pflug's test on sign(g_j . g_{j-1}).  The counter rises on
    a negative product and falls on a positive one; when it exceeds
    `thresh` after `burnin` iterations and k + step <= k_max, k += step and
    both counters reset."""

    n_workers: int
    k0: int = 1
    step: int = 1
    thresh: int = 10
    burnin: int = 0
    k_max: int | None = None  # defaults to n_workers

    def init(self, params_like) -> PflugState:
        dev = first_leaf(params_like).device
        return PflugState(
            k=_scalar(self.k0, torch.int32, dev),
            count_negative=_scalar(0, torch.int32, dev),
            count_iter=_scalar(1, torch.int32, dev),
            prev_grad=_zeros_like_f32(params_like),
            have_prev=_scalar(False, torch.bool, dev),
            n_switches=_scalar(0, torch.int32, dev),
        )

    def update(self, state: PflugState, grads, sim_time, stats=None):
        del sim_time, stats
        k_cap = self.k_max if self.k_max is not None else self.n_workers
        count_neg = state.count_negative + _sign_event(tree_dot(grads, state.prev_grad), state.have_prev)
        do_switch = (count_neg > self.thresh) & (state.count_iter > self.burnin) & (state.k + self.step <= k_cap)
        new_k = torch.where(do_switch, state.k + self.step, state.k)
        new_state = PflugState(
            k=new_k,
            count_negative=torch.where(do_switch, 0, count_neg),
            count_iter=torch.where(do_switch, 0, state.count_iter) + 1,
            prev_grad=tree_map(lambda g: g.to(torch.float32), grads),
            have_prev=torch.ones_like(state.have_prev),
            n_switches=state.n_switches + do_switch.to(torch.int32),
        )
        return new_state, new_k


class SketchedPflugState(NamedTuple):
    k: torch.Tensor
    count_negative: torch.Tensor
    count_iter: torch.Tensor
    prev_sketch: torch.Tensor  # (sketch_dim,)
    have_prev: torch.Tensor
    n_switches: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SketchedPflugController:
    """Algorithm 1 on a count sketch of the gradient: one Rademacher sign
    vector per leaf, drawn from seed + crc32(keystr(path)) mod 2^30 with the
    port's threefry (so the signs are the reference's), and positional
    bucketing into sketch_dim bins."""

    n_workers: int
    k0: int = 1
    step: int = 1
    thresh: int = 10
    burnin: int = 0
    k_max: int | None = None
    sketch_dim: int = 64
    seed: int = 1234

    def init(self, params_like) -> SketchedPflugState:
        dev = first_leaf(params_like).device
        return SketchedPflugState(
            k=_scalar(self.k0, torch.int32, dev),
            count_negative=_scalar(0, torch.int32, dev),
            count_iter=_scalar(1, torch.int32, dev),
            prev_sketch=torch.zeros((self.sketch_dim,), dtype=torch.float32, device=dev),
            have_prev=_scalar(False, torch.bool, dev),
            n_switches=_scalar(0, torch.int32, dev),
        )

    def _sketch(self, grads) -> torch.Tensor:
        m = self.sketch_dim
        z = None
        for path, g in leaves_with_path(grads):
            digest = zlib.crc32(path.encode("utf-8"))
            leaf_seed = self.seed + (digest % (2**30))
            key = torch.stack([_scalar(0, torch.int64, g.device),
                               _scalar(leaf_seed & prng.MASK, torch.int64, g.device)])
            signs = prng.rademacher(key, tuple(g.shape))
            t = (signs * g.to(torch.float32)).reshape(-1)
            pad = (-t.numel()) % m
            if pad:
                t = torch.cat([t, t.new_zeros(pad)])
            part = t.reshape(-1, m).sum(dim=0)
            z = part if z is None else z + part
        if z is None:
            raise ValueError("sketch of an empty pytree")
        return z

    def update(self, state: SketchedPflugState, grads, sim_time, stats=None):
        del sim_time, stats
        k_cap = self.k_max if self.k_max is not None else self.n_workers
        z = self._sketch(grads)
        count_neg = state.count_negative + _sign_event(torch.dot(z, state.prev_sketch), state.have_prev)
        do_switch = (count_neg > self.thresh) & (state.count_iter > self.burnin) & (state.k + self.step <= k_cap)
        new_k = torch.where(do_switch, state.k + self.step, state.k)
        return (
            SketchedPflugState(
                k=new_k,
                count_negative=torch.where(do_switch, 0, count_neg),
                count_iter=torch.where(do_switch, 0, state.count_iter) + 1,
                prev_sketch=z,
                have_prev=torch.ones_like(state.have_prev),
                n_switches=state.n_switches + do_switch.to(torch.int32),
            ),
            new_k,
        )


class FixedState(NamedTuple):
    k: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FixedKController:
    """Non-adaptive fastest-k SGD (the paper's baseline)."""

    n_workers: int
    k: int = 1

    def init(self, params_like) -> FixedState:
        return FixedState(k=_scalar(self.k, torch.int32, first_leaf(params_like).device))

    def update(self, state: FixedState, grads, sim_time, stats=None):
        del grads, sim_time, stats
        return state, state.k


class ScheduleState(NamedTuple):
    k: torch.Tensor
    switch_times: torch.Tensor  # (n_switches,) float32, constant


@dataclasses.dataclass(frozen=True)
class ScheduleController:
    """Theorem-1 policy: k = k0 + step * #(switch times passed), capped at n.
    `switch_times[i]` comes from `repro_torch.core.theory.switching_times`."""

    n_workers: int
    switch_times: Sequence[float]
    k0: int = 1
    step: int = 1

    def init(self, params_like) -> ScheduleState:
        dev = first_leaf(params_like).device
        return ScheduleState(
            k=_scalar(self.k0, torch.int32, dev),
            switch_times=torch.tensor([float(t) for t in self.switch_times], dtype=torch.float32, device=dev),
        )

    def update(self, state: ScheduleState, grads, sim_time, stats=None):
        del grads, stats
        n_passed = (sim_time >= state.switch_times).sum().to(torch.int32)
        k = torch.clamp_max(self.k0 + self.step * n_passed, self.n_workers)
        return ScheduleState(k=k, switch_times=state.switch_times), k


class VarianceRatioState(NamedTuple):
    k: torch.Tensor
    ema_mean: Any  # pytree EMA of the gradient
    ema_sq: torch.Tensor  # EMA of its squared norm
    count_iter: torch.Tensor
    have_prev: torch.Tensor
    n_switches: torch.Tensor


@dataclasses.dataclass(frozen=True)
class VarianceRatioController:
    """Beyond-paper: k += step when ||EMA(g)||^2 / EMA(||g||^2) falls below
    `ratio_thresh` after `burnin` iterations; the EMAs reset on a switch."""

    n_workers: int
    k0: int = 1
    step: int = 1
    decay: float = 0.9
    ratio_thresh: float = 0.2
    burnin: int = 20
    k_max: int | None = None

    def init(self, params_like) -> VarianceRatioState:
        dev = first_leaf(params_like).device
        return VarianceRatioState(
            k=_scalar(self.k0, torch.int32, dev),
            ema_mean=_zeros_like_f32(params_like),
            ema_sq=_scalar(0.0, torch.float32, dev),
            count_iter=_scalar(0, torch.int32, dev),
            have_prev=_scalar(False, torch.bool, dev),
            n_switches=_scalar(0, torch.int32, dev),
        )

    def update(self, state: VarianceRatioState, grads, sim_time, stats=None):
        del sim_time, stats
        k_cap = self.k_max if self.k_max is not None else self.n_workers
        d = self.decay
        ema_mean = tree_map(lambda m, g: d * m + (1 - d) * g.to(torch.float32), state.ema_mean, grads)
        ema_sq = d * state.ema_sq + (1 - d) * tree_dot(grads, grads)
        ratio = tree_dot(ema_mean, ema_mean) / torch.clamp_min(ema_sq, 1e-30)
        do_switch = (ratio < self.ratio_thresh) & (state.count_iter > self.burnin) & (state.k + self.step <= k_cap)
        new_k = torch.where(do_switch, state.k + self.step, state.k)
        return (
            VarianceRatioState(
                k=new_k,
                ema_mean=tree_map(lambda m: torch.where(do_switch, torch.zeros_like(m), m), ema_mean),
                ema_sq=torch.where(do_switch, 0.0, ema_sq),
                count_iter=torch.where(do_switch, 0, state.count_iter) + 1,
                have_prev=torch.ones_like(state.have_prev),
                n_switches=state.n_switches + do_switch.to(torch.int32),
            ),
            new_k,
        )


_REGISTRY = {
    "pflug": PflugController,
    "sketched_pflug": SketchedPflugController,
    "fixed": FixedKController,
    "schedule": ScheduleController,
    "variance_ratio": VarianceRatioController,
}


def get_controller(name: str, n_workers: int, **kw):
    if name not in _REGISTRY:
        raise ValueError(f"unknown controller {name!r}; options {sorted(_REGISTRY)}")
    return _REGISTRY[name](n_workers=n_workers, **kw)
