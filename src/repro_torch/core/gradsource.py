"""Pluggable gradient sources: the engine's loss abstraction, in torch.

The port of `repro.core.gradsource`.  A source hands the engines the
closures they consume:

    source.check(data, n_workers)        # host-side validation
    fns = source.build(data, n_workers)  # -> SourceFns
    fns.grad(params, mask, k)            # eq.-(2) masked aggregate gradient
    fns.eval_loss(params)                # mean loss over all shards
    fns.eval_loss_active(params, n_active)   # inactive shards held out
    stale_grad, shard_grad_at = source.build_stale(data, n_workers)  # async modes
    source.cache_token()                 # hashable program-cache key part

`build` and `build_stale` close over `data`; the closures are written for
one replica and mapped over R by the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, NamedTuple, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import aggregation, execmode

__all__ = ["SourceFns", "GradSource", "PerExampleSource"]


class SourceFns(NamedTuple):
    """``grad(params, mask, k)``: (1/k) sum_{i: mask_i} (1/s) sum_{a in S_i}
    grad F(a, params); ``eval_loss(params)``: the mean loss over every
    shard; ``eval_loss_active(params, n_active)``: shards of slots >=
    n_active held out (equal to ``eval_loss`` when every slot is active)."""

    grad: Callable
    eval_loss: Callable
    eval_loss_active: Callable


@runtime_checkable
class GradSource(Protocol):
    """What the engine requires of a gradient source."""

    def check(self, data: Any, n_workers: int) -> None:
        """Host-side validation; raise ValueError."""

    def build(self, data: Any, n_workers: int) -> SourceFns:
        """Closures over ``data``.  Launches nothing."""

    def build_stale(self, data: Any, n_workers: int) -> Tuple[Callable, Callable]:
        """``(stale_grad, shard_grad_at)`` of the async modes
        (`execmode.make_stale_grad_fns`)."""

    def cache_token(self) -> Hashable:
        """Equal tokens must build identical programs."""


@dataclasses.dataclass(frozen=True)
class PerExampleSource:
    """A per-example loss over ``(X, y)``: ``per_example_loss_fn(params, X,
    y) -> (m,)`` losses, rows worker-major (worker i owns rows [i*s, (i+1)*s))."""

    per_example_loss_fn: Callable

    def weighted_loss(self, per_example_losses, mask, k, examples_per_worker):
        """Eq.-(2) segment-sum weighted loss."""
        return aggregation.fastest_k_weighted_loss(per_example_losses, mask, k, examples_per_worker)

    def stale_weighted_loss(self, losses_by_worker, mask, k):
        return aggregation.stale_weighted_loss(losses_by_worker, mask, k)

    def check(self, data, n_workers: int) -> None:
        m = data[0].shape[0]
        if m % n_workers:
            raise ValueError(f"m={m} not divisible by n_workers={n_workers}")

    def build(self, data, n_workers: int) -> SourceFns:
        X, y = data
        s = X.shape[0] // n_workers
        loss = self.per_example_loss_fn

        def step_loss(params, mask, k):
            return self.weighted_loss(loss(params, X, y), mask, k, s)

        def eval_loss(params):
            return loss(params, X, y).mean()

        def eval_loss_active(params, n_active):
            return aggregation.active_worker_mean_loss(loss(params, X, y), n_active, n_workers, s)

        return SourceFns(grad=torch.func.grad(step_loss), eval_loss=eval_loss,
                         eval_loss_active=eval_loss_active)

    def build_stale(self, data, n_workers: int):
        X, y = data
        s = X.shape[0] // n_workers
        Xw = X.reshape((n_workers, s) + tuple(X.shape[1:]))
        yw = y.reshape((n_workers, s) + tuple(y.shape[1:]))
        return execmode.make_stale_grad_fns(self.per_example_loss_fn, Xw, yw, n_workers,
                                            stale_weighted_loss=self.stale_weighted_loss)

    def cache_token(self) -> Hashable:
        return ("per_example", self.per_example_loss_fn)
