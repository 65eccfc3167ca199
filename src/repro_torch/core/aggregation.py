"""Fastest-k gradient aggregation, in torch (the main-path half of
`repro.core.aggregation`).

The paper's update (eq. 2) is  w_{j+1} = w_j - (eta/k) sum_{i in R_j} grad F(S_i, w_j),
with R_j the k workers that answer first.  It is realized as the gradient of
a weighted loss: per worker, the sum of its shard's per-example losses,
times the fastest-k mask, over k*s.  The simulated wall-clock time of an
iteration is the k-th smallest response time X_(k), plus an optional affine
communication cost.

Written for one replica (the engine maps it over R with `torch.func.vmap`);
ranks, masks and order statistics also take leading batch dimensions.  No
function here synchronises with the host or builds a tensor from host data,
so each can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.straggler import StragglerModel

__all__ = [
    "CommModel",
    "sample_worker_times",
    "worker_ranks",
    "fastest_k_mask",
    "iteration_time",
    "per_example_weights",
    "masked_mean_weights",
    "fastest_k_weighted_loss",
    "stale_weighted_loss",
    "fastest_k_mask_time",
    "fastest_k_draw",
    "active_worker_mean_loss",
    "AGG_KINDS",
]

# The reference's aggregator kinds; only "mean" is ported (robust
# aggregation is ROADMAP Queue 1 item 10).
AGG_KINDS = {"mean": 0, "trimmed": 1, "median": 2, "geomedian": 3}


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Affine master-side communication cost: t_comm = alpha + beta * k."""

    alpha: float = 0.0
    beta: float = 0.0

    def time(self, k: torch.Tensor) -> torch.Tensor:
        return self.alpha + self.beta * k.to(torch.float32)


def sample_worker_times(model: StragglerModel, key: torch.Tensor, n_workers: int) -> torch.Tensor:
    """iid response times for one iteration, shape (..., n_workers)."""
    return model.sample(key, n_workers)


# The reference's crossover between its pairwise and top_k paths.
_SORT_CROSSOVER_N = 192


def worker_ranks(times: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Stable rank of each entry along the last axis (0 = smallest), ties
    broken by index, +inf after every finite time; int32.

    ``pairwise`` counts, for each entry, the entries before it (O(n^2));
    ``sort`` inverts a stable sort (the reference's ``topk`` path, which
    relies on ``lax.top_k`` returning ties lowest index first; ``torch.topk``
    promises no order among ties, so a stable sort takes its place).  ``auto``
    picks ``pairwise`` below n = 192 and ``sort`` above, as the reference
    does.  Both give a stable argsort's ranks.  NaN is not supported.
    """
    n = times.shape[-1]
    if method == "auto":
        method = "sort" if n >= _SORT_CROSSOVER_N else "pairwise"
    if method == "pairwise":
        idx = torch.arange(n, device=times.device)
        a, b = times[..., None, :], times[..., :, None]
        before = (a < b) | ((a == b) & (idx[None, :] < idx[:, None]))
        return before.sum(dim=-1).to(torch.int32)
    if method == "sort":
        order = torch.sort(times, dim=-1, stable=True).indices
        return torch.sort(order, dim=-1, stable=True).indices.to(torch.int32)
    raise ValueError(f"unknown rank method {method!r}; options: auto|pairwise|sort")


def fastest_k_mask(times: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """{0,1} mask of the k smallest entries of `times` (exactly k ones)."""
    return (worker_ranks(times) < k).to(times.dtype)


def _time_from_ranks(ranks, times, k, comm: Optional[CommModel]) -> torch.Tensor:
    """k-th order statistic of `times` given its ranks (+ comm): a sum with
    one nonzero term, so exact."""
    rank_wanted = torch.clamp(k - 1, 0, times.shape[-1] - 1)
    t = torch.where(ranks == rank_wanted, times, 0.0).sum(dim=-1)
    if comm is not None:
        t = t + comm.time(k)
    return t


def iteration_time(times: torch.Tensor, k: torch.Tensor, comm: Optional[CommModel] = None) -> torch.Tensor:
    """Simulated duration of one fastest-k iteration: X_(k) (+ comm)."""
    return _time_from_ranks(worker_ranks(times), times, k, comm)


def per_example_weights(mask: torch.Tensor, k: torch.Tensor, examples_per_worker: int) -> torch.Tensor:
    """Per-example loss weights v_l = m_{worker(l)} / (k s), worker-major."""
    s = examples_per_worker
    w_worker = mask / (k.to(mask.dtype) * s)
    return torch.repeat_interleave(w_worker, s, dim=-1)


def masked_mean_weights(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-worker weights m_i / k."""
    return mask / k.to(mask.dtype)


def fastest_k_weighted_loss(per_example_losses: torch.Tensor, mask: torch.Tensor, k: torch.Tensor,
                            examples_per_worker: int) -> torch.Tensor:
    """Eq.-(2) weighted loss as a per-worker segment sum dotted with the
    mask, over k*s: no length-m weight vector."""
    s = examples_per_worker
    shard_sums = per_example_losses.reshape(-1, s).sum(dim=1)
    return torch.dot(shard_sums, mask) / (k.to(per_example_losses.dtype) * s)


def stale_weighted_loss(losses_by_worker: torch.Tensor, mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Eq.-(2) weighted loss over (n, s) per-worker evaluations."""
    n, s = losses_by_worker.shape
    return fastest_k_weighted_loss(losses_by_worker.reshape(n * s), mask, k, s)


def fastest_k_mask_time(times: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(participation mask, X_(k)) from one draw, ranks computed once."""
    ranks = worker_ranks(times)
    mask = (ranks < k).to(times.dtype)
    return mask, _time_from_ranks(ranks, times, k, None)


def fastest_k_draw(model: StragglerModel, key: torch.Tensor, n_workers: int, k: torch.Tensor,
                   comm: Optional[CommModel] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One iteration's straggler draw: (participation mask, iteration time)."""
    times = sample_worker_times(model, key, n_workers)
    mask, t = fastest_k_mask_time(times, k)
    if comm is not None:
        t = t + comm.time(k)
    return mask, t


def active_worker_mean_loss(per_example_losses: torch.Tensor, n_active, n_slots: int,
                            examples_per_worker: int) -> torch.Tensor:
    """Mean loss over the active workers' examples (the first n_active
    shards); the plain mean when every slot is active, +inf when none is."""
    s = examples_per_worker
    dtype = per_example_losses.dtype
    if not isinstance(n_active, torch.Tensor):
        n_active = torch.full((), int(n_active), dtype=torch.int32, device=per_example_losses.device)
    full = per_example_losses.mean()
    shard_sums = per_example_losses.reshape(n_slots, s).sum(dim=1)
    active = (torch.arange(n_slots, device=per_example_losses.device) < n_active).to(dtype)
    masked = torch.dot(shard_sums, active) / (torch.clamp_min(n_active, 1).to(dtype) * s)
    masked = torch.where(n_active == 0, float("inf"), masked)
    return torch.where(n_active == n_slots, full, masked)
