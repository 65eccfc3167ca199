"""Fastest-k gradient aggregation and the robust aggregators, in torch (the
port of `repro.core.aggregation`).

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

The robust aggregators (the Byzantine-fault axis, `faults`) work on the
per-worker gradient rows instead of their mask-weighted sum: a
per-coordinate trimmed mean, a per-coordinate median, and the geometric
median by a fixed number of Weiszfeld iterations.  `make_robust_select`
makes them a per-cell select over the mean path's gradient, so a mean cell
in a robust program keeps its gradient bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.core.straggler import StragglerModel
from repro_torch.core.tree import map_with_index, tree_leaves

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
    "AGG_MEAN",
    "AGG_TRIMMED",
    "AGG_MEDIAN",
    "AGG_GEOMEDIAN",
    "WEISZFELD_ITERS",
    "trimmed_mean_rows",
    "coordinate_median_rows",
    "geometric_median_rows",
    "make_robust_select",
    "fastest_k_iteration",
]


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


# --------------------------------------------------------- robust aggregation

# The reference's aggregator kinds, the sweep's select indices.  Append;
# never reorder.
AGG_KINDS = {"mean": 0, "trimmed": 1, "median": 2, "geomedian": 3}
AGG_MEAN, AGG_TRIMMED, AGG_MEDIAN, AGG_GEOMEDIAN = range(4)

# Weiszfeld's iteration count, fixed so that every robust program runs the
# same ops (the reference's).
WEISZFELD_ITERS = 8
_WEISZFELD_EPS = 1e-12


def _sorted_masked(mat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each column of the (n_slots, D) rows sorted ascending, the rows of
    non-participants first set to +inf: rows 0..k-1 hold the k arrived
    values.  A stable sort, as `jnp.sort`: -0.0 and 0.0 keep their order."""
    vals = torch.where(mask[:, None] > 0, mat, float("inf"))
    return torch.sort(vals, dim=0, stable=True).values


def _row_at(svals: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a tensor index) of ``svals``, gathered: exact for every
    value, a -0.0 included, which a one-hot sum would turn into 0.0."""
    idx = i.to(torch.int64).reshape(1, 1).expand(1, svals.shape[1])
    return svals.gather(0, idx)[0]


def trimmed_mean_rows(mat: torch.Tensor, mask: torch.Tensor, k: torch.Tensor, trim_frac) -> torch.Tensor:
    """Per coordinate, the mean of the k arrived values without their
    ``t = floor(trim_frac * k)`` smallest and largest (t at most (k-1)//2,
    so one value always remains).  ``trim_frac`` is a lane's f32 leaf or a
    float."""
    n = mat.shape[0]
    t = torch.floor(trim_frac * k.to(torch.float32)).to(torch.int32)
    t = torch.minimum(t, (k - 1) // 2)
    svals = _sorted_masked(mat, mask)
    pos = torch.arange(n, dtype=torch.int32, device=mat.device)[:, None]
    keep = (pos >= t) & (pos <= k - 1 - t)
    cnt = (k - 2 * t).to(mat.dtype)
    return torch.where(keep, svals, 0.0).sum(dim=0) / cnt


def coordinate_median_rows(mat: torch.Tensor, mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per coordinate, the median of the k arrived values (the middle one
    for odd k, the mean of the two middle ones for even k)."""
    svals = _sorted_masked(mat, mask)
    lo = _row_at(svals, (k - 1) // 2)
    hi = _row_at(svals, k // 2)
    return 0.5 * (lo + hi)


def geometric_median_rows(mat: torch.Tensor, mask: torch.Tensor, k: torch.Tensor,
                          n_iter: int = WEISZFELD_ITERS) -> torch.Tensor:
    """The geometric median of the arrived rows by ``n_iter`` Weiszfeld
    iterations from their mean: ``y <- sum_i w_i x_i / sum_i w_i`` with
    ``w_i = mask_i / max(||x_i - y||, eps)``.  The eps clamp makes rows that
    all coincide a fixed point and keeps a 0/0 out when y lands on a row."""
    kf = k.to(mat.dtype)
    y = torch.tensordot(mask, mat, dims=1) / kf
    for _ in range(n_iter):
        diff = mat - y[None, :]
        d = torch.sqrt((diff * diff).sum(dim=1))
        w = mask / torch.clamp_min(d, _WEISZFELD_EPS)
        y = torch.tensordot(w, mat, dims=1) / w.sum()
    return y


def _flatten_rows(rows):
    """A pytree of (n_slots, ...) leaves as ((n_slots, D) f32 rows, its leaves
    concatenated in JAX's order) and ``unflatten(vec)``, a params-shaped
    pytree of the vector's pieces."""
    leaves = tree_leaves(rows)
    n = leaves[0].shape[0]
    mat = torch.cat([leaf.reshape(n, -1).to(torch.float32) for leaf in leaves], dim=1)
    offsets = [0]
    for leaf in leaves:
        offsets.append(offsets[-1] + leaf[0].numel())

    def unflatten(vec):
        return map_with_index(
            lambda j, leaf: vec[offsets[j]:offsets[j + 1]].reshape(leaf.shape[1:]).to(leaf.dtype), rows)

    return mat, unflatten


def make_robust_select(agg_kind, agg_param, present: tuple):
    """``select(mean_g, rows, mask, k) -> g``, the per-cell aggregator over
    the per-worker rows, or None when ``present`` (the static set of kinds
    the program runs) holds only the mean.  Only the robust kinds present
    are computed; ``agg_kind`` and ``agg_param`` are a lane's leaves or (the
    looped engine) an int and a float, whose selects fold away here.  A mean
    cell takes ``mean_g`` through the `torch.where` chain unchanged."""
    robust = tuple(sorted(set(present) - {AGG_MEAN}))
    if not robust:
        return None

    def select(mean_g, rows, mask, k):
        mat, unflatten = _flatten_rows(rows)
        g = mean_g
        for kind in robust:
            if isinstance(agg_kind, int) and agg_kind != kind:
                continue
            if kind == AGG_TRIMMED:
                val = trimmed_mean_rows(mat, mask, k, agg_param)
            elif kind == AGG_MEDIAN:
                val = coordinate_median_rows(mat, mask, k)
            elif kind == AGG_GEOMEDIAN:
                val = geometric_median_rows(mat, mask, k)
            else:
                raise ValueError(f"unknown aggregator kind {kind}")
            vg = unflatten(val)
            if isinstance(agg_kind, int):
                g = vg
            else:
                g = tree_map(lambda a, b, _kind=kind: torch.where(agg_kind == _kind, b, a), g, vg)
        return g

    return select


def fastest_k_iteration(model: StragglerModel, key: torch.Tensor, n_workers: int, k: torch.Tensor,
                        examples_per_worker: int, comm: Optional[CommModel] = None):
    """(per-example weights, mask, iteration time) of one draw, ranks shared
    between the mask and the order statistic: eq. (2)'s reference form
    (the engines use `fastest_k_draw` and `fastest_k_weighted_loss`)."""
    times = sample_worker_times(model, key, n_workers)
    ranks = worker_ranks(times)
    mask = (ranks < k).to(times.dtype)
    weights = per_example_weights(mask, k, examples_per_worker)
    t = _time_from_ranks(ranks, times, k, comm)
    return weights, mask, t
