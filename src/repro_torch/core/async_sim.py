"""Event-driven asynchronous distributed SGD (paper §V-C, the fig3
baseline), in torch: the port of `repro.core.async_sim`.

The master applies each arriving (stale) partial gradient as it arrives and
re-dispatches that worker from the new model.  Worker completions are a
host heap; parameters, snapshots and gradients are tensors on the device,
and every event costs one round trip (the worker's next response time).
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List

import torch
from torch.utils._pytree import tree_map

from repro_torch import resolve_device
from repro_torch.core import prng

__all__ = ["simulate_async_sgd"]


def simulate_async_sgd(
    grad_fn: Callable,  # grad_fn(params, worker_id) -> gradient pytree over shard S_i
    eval_fn: Callable,  # eval_fn(params) -> scalar loss
    params0,
    n_workers: int,
    eta: float,
    straggler,
    total_time: float,
    key,
    eval_every: int = 10,
    device="cuda",
) -> Dict[str, List[float]]:
    """Fully asynchronous SGD until simulated time ``total_time``; returns
    the history {'time', 'loss', 'updates'} every ``eval_every`` updates
    (and a final partial point)."""
    dev = resolve_device(device)
    key = prng.as_key(key, dev)
    params = tree_map(lambda p: torch.as_tensor(p).to(dev), params0)
    snapshots = [params for _ in range(n_workers)]
    events: list[tuple[float, int]] = []
    key, sub = prng.split(key).unbind(0)
    first = straggler.sample(sub, n_workers).tolist()
    for i in range(n_workers):
        heapq.heappush(events, (float(first[i]), i))

    history: Dict[str, List[float]] = {"time": [], "loss": [], "updates": []}
    t, t_last, n_updates = 0.0, 0.0, 0
    while events:
        t, i = heapq.heappop(events)
        if t > total_time:
            break
        t_last = t
        g = grad_fn(snapshots[i], i)  # stale gradient
        params = tree_map(lambda p, gi: p - eta * gi, params, g)
        n_updates += 1
        snapshots[i] = params
        key, sub = prng.split(key).unbind(0)
        dt = float(straggler.sample(sub, 1)[0].item())
        heapq.heappush(events, (t + dt, i))
        if n_updates % eval_every == 0:
            history["time"].append(t)
            history["loss"].append(float(eval_fn(params)))
            history["updates"].append(n_updates)
    if n_updates and n_updates % eval_every:
        history["time"].append(t_last)
        history["loss"].append(float(eval_fn(params)))
        history["updates"].append(n_updates)
    return history
