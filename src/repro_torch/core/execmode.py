"""Execution modes: k-sync / K-async / K-batch-async SGD as one carry, in torch.

The port of `repro.core.execmode`.  The paper studies synchronous fastest-k
SGD; Dutta et al. (arXiv:1803.01113) put it beside the asynchronous family,
where stale gradients trade error per update for wall-clock time as k does:

* ``sync``   — every iteration all n workers draw fresh response times, the
  master applies the fastest k fresh partial gradients and restarts everyone;
  an iteration lasts the order statistic X_(k).
* ``kasync`` — K-async: workers compute against the snapshot they were
  dispatched with; the master waits for the next K completions, applies
  their stale partial gradients averaged over K, and redispatches exactly
  those K from the new model; the others' clocks carry over.
* ``kbatch`` — K-batch-async: every completion redispatches its worker at
  once (from the pre-update model), and the master updates once K gradients
  have arrived, so a fast worker can land several of them in one update.

Asynchrony is a renewal process carried through the step (`ExecCarry`):
per-worker residual clocks, parameter snapshots and staleness counters (in
master updates since the worker read its snapshot).  A task's duration is
drawn once, at dispatch (`straggler.renewal_remaining`), and ticks down as
master events pass, so the clocks are exact for every straggler family.

Everything here is written for one replica, as the reference's functions
are; the engines map it over their lanes with `torch.func.vmap` (with
`CARRY_DIMS` for the carry, whose ``opt_state`` is None).  Indexing by a
worker picked at run time (kbatch's completer) is a one-hot select, so no
op reads the host and every step can be captured in a CUDA graph.  Both
engines build their steps from `make_mode_prelude_and_tails`, so a sweep
cell is the looped engine's run of that cell, op for op.

Faults and robust aggregation (the reference's ``faults=`` and
``robust_agg=``) are not ported: their hooks pass through here, and any
other value raises (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.core import aggregation, prng
from repro_torch.core.straggler import renewal_remaining

__all__ = [
    "MODES",
    "MODE_SYNC",
    "MODE_KASYNC",
    "MODE_KBATCH",
    "ExecStats",
    "ExecCarry",
    "CARRY_DIMS",
    "ModePrelude",
    "zero_stats",
    "init_exec_carry",
    "make_stale_grad_fns",
    "make_mode_prelude_and_tails",
    "make_mode_steps",
]

# The reference's indices: the sweep stores them in its mode leaf.
MODES = {"sync": 0, "kasync": 1, "kbatch": 2}
MODE_SYNC, MODE_KASYNC, MODE_KBATCH = MODES["sync"], MODES["kasync"], MODES["kbatch"]


class ExecStats(NamedTuple):
    """What one update hands the controller: ``arrivals`` (K; k for sync,
    int32), and the mean (f32) and max (int32) staleness of the gradients
    applied, zero in sync mode.  The ported controllers ignore it."""

    arrivals: torch.Tensor
    mean_staleness: torch.Tensor
    max_staleness: torch.Tensor


def zero_stats(k: torch.Tensor) -> ExecStats:
    return ExecStats(arrivals=k.to(torch.int32),
                     mean_staleness=torch.zeros((), dtype=torch.float32, device=k.device),
                     max_staleness=torch.zeros((), dtype=torch.int32, device=k.device))


class ExecCarry(NamedTuple):
    """The carry of every mode (a superset of the sync carry).

    ``worker_params`` stacks each worker's dispatch snapshot on a leading
    (n_slots,) axis; ``remaining`` is each task's residual clock;
    ``pending`` marks slots whose clock is drawn (False: the slot takes a
    fresh draw at the next event); ``staleness`` counts master updates since
    each worker read its snapshot.  The sync step leaves these four as they
    are.  ``opt_state`` is None for the engines' plain SGD."""

    params: Any
    worker_params: Any
    remaining: torch.Tensor  # (n_slots,) f32
    staleness: torch.Tensor  # (n_slots,) int32
    pending: torch.Tensor  # (n_slots,) bool
    ctrl_state: Any
    sim_time: torch.Tensor
    key: torch.Tensor
    opt_state: Any = None


# vmap's in_dims / out_dims of an ExecCarry: every field over the lanes but
# the empty opt_state, which vmap cannot take as an input or an output.
CARRY_DIMS = ExecCarry(0, 0, 0, 0, 0, 0, 0, 0, None)


def init_exec_carry(params0, n_slots: int, ctrl_state, key: torch.Tensor, opt_state: Any = None) -> ExecCarry:
    """t = 0: every worker is about to be dispatched from params0."""
    dev = key.device
    return ExecCarry(
        params=params0,
        worker_params=tree_map(lambda p: p.unsqueeze(0).expand((n_slots,) + tuple(p.shape)).clone(), params0),
        remaining=torch.zeros((n_slots,), dtype=torch.float32, device=dev),
        staleness=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        pending=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
        ctrl_state=ctrl_state,
        sim_time=torch.zeros((), dtype=torch.float32, device=dev),
        key=key,
        opt_state=opt_state,
    )


def _slot_bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(n_slots,) mask reshaped to broadcast against an (n_slots, ...) leaf."""
    return mask.reshape(tuple(mask.shape) + (1,) * (like.dim() - 1))


def _pick_slot(a: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for the one slot ``hit`` marks: a sum with one nonzero term,
    so exact, and safe under vmap and in a captured graph."""
    return torch.where(_slot_bcast(hit, a), a, 0).sum(dim=0)


def make_stale_grad_fns(per_example_loss_fn: Callable, Xw, yw, n_slots: int,
                        stale_weighted_loss: Optional[Callable] = None):
    """``(stale_grad, shard_grad_at)``, the async modes' gradients, built once
    so that both engines run the same ops.  ``Xw``/``yw`` are the worker-major
    data reshaped to a leading (n_slots, s) axis; ``stale_weighted_loss``
    defaults to the eq.-(2) aggregate of `aggregation`.

    * ``stale_grad(worker_params, mask_f32, k)`` — the K-async update
      direction: each slot's per-example losses at that slot's own snapshot
      (vmap over the stacked snapshots), weighted by eq. (2), differentiated
      with respect to the stack and summed over the slots.
    * ``shard_grad_at(worker_params, i)`` — slot i's stale partial gradient
      (kbatch's inner event); ``i`` is a tensor index, selected one-hot.
    """
    if stale_weighted_loss is None:
        stale_weighted_loss = aggregation.stale_weighted_loss
    slot_idx = torch.arange(n_slots, device=Xw.device)

    def stale_loss(worker_params, mask, k):
        losses = torch.func.vmap(per_example_loss_fn)(worker_params, Xw, yw)
        return stale_weighted_loss(losses.reshape(n_slots, -1), mask, k)

    stale_grad_stack = torch.func.grad(stale_loss)

    def stale_grad(worker_params, mask, k):
        # row i is worker i's eq.-(2)-weighted stale partial gradient
        return tree_map(lambda g: g.sum(dim=0), stale_grad_stack(worker_params, mask, k))

    def shard_grad_at(worker_params, i):
        hit = slot_idx == i
        wp_i = tree_map(lambda a: _pick_slot(a, hit), worker_params)
        Xi, yi = _pick_slot(Xw, hit), _pick_slot(yw, hit)
        return torch.func.grad(lambda w: per_example_loss_fn(w, Xi, yi).mean())(wp_i)

    return stale_grad, shard_grad_at


class ModePrelude(NamedTuple):
    """The per-event work every mode shares, computed once before the tails:
    ``new_key`` and ``sub`` (the carry key's split), ``k`` (the controller's
    k, or K), and, unless the caller runs kbatch alone, the clocks after
    renewal (``remaining``), the mask of the K smallest (``arrive_f``), the
    K-th smallest (``tau``) and the event's duration with comm (``t_iter``).
    A sync lane never sets ``pending``, so its clocks are the fresh draw."""

    new_key: torch.Tensor
    sub: torch.Tensor
    k: torch.Tensor
    remaining: Optional[torch.Tensor] = None
    arrive_f: Optional[torch.Tensor] = None
    tau: Optional[torch.Tensor] = None
    t_iter: Optional[torch.Tensor] = None


def make_mode_prelude_and_tails(
    *,
    n_slots: int,
    draw: Callable,  # draw(sub, sim_time) -> (n_slots,) fresh task durations
    sync_grad: Callable,  # sync_grad(params, mask, k) -> eq.-(2) gradient
    stale_grad: Callable,  # stale_grad(worker_params, mask_f32, k)
    shard_grad_at: Callable,  # shard_grad_at(worker_params, i)
    comm_time: Optional[Callable],  # comm_time(k) -> f32 receive cost; None: no comm
    eta,  # a float or a lane's f32 leaf
    ctrl_update: Callable,  # ctrl_update(state, g, sim_time, stats) -> (state, k)
    ctrl_k: Callable = lambda s: s.k,
    apply_update: Optional[Callable] = None,  # (params, g, opt_state) -> (params, opt_state)
    faults=None,
    robust_agg: Optional[Callable] = None,
):
    """The modes as a shared prelude and one tail each, the reference's
    factoring: ``prelude(carry, with_ranking=True) -> ModePrelude`` and
    ``tails[mode](carry, prelude) -> (carry, k)``, every tail returning the
    same structure so a grid can select among them per lane.  A tail after
    the prelude is its mode's whole step.  ``with_ranking=False`` leaves out
    the draw and the ranking, which only sync and kasync read: XLA drops
    them from a kbatch-only program, and torch, which runs every op it is
    given, is told to here.

    ``comm_time=None`` leaves out the receive cost (``+ 0.0`` everywhere it
    would appear).  ``apply_update`` defaults to plain SGD, ``p - eta * g``,
    with ``opt_state`` passed through.  ``faults`` and ``robust_agg`` must
    be None: the hooks that take them (``corrupted_grad``,
    ``hold_if_dead``) pass through.
    """
    if faults is not None or robust_agg is not None:
        raise NotImplementedError(
            "faults and robust aggregation in the mode tails wait for the port of core/faults.py and the robust "
            "half of core/aggregation.py (ROADMAP Queue 1 item 10)")
    if apply_update is None:

        def apply_update(params, g, opt_state):
            return tree_map(lambda pa, gi: pa - eta * gi, params, g), opt_state

    def corrupted_grad(mean_grad_fn, rows_wp, arrive_f, k, sub, t0):
        """The fault transforms and the robust select of item 10; without
        them, the mode's eq.-(2) gradient ``mean_grad_fn(mask, k)``."""
        del rows_wp, sub, t0
        return mean_grad_fn(arrive_f, k)

    def hold_if_dead(params, old_params, remaining):
        """Item 10's crash pin (parameters hold once every clock is +inf);
        without crashes, the new parameters."""
        del old_params, remaining
        return params

    def prelude(carry: ExecCarry, with_ranking: bool = True) -> ModePrelude:
        keys = prng.split(carry.key)
        k = ctrl_k(carry.ctrl_state)
        if not with_ranking:
            return ModePrelude(new_key=keys[0], sub=keys[1], k=k)
        remaining = renewal_remaining(draw(keys[1], carry.sim_time), carry.pending, carry.remaining)
        # the sync primitive over the residual clocks: the arrivals are the K
        # smallest, the event lasts the K-th
        arrive_f, tau = aggregation.fastest_k_mask_time(remaining, k)
        t_iter = tau if comm_time is None else tau + comm_time(k)
        return ModePrelude(new_key=keys[0], sub=keys[1], k=k, remaining=remaining, arrive_f=arrive_f, tau=tau,
                           t_iter=t_iter)

    def sync_tail(carry: ExecCarry, p: ModePrelude):
        # the fresh eq.-(2) gradient at the master's params; the async fields
        # pass through
        k = p.k
        g = corrupted_grad(lambda m, kk: sync_grad(carry.params, m, kk), None, p.arrive_f, k, p.sub,
                           carry.sim_time)
        params, opt_state = apply_update(carry.params, g, carry.opt_state)
        params = hold_if_dead(params, carry.params, p.remaining)
        sim_time = carry.sim_time + p.t_iter
        ctrl_state, _ = ctrl_update(carry.ctrl_state, g, sim_time, zero_stats(k))
        return carry._replace(params=params, ctrl_state=ctrl_state, sim_time=sim_time, key=p.new_key,
                              opt_state=opt_state), k

    def kasync_tail(carry: ExecCarry, p: ModePrelude):
        # the next K completions arrive; their stale gradients (at their
        # snapshots) are averaged and applied, and those K redispatch
        k, remaining, arrive_f = p.k, p.remaining, p.arrive_f
        arrive = arrive_f.to(torch.bool)
        g = corrupted_grad(lambda m, kk: stale_grad(carry.worker_params, m, kk), carry.worker_params, arrive_f, k,
                           p.sub, carry.sim_time)
        params, opt_state = apply_update(carry.params, g, carry.opt_state)
        params = hold_if_dead(params, carry.params, remaining)
        sim_time = carry.sim_time + p.t_iter
        kf = k.to(torch.float32)
        stats = ExecStats(arrivals=k.to(torch.int32),
                          mean_staleness=torch.dot(arrive_f, carry.staleness.to(torch.float32)) / kf,
                          max_staleness=torch.where(arrive, carry.staleness, 0).amax())
        ctrl_state, _ = ctrl_update(carry.ctrl_state, g, sim_time, stats)
        # arrivals redispatch from the new model (clock drawn next event);
        # everyone else computes on, one update staler
        worker_params = tree_map(lambda wp, pa: torch.where(_slot_bcast(arrive, wp), pa.unsqueeze(0), wp),
                                 carry.worker_params, params)
        staleness = torch.where(arrive, 0, carry.staleness + 1)
        # in-flight tasks run through the receive window too: their clocks
        # tick by the whole event; one ending inside it surfaces next event
        # (the clamp is a no-op without comm; +inf clocks stay +inf)
        rem_next = torch.clamp_min(remaining - p.t_iter, 0.0)
        return ExecCarry(params=params, worker_params=worker_params, remaining=rem_next, staleness=staleness,
                         pending=~arrive, ctrl_state=ctrl_state, sim_time=sim_time, key=p.new_key,
                         opt_state=opt_state), k

    def kbatch_tail(carry: ExecCarry, p: ModePrelude):
        # K single completions in a row: each completer adds its stale
        # gradient and redispatches at once from the pre-update params.  The
        # loop runs n_slots events and masks those past K, whose gradients
        # are taken and multiplied by 0: K is a tensor, so the trip count
        # cannot depend on it.  Only the prelude's key split and k are read.
        k = p.k
        kf = k.to(torch.float32)
        keys = prng.split(p.sub)
        key = keys[0]
        remaining = renewal_remaining(draw(keys[1], carry.sim_time), carry.pending, carry.remaining)
        gsum = tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32), carry.params)
        zero_i = torch.zeros((), dtype=torch.int32, device=k.device)
        rem, stal, wp, ssum, smax = remaining, carry.staleness, carry.worker_params, zero_i, zero_i
        tau_sum = torch.zeros((), dtype=torch.float32, device=k.device)
        for e in range(n_slots):
            active = k > e
            # the completer: the first index of the smallest clock (the
            # reference's argmin, as its host loop's heap breaks ties); the
            # count of the minima before each slot picks it with no tie rule
            tau_e = rem.amin()
            hit = rem == tau_e
            before = hit.cumsum(dim=-1)
            first = hit & (before == 1)
            i_star = (before == 0).sum()
            g_e = shard_grad_at(wp, i_star)
            w = torch.where(active, 1.0, 0.0)
            gsum = tree_map(lambda a, b: a + w * b, gsum, g_e)
            stal_e = torch.where(active, torch.where(first, stal, 0).sum(dtype=torch.int32), 0)
            ssum = ssum + stal_e
            smax = torch.maximum(smax, stal_e)
            keys = prng.split(key)
            key = keys[0]
            # a whole (n_slots,) draw of which the completer's entry is kept,
            # as the reference draws it
            redraw = draw(keys[1], carry.sim_time + tau_sum + tau_e)
            rem_next = torch.where(active, rem - tau_e, rem)
            rem = torch.where(first, torch.where(active, redraw, rem), rem_next)
            taken = active & first
            stal = torch.where(taken, 0, stal)
            wp = tree_map(lambda a, pa: torch.where(_slot_bcast(taken, a), pa.unsqueeze(0), a), wp, carry.params)
            tau_sum = tau_sum + torch.where(active, tau_e, 0.0)
        g = tree_map(lambda x: x / kf, gsum)
        params, opt_state = apply_update(carry.params, g, carry.opt_state)
        params = hold_if_dead(params, carry.params, rem)
        t_iter = tau_sum if comm_time is None else tau_sum + comm_time(k)
        sim_time = carry.sim_time + t_iter
        stats = ExecStats(arrivals=k.to(torch.int32), mean_staleness=ssum.to(torch.float32) / kf, max_staleness=smax)
        ctrl_state, _ = ctrl_update(carry.ctrl_state, g, sim_time, stats)
        return ExecCarry(
            params=params,
            worker_params=wp,
            # the clocks run through the receive window too (no-op without comm)
            remaining=rem if comm_time is None else torch.clamp_min(rem - comm_time(k), 0.0),
            # the update just applied ages every task in flight by one
            staleness=stal + 1,
            pending=torch.ones((n_slots,), dtype=torch.bool, device=k.device),
            ctrl_state=ctrl_state,
            sim_time=sim_time,
            key=p.new_key,
            opt_state=opt_state,
        ), k

    return prelude, (sync_tail, kasync_tail, kbatch_tail)


def make_mode_steps(
    *,
    n_slots: int,
    draw: Callable,
    sync_grad: Callable,
    stale_grad: Callable,
    shard_grad_at: Callable,
    comm_time: Optional[Callable],
    eta,
    ctrl_update: Callable,
    ctrl_k: Callable = lambda s: s.k,
    apply_update: Optional[Callable] = None,
    faults=None,
    robust_agg: Optional[Callable] = None,
):
    """The three modes' whole steps, ``step(carry) -> (carry, k)``, each its
    tail after the shared prelude (kbatch's without the ranking it does
    not read)."""
    prelude, tails = make_mode_prelude_and_tails(
        n_slots=n_slots, draw=draw, sync_grad=sync_grad, stale_grad=stale_grad, shard_grad_at=shard_grad_at,
        comm_time=comm_time, eta=eta, ctrl_update=ctrl_update, ctrl_k=ctrl_k, apply_update=apply_update,
        faults=faults, robust_agg=robust_agg,
    )
    ranked = {MODE_SYNC: True, MODE_KASYNC: True, MODE_KBATCH: False}
    return tuple((lambda carry, _tail=tail, _r=ranked[m]: _tail(carry, prelude(carry, _r)))
                 for m, tail in enumerate(tails))
