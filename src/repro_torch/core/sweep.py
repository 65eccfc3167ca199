"""Single-dispatch sweep engine, in torch: a G-cell x R-replica grid as one program.

The port of `repro.core.sweep`.  The paper's
artifacts (Figs. 2-3, the ablation) are grids — controller x straggler
model x (n, k-policy) — of many-seed error-against-wall-clock curves.
`run_monte_carlo` runs one cell per program; this module runs the whole
grid as ONE program by stacking every cell's configuration as tensor leaves
(`_CellParams`) and mapping one step over a flat lane axis of G·R lanes,
cell-major (lane g·R + r is cell g, replica r):

  * straggler parameters are per-worker packed rows
    (`straggler.pack_params_per_worker`), realized by every family's
    transform of one shared base draw and selected per slot
    (`straggler.sample_times_selected`); a `WorkerFleet` may carry a
    `RateSchedule` that drifts a column with the carried simulated time;
  * ``n`` is a grid axis: every cell is padded to the grid's ``n_workers``
    slots, and slots past the cell's ``n_active`` draw +inf, rank last and
    are held out of the gradient and the eval loss;
  * controller hyperparameters, the comm model's (alpha, beta) and eta are
    leaves, read by one unified controller update over the superset of
    every controller's state (`_CtrlState`).

The execution mode is a leaf too, and so are a cell's faults (its
`faults.FaultPlan` packed to per-slot rows) and its aggregator.  An
all-sync, fault-free, mean-only grid runs the lean step over `_SweepCarry`;
any other runs the renewal carry (`execmode.ExecCarry`): the shared prelude
once, then the tail of every mode the grid holds, and each lane's selected
with `torch.where` over the whole carry, as the reference's vmapped
`lax.switch` selects.  Every lane pays for every tail present (a kbatch
tail costs n_slots draws and shard gradients an iteration), and, in a
robust grid, for the row stack and every robust aggregator present.

What a program is built for is the grid's branch signature
(`GridSignature`): the sets of controller kinds, modes, fault families and
aggregators, and the schedule and comm flags present.  By default (``specialize=True``) a kind or mode
the signature excludes is never computed, and a lone kind's selects fold
away in Python; ``specialize=False`` builds the program of every kind.

On a CUDA device (the default) the grid runs through `montecarlo`'s
program: ``unroll`` iterations of all G·R lanes captured once as a CUDA
graph over static buffers (the carry, and the cell leaves, keys, params0
and data the graphs read) and replayed, the eval loss a graph of its own.
A grid with the same signature and shapes loads its leaves into those
buffers and replays the same graphs: repopulating never captures again,
the counterpart of the reference's "never retraces".  ``capture=False``
runs the same step eagerly.  A capture that fails raises; nothing falls
back.

Every cell of a sweep is the looped engine's run of that cell with the same
keys (`run_monte_carlo`), computed over G·R lanes instead of R: the per-lane
arithmetic is the looped step's, op for op.  Time and k agree bit for bit
(measured on the CPU and on an H100); the eval loss may differ in the last
ulps, because the reduction of vmap's lane-minor per-example losses rounds
differently for another lane count (PERF.md §6).

The grid is dispatched over a 2-D ``("cells", "replicas")`` mesh
(`launch.mesh`), taken from the ``mesh=`` argument, else
`shardctx.current_sweep_mesh()`, else `make_sweep_mesh(G, R)` over the
ranks of the default process group (with none initialised, a 1 x 1
stand-in: one device, no collective, the historical path).  Each axis pads
to its mesh-axis multiple (cells with inert all-zero rows, replicas by
repeating key 0), the padded grid flattens cell-major into one lane axis,
and each rank runs its own contiguous block of Gp·Rp/(mc·mr) lanes through
the one-device program above (captured as CUDA graphs on the card), then
all-gathers time, loss and k over the mesh, outside any capture, and
slices the padding off.  Lanes do no arithmetic across each other, so this
is exactly the reference's ``shard_map`` dispatch, and ``"auto"`` takes
the same path; ``partition="none"`` stays on one device.  The reference's
buffer donation has no counterpart: the program holds its inputs in
static buffers.

    cases = [SweepCase(PflugController(n_workers=50, k0=10, step=10, thresh=10),
                       Exponential(rate=1.0), eta=1e-2, label="adaptive"),
             SweepCase(FixedKController(n_workers=50, k=40), Exponential(rate=1.0),
                       eta=1e-2, label="fixed_k40")]
    result = run_sweep(loss_fn, w0, X, y, n_workers=50, cases=cases,
                       num_iters=40_000, keys=keys, eval_every=500)
    stats = summarize_cells(result)  # {label: summarize(cell)}
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import resolve_device, shardctx
from repro_torch.core import aggregation, execmode, faults, prng
from repro_torch.launch import mesh as mesh_lib
from repro_torch.core.controller import (
    FixedKController,
    PflugController,
    ScheduleController,
    SketchedPflugController,
    VarianceRatioController,
    _sign_event,
)
from repro_torch.core.execmode import MODE_KBATCH, MODE_SYNC, MODES, ExecCarry
from repro_torch.core.gradsource import GradSource, PerExampleSource
from repro_torch.core.montecarlo import (
    MonteCarloResult,
    _LRUProgramCache,
    _Program,
    _default_program_cache_size,
    _replicate,
    _to_device,
    summarize,
)
from repro_torch.core.straggler import (
    StragglerModel,
    WorkerFleet,
    apply_rate_schedule,
    family_select_masks,
    pack_params_per_worker,
    pack_schedule,
    sample_times_selected,
)
from repro_torch.core.tree import leaves_with_path, tree_dot, tree_leaves

__all__ = [
    "GridSignature",
    "SweepCase",
    "SweepResult",
    "grid_signature",
    "run_sweep",
    "run_sweep_source",
    "summarize_cells",
    "product_cases",
    "sweep_cache_stats",
    "clear_sweep_cache",
]

# Controller kinds, the reference's branch indices.
_FIXED, _PFLUG, _SCHEDULE, _VARIANCE_RATIO, _SKETCHED_PFLUG = range(5)

_CTRL_KINDS = {
    FixedKController: _FIXED,
    PflugController: _PFLUG,
    ScheduleController: _SCHEDULE,
    VarianceRatioController: _VARIANCE_RATIO,
    SketchedPflugController: _SKETCHED_PFLUG,
}
_N_CTRL_KINDS = len(_CTRL_KINDS)

_AGG_MEAN = aggregation.AGG_MEAN


class GridSignature(NamedTuple):
    """The static shape of the work a grid asks of a program.

    Sorted tuples of branch indices plus feature flags, as the reference's:

    * ``ctrl_kinds`` — controller kinds present,
    * ``modes`` — execution-mode indices present (``"sync"`` is 0),
    * ``with_schedule`` — any cell carries a live ``RateSchedule``,
    * ``with_comm`` — any cell carries a non-zero ``CommModel``,
    * ``fault_kinds`` — fault families any cell's plan can activate
      (`faults.FAULT_FAMILIES` indices),
    * ``agg_kinds`` — aggregator kinds present (``(0,)``, the mean, for an
      all-mean grid).

    The fault and aggregator axes are taken from the cells under
    ``specialize=False`` too, as the reference's: a fault-free, mean-only
    grid then runs no fault or robust code at all.

    Two grids with the same signature and shapes share one program.  The
    straggler family set is deliberately not part of it: every cell runs the
    full family sampler, so the sampler is the same in every program.
    """

    ctrl_kinds: tuple
    modes: tuple
    with_schedule: bool
    with_comm: bool
    fault_kinds: tuple
    agg_kinds: tuple


def _robustness_axes(cases: Sequence["SweepCase"]) -> tuple:
    """The (fault_kinds, agg_kinds) signature components of a grid."""
    fault_kinds, agg_kinds = set(), set()
    for c in cases:
        if isinstance(c.fault, faults.FaultPlan):  # other values error later, in _cell_of
            fault_kinds.update(faults.plan_kinds_present(c.fault))
        ak = aggregation.AGG_KINDS.get(c.agg)
        if ak is not None:  # unknown aggregators error later, in _cell_of
            agg_kinds.add(ak)
    return tuple(sorted(fault_kinds)), tuple(sorted(agg_kinds)) if agg_kinds else (_AGG_MEAN,)


def grid_signature(cases: Sequence["SweepCase"], n_slots: int) -> GridSignature:
    """The branch signature of a populated grid (see GridSignature)."""
    del n_slots  # families (which padding would affect) are not in the signature
    kinds, modes = set(), set()
    with_schedule = with_comm = False
    for c in cases:
        kind = _CTRL_KINDS.get(type(c.controller))
        if kind is not None:  # unknown controllers error later, in _cell_of
            kinds.add(kind)
        if c.mode in MODES:
            modes.add(MODES[c.mode])
        if isinstance(c.straggler, WorkerFleet):
            sched = c.straggler.schedule
            if sched is not None and len(sched.times):
                with_schedule = True
        if c.comm is not None and (c.comm.alpha != 0.0 or c.comm.beta != 0.0):
            with_comm = True
    fault_kinds, agg_kinds = _robustness_axes(cases)
    return GridSignature(ctrl_kinds=tuple(sorted(kinds)), modes=tuple(sorted(modes)), with_schedule=with_schedule,
                         with_comm=with_comm, fault_kinds=fault_kinds, agg_kinds=agg_kinds)


def _full_signature(cases: Sequence["SweepCase"]) -> GridSignature:
    """``specialize=False``: every controller kind and feature flag, so any
    same-shape grid repopulates the program; the all-sync split and the
    fault and aggregator axes still come from the cases, as the reference's."""
    all_sync = all(c.mode == "sync" for c in cases)
    fault_kinds, agg_kinds = _robustness_axes(cases)
    return GridSignature(ctrl_kinds=tuple(range(_N_CTRL_KINDS)),
                         modes=(MODE_SYNC,) if all_sync else tuple(sorted(MODES.values())),
                         with_schedule=True, with_comm=True, fault_kinds=fault_kinds, agg_kinds=agg_kinds)


def _static_remap(present: tuple, total: int) -> np.ndarray:
    """int32 table from global branch indices to pruned-local ones (a lane's
    mode leaf through it picks its tail among the signature's)."""
    remap = np.zeros((total,), np.int32)
    for j, g in enumerate(present):
        remap[g] = j
    return remap


def _auto_unroll(sig: GridSignature) -> int:
    """``unroll=None``: the reference's scan unroll for the signature (4 with
    async modes, faults or robust aggregation; 8 for one controller kind,
    else 6), but 1 with kbatch.  Here it is the iterations one CUDA graph
    holds, which never changes the arithmetic, and a grid iteration with a
    kbatch tail launches ~10^4 kernels: one iteration a graph captures in a
    fraction of the time and replays as fast (`montecarlo.default_unroll`)."""
    if MODE_KBATCH in sig.modes:
        return 1
    if sig.modes != (MODE_SYNC,):
        return 4
    if sig.fault_kinds or sig.agg_kinds != (_AGG_MEAN,):
        return 4
    return 8 if len(sig.ctrl_kinds) == 1 else 6


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One grid cell: a controller/straggler/step-size/comm configuration.

    ``straggler`` may be a ``WorkerFleet``.  The cell's active worker count
    is ``controller.n_workers``; slots past it, up to the grid's
    ``n_workers``, are inactive.  ``mode`` is the execution mode,
    ``fault`` the cell's `faults.FaultPlan` (None: a healthy fleet), ``agg``
    its aggregator (`aggregation.AGG_KINDS`; a robust one is refused in
    kbatch mode) and ``agg_param`` the trimmed mean's trim fraction.
    """

    controller: Any
    straggler: StragglerModel | WorkerFleet
    eta: float
    comm: aggregation.CommModel | None = None
    label: str = ""
    mode: str = "sync"
    fault: Any = None
    agg: str = "mean"
    agg_param: float = 0.1

    def name(self) -> str:
        if self.label:
            return self.label
        return f"{type(self.controller).__name__}/{type(self.straggler).__name__}"


def product_cases(controllers: dict, stragglers: dict, eta: float,
                  comm: aggregation.CommModel | None = None) -> list:
    """The full controller x straggler grid, labeled ``"<ctrl>|<strag>"``."""
    return [
        SweepCase(ctrl, strag, eta=eta, comm=comm, label=f"{cname}|{sname}")
        for sname, strag in stragglers.items()
        for cname, ctrl in controllers.items()
    ]


class _CellParams(NamedTuple):
    """One grid cell as leaves ((G, ...) or (G·R, ...) when stacked)."""

    ctrl_kind: Any  # int32: controller kind
    mode: Any  # int32: execution-mode index
    k0: Any  # int32
    step: Any  # int32
    thresh: Any  # int32
    burnin: Any  # int32
    k_max: Any  # int32: k cap (n_active when the controller left it None)
    decay: Any  # f32: variance-ratio EMA decay d
    one_minus_decay: Any  # f32: f32(1 - d), rounded as the controller rounds it
    ratio_thresh: Any  # f32
    switch_times: Any  # f32 (S,): schedule times, +inf padded
    n_active: Any  # int32: active worker slots
    strag_kinds: Any  # int32 (n_slots,): per-slot family indices
    strag_p: Any  # f32 (n_slots, 3): per-worker parameters
    sched_mode: Any  # int32: straggler.SCHEDULE_MODES
    sched_leaf: Any  # int32: the parameter column that drifts
    sched_times: Any  # f32 (K,): rate-schedule knots, +inf padded
    sched_scales: Any  # f32 (K,): knot multipliers, last-value padded
    sketch_signs: Any  # tuple of params-shaped f32 leaves (JAX leaf order): the sketch's signs
    comm_alpha: Any  # f32
    comm_beta: Any  # f32
    eta: Any  # f32
    fault_kinds: Any  # int32 (n_slots,): faults.FAULT_FAMILIES per slot
    fault_onset: Any  # f32 (n_slots,): per-slot fault onset (simulated time)
    fault_param: Any  # f32 (n_slots,): rescale factor or gauss scale
    agg_kind: Any  # int32: aggregation.AGG_KINDS select index
    agg_param: Any  # f32: the trimmed mean's trim fraction


class _CtrlState(NamedTuple):
    """Superset of every controller's state (a policy-agnostic carry)."""

    k: torch.Tensor
    count_negative: torch.Tensor
    count_iter: torch.Tensor
    prev_grad: Any  # params-shaped: Pflug's g_{j-1}
    prev_sketch: torch.Tensor  # (sketch_dim,): sketched Pflug's z_{j-1}
    ema_mean: Any  # params-shaped: variance ratio's EMA(g)
    ema_sq: torch.Tensor
    have_prev: torch.Tensor
    n_switches: torch.Tensor


class SweepResult(NamedTuple):
    """The grid's eval-point trajectories: ``time``/``loss``/``k`` are (G, R,
    E) tensors on the run's device; ``iteration`` (E,) numpy."""

    time: torch.Tensor
    loss: torch.Tensor
    k: torch.Tensor
    iteration: np.ndarray
    labels: tuple

    def cell(self, g: int) -> MonteCarloResult:
        """Cell g's trajectories as a MonteCarloResult (R, E)."""
        return MonteCarloResult(time=self.time[g], loss=self.loss[g], k=self.k[g], iteration=self.iteration)


def summarize_cells(result: SweepResult) -> dict:
    """``{label: summarize(cell)}`` for every grid cell."""
    return {label: summarize(result.cell(g)) for g, label in enumerate(result.labels)}


def _sketch_signs_of(params_like, seed: int) -> tuple:
    """The Rademacher signs `SketchedPflugController._sketch` draws, made
    once on the host: per leaf, in JAX's leaf order, the key of seed +
    crc32(keystr(path)) mod 2^30, as f32 numpy."""
    out = []
    for path, g in leaves_with_path(params_like):
        leaf_seed = seed + (zlib.crc32(path.encode("utf-8")) % (2**30))
        key = torch.tensor([0, leaf_seed & prng.MASK], dtype=torch.int64)
        out.append(prng.rademacher(key, tuple(g.shape)).numpy())
    return tuple(out)


def _zero_signs_of(params_like) -> tuple:
    return tuple(np.zeros(tuple(g.shape), np.float32) for g in tree_leaves(params_like))


def _cell_of(case: SweepCase, n_slots: int, n_switch_slots: int, n_sched_slots: int, sketch_dim: int,
             params_like) -> _CellParams:
    """A cell's leaves as numpy, after the reference's checks."""
    c = case.controller
    kind = _CTRL_KINDS.get(type(c))
    if kind is None:
        raise ValueError(f"{type(c).__name__} is not sweepable; supported: {[t.__name__ for t in _CTRL_KINDS]}")
    i32, f32 = np.int32, np.float32
    n_active = int(c.n_workers)
    if n_active > n_slots:
        raise ValueError(f"cell {case.name()!r}: controller n_workers={n_active} exceeds the grid's "
                         f"n_slots={n_slots}")
    if isinstance(case.straggler, WorkerFleet) and case.straggler.n_active != n_active:
        raise ValueError(f"cell {case.name()!r}: fleet has {case.straggler.n_active} models but "
                         f"controller.n_workers={n_active}")
    if case.mode not in MODES:
        raise ValueError(f"cell {case.name()!r}: unknown mode {case.mode!r}; options {sorted(MODES)}")
    if case.agg not in aggregation.AGG_KINDS:
        raise ValueError(f"cell {case.name()!r}: unknown aggregator {case.agg!r}; options "
                         f"{sorted(aggregation.AGG_KINDS)}")
    if case.agg != "mean" and case.mode == "kbatch":
        raise ValueError(f"cell {case.name()!r}: robust aggregation ({case.agg!r}) is not supported in kbatch "
                         "mode — kbatch arrivals are sequential, there is no per-worker row stack to aggregate")
    if case.fault is not None and not isinstance(case.fault, faults.FaultPlan):
        raise ValueError(f"cell {case.name()!r}: fault must be a faults.FaultPlan or None, got {case.fault!r}")
    try:
        fkinds, fonset, fparam = faults.pack_faults(case.fault, n_slots, n_active)
    except ValueError as e:
        raise ValueError(f"cell {case.name()!r}: {e}") from None
    k0, step, thresh, burnin = 1, 0, 0, 0
    k_max = n_active
    decay = ratio_thresh = 0.0
    times = np.full((n_switch_slots,), np.inf, f32)
    signs = _zero_signs_of(params_like)
    if kind == _FIXED:
        k0 = c.k
    elif kind in (_PFLUG, _SKETCHED_PFLUG):
        k0, step, thresh, burnin = c.k0, c.step, c.thresh, c.burnin
        k_max = c.k_max if c.k_max is not None else n_active
        if kind == _SKETCHED_PFLUG:
            if c.sketch_dim != sketch_dim:
                raise ValueError(f"cell {case.name()!r}: sketch_dim={c.sketch_dim} but the grid's static sketch "
                                 f"layout is {sketch_dim} (every sketched cell in one sweep must share sketch_dim)")
            signs = _sketch_signs_of(params_like, c.seed)
    elif kind == _SCHEDULE:
        k0, step = c.k0, c.step
        st = np.asarray(list(c.switch_times), f32)
        if st.size > n_switch_slots:
            raise ValueError(f"{st.size} switch times > {n_switch_slots} slots")
        times[: st.size] = st
    elif kind == _VARIANCE_RATIO:
        k0, step, burnin = c.k0, c.step, c.burnin
        k_max = c.k_max if c.k_max is not None else n_active
        decay, ratio_thresh = c.decay, c.ratio_thresh
    pmat, kinds, _ = pack_params_per_worker(case.straggler, n_slots, n_active=n_active)
    sched = case.straggler.schedule if isinstance(case.straggler, WorkerFleet) else None
    sched_mode, sched_leaf, sched_times, sched_scales = pack_schedule(sched, n_sched_slots)
    comm = case.comm or aggregation.CommModel()
    return _CellParams(
        ctrl_kind=i32(kind), mode=i32(MODES[case.mode]), k0=i32(k0), step=i32(step), thresh=i32(thresh),
        burnin=i32(burnin), k_max=i32(k_max), decay=f32(decay),
        # the controller computes (1 - d) in Python float64 and rounds it to
        # f32 where it multiplies; rounding here the same way keeps the bits
        one_minus_decay=f32(1.0 - decay), ratio_thresh=f32(ratio_thresh), switch_times=times,
        n_active=i32(n_active), strag_kinds=kinds, strag_p=pmat, sched_mode=sched_mode, sched_leaf=sched_leaf,
        sched_times=sched_times, sched_scales=sched_scales, sketch_signs=signs, comm_alpha=f32(comm.alpha),
        comm_beta=f32(comm.beta), eta=f32(case.eta), fault_kinds=fkinds, fault_onset=fonset, fault_param=fparam,
        agg_kind=i32(aggregation.AGG_KINDS[case.agg]), agg_param=f32(case.agg_param),
    )


def _stack_cells(cells: Sequence[_CellParams], dev: torch.device) -> _CellParams:
    """The cells' leaves stacked to (G, ...) tensors on ``dev``."""
    def stack(*xs):
        return torch.from_numpy(np.stack([np.asarray(x) for x in xs])).to(dev)

    fields = {}
    for name in _CellParams._fields:
        vals = [getattr(c, name) for c in cells]
        fields[name] = tuple(map(stack, *vals)) if name == "sketch_signs" else stack(*vals)
    return _CellParams(**fields)


# ------------------------------------------------- unified controller update


def _ctrl_init(cells: _CellParams, params0, sketch_dim: int) -> _CtrlState:
    """The controller state of every lane before its first iteration (cells
    (L, ...)): k0; Pflug counts iterations from 1, variance ratio from 0."""
    lanes, dev = cells.k0.shape[0], cells.k0.device

    def zeros_f32(x):
        return torch.zeros((lanes,) + tuple(x.shape), dtype=torch.float32, device=dev)

    def scalars(dtype):
        return torch.zeros((lanes,), dtype=dtype, device=dev)

    return _CtrlState(
        k=cells.k0.clone(),
        count_negative=scalars(torch.int32),
        count_iter=torch.where(cells.ctrl_kind == _VARIANCE_RATIO, 0, 1).to(torch.int32),
        prev_grad=tree_map(zeros_f32, params0),
        prev_sketch=torch.zeros((lanes, sketch_dim), dtype=torch.float32, device=dev),
        ema_mean=tree_map(zeros_f32, params0),
        ema_sq=scalars(torch.float32),
        have_prev=scalars(torch.bool),
        n_switches=scalars(torch.int32),
    )


def _sel(pred, a, b):
    """``torch.where`` that folds away when the predicate is a Python bool."""
    if pred is True:
        return a
    if pred is False:
        return b
    return torch.where(pred, a, b)


def _sel_tree(pred, a, b):
    if pred is True:
        return a
    if pred is False:
        return b
    return tree_map(lambda x, y: x if x is None else torch.where(pred, x, y), a, b)


def _pred_or(a, b):
    if a is True or b is True:
        return True
    if a is False:
        return b
    if b is False:
        return a
    return a | b


class _CtrlPreds(NamedTuple):
    """Per-lane controller-kind predicates: a bool tensor, or a Python bool
    where the signature decides (an absent kind False, a lone kind True),
    which lets the update fold the select away."""

    is_pflug: Any
    is_schedule: Any
    is_vr: Any
    is_sketched: Any


def _ctrl_preds(kind_is: Sequence[torch.Tensor], ctrl_kinds: Optional[tuple]) -> _CtrlPreds:
    """``kind_is[j]``: the lanes' ``ctrl_kind == j``, made before the step."""
    kinds = tuple(ctrl_kinds) if ctrl_kinds is not None else tuple(range(_N_CTRL_KINDS))

    def pred(kind):
        if kind not in kinds:
            return False
        if kinds == (kind,):
            return True
        return kind_is[kind]

    return _CtrlPreds(is_pflug=pred(_PFLUG), is_schedule=pred(_SCHEDULE), is_vr=pred(_VARIANCE_RATIO),
                      is_sketched=pred(_SKETCHED_PFLUG))


def _apply_sketch(signs, grads, sketch_dim: int) -> torch.Tensor:
    """Count sketch of the gradient from the cell's signs: the arithmetic of
    `SketchedPflugController._sketch` (same leaf order, pad, bucket sums and
    order of accumulation) with its drawn signs replaced by the leaves."""
    m = sketch_dim
    z = None
    for sl, g in zip(signs, tree_leaves(grads)):
        t = (sl * g.to(torch.float32)).reshape(-1)
        pad = (-t.numel()) % m
        if pad:
            t = torch.cat([t, t.new_zeros(pad)])
        part = t.reshape(-1, m).sum(dim=0)
        z = part if z is None else z + part
    return z


def _ctrl_update(cp: _CellParams, state: _CtrlState, grads, sim_time, sketch_dim: int,
                 ctrl_kinds: Optional[tuple], preds: _CtrlPreds):
    """The unified controller update for one lane, specialized to the kinds
    present: each present kind's signal is computed once (the Pflug sign
    test on the gradient or its sketch, the variance-ratio EMAs, the
    schedule's time trigger), the shared switch bookkeeping once, and the
    kinds' leaves merged with two-way selects.  Per lane the arithmetic is
    the controller class's update, op for op; absent kinds are never
    computed, and with one kind present every select folds away."""
    kinds = tuple(ctrl_kinds) if ctrl_kinds is not None else tuple(range(_N_CTRL_KINDS))
    has_pflug, has_sketched = _PFLUG in kinds, _SKETCHED_PFLUG in kinds
    has_schedule, has_vr = _SCHEDULE in kinds, _VARIANCE_RATIO in kinds
    counting = _pred_or(preds.is_pflug, preds.is_sketched)
    adapting = _pred_or(counting, preds.is_vr)
    i32 = torch.int32
    k = state.k

    # counting signal: the sign of consecutive gradients' inner product
    # (Algorithm 1), on the gradient (Pflug) or on its count sketch
    dot = z = None
    if has_pflug:
        dot = tree_dot(grads, state.prev_grad)
    if has_sketched:
        z = _apply_sketch(cp.sketch_signs, grads, sketch_dim)
        dot_s = torch.dot(z, state.prev_sketch)
        dot = dot_s if dot is None else _sel(preds.is_sketched, dot_s, dot)
    if counting is not False:
        count_neg1 = state.count_negative + _sign_event(dot, state.have_prev)

    # variance-ratio signal: ||EMA(g)||^2 / EMA(||g||^2)
    if has_vr:
        d, omd = cp.decay, cp.one_minus_decay
        ema1 = tree_map(lambda m, g: d * m + omd * g.to(torch.float32), state.ema_mean, grads)
        ema_sq1 = d * state.ema_sq + omd * tree_dot(grads, grads)
        ratio = tree_dot(ema1, ema1) / torch.clamp_min(ema_sq1, 1e-30)

    # the shared adaptive bookkeeping: one switch test, one k bump
    new_k = k
    do_switch = False
    if adapting is not False:
        if has_vr and counting is not False:
            cond = _sel(preds.is_vr, ratio < cp.ratio_thresh, count_neg1 > cp.thresh)
        elif has_vr:
            cond = ratio < cp.ratio_thresh
        else:
            cond = count_neg1 > cp.thresh
        gate = (state.count_iter > cp.burnin) & (k + cp.step <= cp.k_max)
        do_switch = cond & gate if adapting is True else adapting & cond & gate
        new_k = torch.where(do_switch, k + cp.step, k)
        count_iter1 = torch.where(do_switch, 0, state.count_iter) + 1

    # the schedule's time-triggered k, capped at the cell's active workers
    if has_schedule:
        n_passed = (sim_time >= cp.switch_times).sum().to(i32)
        k_sched = torch.minimum(cp.k0 + cp.step * n_passed, cp.n_active)
        new_k = _sel(preds.is_schedule, k_sched, new_k)

    new_state = _CtrlState(
        k=new_k,
        count_negative=(state.count_negative if counting is False
                        else _sel(counting, torch.where(do_switch, 0, count_neg1), state.count_negative)),
        count_iter=state.count_iter if adapting is False else _sel(adapting, count_iter1, state.count_iter),
        prev_grad=(state.prev_grad if not has_pflug
                   else _sel_tree(preds.is_pflug, tree_map(lambda g: g.to(torch.float32), grads), state.prev_grad)),
        prev_sketch=state.prev_sketch if not has_sketched else _sel(preds.is_sketched, z, state.prev_sketch),
        ema_mean=(state.ema_mean if not has_vr
                  else _sel_tree(preds.is_vr, tree_map(lambda m: torch.where(do_switch, torch.zeros_like(m), m), ema1),
                                 state.ema_mean)),
        ema_sq=state.ema_sq if not has_vr else _sel(preds.is_vr, torch.where(do_switch, 0.0, ema_sq1), state.ema_sq),
        have_prev=(state.have_prev if adapting is False
                   else _sel(adapting, torch.ones_like(state.have_prev), state.have_prev)),
        # do_switch already carries the adapting mask: other lanes add 0
        n_switches=state.n_switches if adapting is False else state.n_switches + do_switch.to(i32),
    )
    return new_state, new_k


# ---------------------------------------------------------------- the engine


class _SweepCarry(NamedTuple):
    params: Any
    ctrl_state: _CtrlState
    sim_time: torch.Tensor
    key: torch.Tensor


class _Lanes(NamedTuple):
    """The step's per-lane inputs, (L, ...) each: the cell leaves, and their
    family masks and kind and mode predicates, made once before the step."""

    cells: _CellParams
    fam_masks: tuple  # straggler.family_select_masks of the cell's slot kinds
    kind_is: tuple  # kind_is[j]: ctrl_kind == j
    mode_is: tuple  # mode_is[j]: the lane runs the signature's j-th mode (empty for one mode)


class _Inputs(NamedTuple):
    """What one grid run reads: the static buffers of a captured program."""

    params0: Any
    data: Any
    keys: torch.Tensor  # (L, 2), cell-major
    lanes: _Lanes


def _lanes_of(cells: _CellParams, modes: tuple = (MODE_SYNC,)) -> _Lanes:
    """``modes``: the signature's mode indices, which the lanes' mode leaves
    map to local ones through `_static_remap`."""
    mode_is = ()
    if len(modes) > 1:
        remap = torch.from_numpy(_static_remap(modes, len(MODES))).to(cells.mode.device)
        local = remap[cells.mode]
        mode_is = tuple(local == j for j in range(len(modes)))
    return _Lanes(cells=cells, fam_masks=family_select_masks(cells.strag_kinds),
                  kind_is=tuple(cells.ctrl_kind == j for j in range(_N_CTRL_KINDS)), mode_is=mode_is)


@dataclasses.dataclass(frozen=True)
class _GridEngine:
    """The grid's program body for `montecarlo._Program`: ``build(inputs) ->
    (step, evaluate)`` over every lane, ``initial(inputs) -> carry``.  An
    all-sync, fault-free, mean-only signature builds the lean step over
    `_SweepCarry`; any other builds the moded step over `execmode.ExecCarry`."""

    source: GradSource
    n_workers: int
    sketch_dim: int
    sig: GridSignature

    @property
    def moded(self) -> bool:
        sig = self.sig
        return sig.modes != (MODE_SYNC,) or bool(sig.fault_kinds) or sig.agg_kinds != (_AGG_MEAN,)

    def initial(self, inputs: _Inputs):
        keys, cells = inputs.keys, inputs.lanes.cells
        sim_time = torch.zeros((), dtype=torch.float32, device=keys.device)
        if self.moded:
            one = execmode.init_exec_carry(inputs.params0, self.n_workers, None, keys[0])
        else:
            one = _SweepCarry(params=inputs.params0, ctrl_state=None, sim_time=sim_time, key=keys[0])
        return _replicate(one, keys)._replace(ctrl_state=_ctrl_init(cells, inputs.params0, self.sketch_dim))

    def build(self, inputs: _Inputs):
        sig, sketch_dim = self.sig, self.sketch_dim
        fns = self.source.build(inputs.data, self.n_workers)
        veval = torch.func.vmap(fns.eval_loss_active)

        def evaluate(params):
            return veval(params, inputs.lanes.cells.n_active)

        if self.moded:
            vstep = self._moded_step(inputs, fns)
        else:

            def one_step(carry: _SweepCarry, lane: _Lanes):
                cp = lane.cells
                preds = _ctrl_preds(lane.kind_is, sig.ctrl_kinds)
                keys = prng.split(carry.key)
                k = carry.ctrl_state.k  # decided before the step
                times = sample_times_selected(lane.fam_masks, _lane_pmat(cp, carry.sim_time, sig), keys[1])
                mask, t_iter = aggregation.fastest_k_mask_time(times, k)
                if sig.with_comm:
                    t_iter = t_iter + _lane_comm_time(cp, k)
                g = fns.grad(carry.params, mask, k)
                params = tree_map(lambda p, gi: p - cp.eta * gi, carry.params, g)
                sim_time = carry.sim_time + t_iter
                ctrl_state, _ = _ctrl_update(cp, carry.ctrl_state, g, sim_time, sketch_dim, sig.ctrl_kinds, preds)
                return _SweepCarry(params, ctrl_state, sim_time, keys[0]), k

            vstep = torch.func.vmap(one_step)

        def step(carry):
            return vstep(carry, inputs.lanes)

        return step, evaluate

    def _moded_step(self, inputs: _Inputs, fns):
        """The reference's `_make_run_one_moded` step: the shared prelude once,
        then every tail the signature holds (kbatch's inner loop only when
        kbatch is in it), and the lane's tail selected with `torch.where`
        over the whole carry, as vmap's `lax.switch` selects.  The tails
        carry the lane's faults and aggregator, closures over its leaves
        built for the signature's families and kinds only.  Each tail is
        the looped engine's step of that mode, op for op."""
        sig, sketch_dim, n = self.sig, self.sketch_dim, self.n_workers
        stale_grad, shard_grad_at = self.source.build_stale(inputs.data, n)
        modes = sig.modes

        def one_step(carry: ExecCarry, lane: _Lanes):
            cp = lane.cells
            preds = _ctrl_preds(lane.kind_is, sig.ctrl_kinds)

            def ctrl_update(state, g, sim_time, stats):
                del stats  # no controller kind reads it yet
                return _ctrl_update(cp, state, g, sim_time, sketch_dim, sig.ctrl_kinds, preds)

            fault_fns = faults.make_fault_fns(cp.fault_kinds, cp.fault_onset, cp.fault_param, sig.fault_kinds,
                                              inputs.params0, n)
            robust = aggregation.make_robust_select(cp.agg_kind, cp.agg_param, sig.agg_kinds)
            prelude, tails = execmode.make_mode_prelude_and_tails(
                n_slots=n, draw=lambda sub, t: sample_times_selected(lane.fam_masks, _lane_pmat(cp, t, sig), sub),
                sync_grad=fns.grad, stale_grad=stale_grad, shard_grad_at=shard_grad_at,
                comm_time=(lambda k: _lane_comm_time(cp, k)) if sig.with_comm else None, eta=cp.eta,
                ctrl_update=ctrl_update, faults=fault_fns, robust_agg=robust,
            )
            p = prelude(carry, modes != (MODE_KBATCH,))
            outs = [tails[m](carry, p)[0] for m in modes]
            new = outs[-1]
            for j in range(len(modes) - 2, -1, -1):
                new = _sel_tree(lane.mode_is[j], outs[j], new)
            return new, p.k

        dims = execmode.CARRY_DIMS
        return torch.func.vmap(one_step, in_dims=(dims, 0), out_dims=(dims, 0))


def _lane_pmat(cp: _CellParams, sim_time, sig: GridSignature):
    """The lane's per-worker straggler rows; the rate-schedule drift is built
    only when some cell of the signature has one (exact for those without)."""
    if not sig.with_schedule:
        return cp.strag_p
    return apply_rate_schedule(cp.strag_p, cp.sched_mode, cp.sched_leaf, cp.sched_times, cp.sched_scales, sim_time)


def _lane_comm_time(cp: _CellParams, k):
    return cp.comm_alpha + cp.comm_beta * k.to(torch.float32)


# (source token, n_workers, num_iters, eval_every, unroll, n_switch_slots,
#  n_sched_slots, sketch_dim, partition, (mc, mr, n_proc), GridSignature,
#  device, capture, threefry mode) -> program: the reference's key, plus
# what decides a torch program.  Under each entry the program captures once
# per shape signature of its inputs (grid size, params and data shapes), as
# jit retraces on new shapes; a grid of a known signature loads into the
# captured buffers.
_PROGRAM_CACHE = _LRUProgramCache(maxsize=_default_program_cache_size())
_N_TRACES = 0


def sweep_cache_stats() -> dict:
    return {"programs": len(_PROGRAM_CACHE), "traces": _N_TRACES}


def clear_sweep_cache() -> None:
    global _N_TRACES
    _PROGRAM_CACHE.clear()
    _N_TRACES = 0


def _count_build() -> None:
    global _N_TRACES
    _N_TRACES += 1


def run_sweep_source(
    source: GradSource,
    params0,
    data,
    n_workers: int,
    cases: Sequence[SweepCase],
    num_iters: int,
    keys=None,
    key=None,
    n_replicas: Optional[int] = None,
    eval_every: int = 10,
    unroll: Optional[int] = None,
    n_switch_slots: Optional[int] = None,
    n_sched_slots: Optional[int] = None,
    partition: str = "auto",
    specialize: bool = True,
    mesh=None,
    device="cuda",
    capture: bool = True,
) -> SweepResult:
    """Run a G-cell x R-replica grid of fastest-k SGD as one program on ``device``.

    ``n_workers`` is the grid's slot count; a cell's active workers are its
    ``controller.n_workers``.  ``keys`` are R keys ((R, 2), numpy uint32 from
    JAX or `prng` keys), or pass ``key`` and ``n_replicas`` to split one;
    replica r of every cell uses key r.  ``specialize``, ``unroll`` (None:
    `_auto_unroll`), ``n_switch_slots`` and ``n_sched_slots`` are the
    reference's.  ``partition`` takes the reference's values ("auto",
    "shard_map", "none"): the first two dispatch over the ``("cells",
    "replicas")`` mesh (``mesh``, else `shardctx.current_sweep_mesh`, else
    `launch.mesh.make_sweep_mesh`; see the module docstring), "none" runs on
    one device.  ``capture`` (CUDA only) replays CUDA graphs; False
    runs the same step eagerly.  The threefry mode in force applies to the
    whole run.  Cell g, replica r is the looped engine's replica r of
    ``cases[g]`` with the same key.
    """
    if not cases:
        raise ValueError("cases must be non-empty")
    labels = [c.name() for c in cases]
    if len(set(labels)) != len(labels):
        dupes = sorted({lb for lb in labels if labels.count(lb) > 1})
        raise ValueError(f"duplicate cell labels {dupes}: give identically-typed cases distinct SweepCase.label "
                         "values (summarize_cells keys on them)")
    dev = resolve_device(device)
    if keys is None:
        if key is None or n_replicas is None:
            raise ValueError("pass either keys=(R keys) or key= and n_replicas=")
        keys = prng.split(prng.as_key(key, dev), n_replicas)
    keys = prng.as_key(keys, dev)
    params0, data = _to_device(params0, dev), _to_device(data, dev)
    source.check(data, n_workers)
    if eval_every <= 0:
        raise ValueError(f"eval_every must be positive, got {eval_every}")
    if num_iters <= 0:
        raise ValueError(f"num_iters must be positive, got {num_iters}")
    if partition not in ("auto", "shard_map", "none"):
        raise ValueError(f"unknown partition {partition!r}")
    if n_switch_slots is None:
        n_switch_slots = max([1] + [len(list(c.controller.switch_times)) for c in cases
                                    if isinstance(c.controller, ScheduleController)])
    if n_sched_slots is None:
        n_sched_slots = max([1] + [len(c.straggler.schedule.times) for c in cases
                                   if isinstance(c.straggler, WorkerFleet) and c.straggler.schedule])
    # every sketched cell shares one sketch_dim: it is the carry's shape
    sketch_dims = {c.controller.sketch_dim for c in cases if isinstance(c.controller, SketchedPflugController)}
    if len(sketch_dims) > 1:
        raise ValueError(f"sketched cells disagree on sketch_dim ({sorted(sketch_dims)}); one sweep supports a "
                         "single static sketch layout")
    sketch_dim = sketch_dims.pop() if sketch_dims else 1
    cells_np = [_cell_of(c, n_workers, n_switch_slots, n_sched_slots, sketch_dim, params0) for c in cases]
    sig = grid_signature(cases, n_workers) if specialize else _full_signature(cases)
    if unroll is None:
        unroll = _auto_unroll(sig)

    g, r = len(cases), keys.shape[0]
    if partition == "none":
        mesh = mesh_lib.HostMesh(("cells", "replicas"))
    else:
        if mesh is None:
            mesh = shardctx.current_sweep_mesh()
        if mesh is None:
            mesh = mesh_lib.make_sweep_mesh(g, r)
        if mesh_lib.axis_names(mesh) != ("cells", "replicas"):
            raise ValueError(f"sweep mesh must have axes ('cells', 'replicas'), got {mesh_lib.axis_names(mesh)}")
    mc, mr = mesh_lib.axis_sizes(mesh).values()
    n_proc = len(mesh_lib.mesh_ranks(mesh))

    # Pad each grid axis to its mesh-axis multiple: cells with inert
    # all-zero rows (zero-rate samplers draw +inf, n_active = 0 holds all
    # data out, and whatever they compute stays in their own lanes), never
    # copies of a real cell; replicas by repeating key 0.  The padded grid
    # flattens cell-major, so each mesh position's lane block is contiguous.
    gp, rp = g + (-g) % mc, r + (-r) % mr
    cells = _stack_cells(cells_np, dev)
    if gp > g:
        cells = tree_map(lambda a: torch.cat([a, a.new_zeros((gp - g,) + tuple(a.shape[1:]))]), cells)
    if rp > r:
        keys = keys[torch.cat([torch.arange(r, device=dev), torch.zeros(rp - r, dtype=torch.int64, device=dev)])]
    n_lanes = gp * rp // (mc * mr)
    first = mesh_lib.flat_index(mesh) * n_lanes
    lane = torch.arange(first, first + n_lanes, device=dev)
    cell_idx, rep_idx = lane // rp, lane % rp
    flat_cells = tree_map(lambda a: a[cell_idx], cells)
    inputs = _Inputs(params0=params0, data=data, keys=keys[rep_idx], lanes=_lanes_of(flat_cells, sig.modes))

    capture = bool(capture) and dev.type == "cuda"
    partitionable = prng.is_partitionable()
    cache_key = (source.cache_token(), n_workers, int(num_iters), int(eval_every), int(unroll), int(n_switch_slots),
                 int(n_sched_slots), int(sketch_dim), partition, (mc, mr, n_proc), sig, str(dev), capture,
                 partitionable)
    program = _PROGRAM_CACHE.get(cache_key)
    if program is None:
        program = _Program(_GridEngine(source, n_workers, sketch_dim, sig), int(num_iters), int(eval_every),
                           int(unroll), capture, partitionable, _count_build)
        _PROGRAM_CACHE[cache_key] = program
    out = program(inputs)
    if n_proc > 1:
        out = _gather_lanes(out, mesh)
    times, losses, ks = (a.reshape(gp, rp, -1)[:g, :r] for a in out)
    iteration = np.minimum(np.arange(1, times.shape[-1] + 1) * eval_every, num_iters).astype(np.int64)
    return SweepResult(time=times, loss=losses, k=ks, iteration=iteration, labels=tuple(labels))


def _gather_lanes(blocks, mesh):
    """Every rank's (n_lanes, ...) result blocks, all-gathered over the
    mesh's ranks and joined in the mesh's row-major order (the lane order).
    NCCL gathers the device tensors; gloo gathers CPU copies, the only
    tensors it takes for every collective.  Runs after the program,
    outside any graph capture."""
    import torch.distributed as dist

    ranks = mesh_lib.mesh_ranks(mesh)
    group = None if sorted(ranks) == list(range(dist.get_world_size())) else mesh._flatten().get_group()
    on_device = dist.get_backend(group) == "nccl"
    order = [r if group is None else dist.get_group_rank(group, r) for r in ranks]
    out = []
    for x in blocks:
        x = x.contiguous() if on_device else x.cpu().contiguous()
        parts = [torch.empty_like(x) for _ in range(len(ranks))]
        dist.all_gather(parts, x, group=group)
        out.append(torch.cat([parts[i] for i in order]).to(blocks[0].device))
    return out


def run_sweep(
    per_example_loss_fn: Callable,
    params0,
    X,
    y,
    n_workers: int,
    cases: Sequence[SweepCase],
    num_iters: int,
    keys=None,
    key=None,
    n_replicas: Optional[int] = None,
    eval_every: int = 10,
    unroll: Optional[int] = None,
    n_switch_slots: Optional[int] = None,
    n_sched_slots: Optional[int] = None,
    partition: str = "auto",
    specialize: bool = True,
    mesh=None,
    device="cuda",
    capture: bool = True,
) -> SweepResult:
    """The per-example entry point: `run_sweep_source` over
    ``PerExampleSource(per_example_loss_fn)`` and ``data=(X, y)``."""
    return run_sweep_source(
        PerExampleSource(per_example_loss_fn), params0, (X, y), n_workers=n_workers, cases=cases,
        num_iters=num_iters, keys=keys, key=key, n_replicas=n_replicas, eval_every=eval_every, unroll=unroll,
        n_switch_slots=n_switch_slots, n_sched_slots=n_sched_slots, partition=partition, specialize=specialize,
        mesh=mesh, device=device, capture=capture,
    )
