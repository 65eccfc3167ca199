"""Monte-Carlo engine for (adaptive) fastest-k SGD over R replicas, in torch.

The port of `repro.core.montecarlo`.  One iteration is written for one
replica exactly as the reference's `one_step`: split the carried key, draw
the workers' response times, take the eq.-(2) gradient of the fastest k,
step the parameters, advance the simulated clock, and update the
controller, with k decided before the step.  `torch.func.vmap` maps it
over the R replica keys, as `jax.vmap(run_one)` does.  Every `eval_every`
iterations the mean loss is evaluated and (time, loss, k) recorded.

``mode`` selects the execution mode (`execmode`): ``"sync"`` runs the lean
step above; ``"kasync"`` and ``"kbatch"`` run `execmode.make_mode_steps`
over the renewal carry (`execmode.ExecCarry`), where the controller's k is
K (arrivals an update), its update gets the arrivals' staleness
(`execmode.ExecStats`), and an iteration is one master update.  ``fault``
(a `faults.FaultPlan`) and a robust ``agg`` route any mode, sync included,
through the mode steps, whose tails carry the fault transforms and the
robust select (`faults.make_fault_fns`, `aggregation.make_robust_select`
over the packed per-slot rows, tensors the program holds).  The sweep
builds its lanes from the same tails, so its cells are this engine's runs.

On a CUDA device (the default) `unroll` consecutive iterations are
captured once as a CUDA graph over static buffers (the carry, and a copy of
the inputs the step reads) and replayed, with the eval loss captured as a
graph of its own: the counterpart of `jax.jit(lax.scan)`, where the host
only replays graphs and copies three (R,) records per eval point.  Another
run with inputs of the same shapes copies them into the buffers and replays
the same graphs.  `capture=False` runs the same step eagerly, kernel by
kernel.  A capture that fails raises; nothing falls back.  `_Program` runs
any engine that gives it `build` and `initial`: this one (`_Engine`) and
the sweep's grid (`sweep._GridEngine`).

Programs are cached in a bounded LRU under the reference's key (source
token, n_workers, controller, straggler, comm, eta, iteration counts,
unroll, mode, fault, agg) plus the device, the capture flag and the
threefry mode.  `program_cache_stats()["traces"]` counts builds: one for
each program and each new signature of its inputs (the graphs of that
signature captured once), as `jit` retraces on new shapes.

    keys = prng.split(prng.PRNGKey(0), 32)
    result = run_monte_carlo(loss_fn, w0, X, y, n_workers=50,
                             controller=PflugController(n_workers=50),
                             straggler=Exponential(), eta=1e-2,
                             num_iters=40_000, keys=keys, eval_every=500)
    stats = summarize(result)
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._pytree import tree_map

from repro_torch import resolve_device
from repro_torch.core import aggregation, execmode, faults, prng
from repro_torch.core.execmode import MODES
from repro_torch.core.gradsource import GradSource, PerExampleSource
from repro_torch.core.straggler import (
    WorkerFleet,
    apply_rate_schedule,
    family_select_masks,
    pack_params_per_worker,
    pack_schedule,
    sample_times_selected,
)

__all__ = [
    "MODES",
    "MonteCarloResult",
    "make_step",
    "initial_carry",
    "run_monte_carlo",
    "run_monte_carlo_source",
    "default_unroll",
    "summarize",
    "program_cache_stats",
    "clear_program_cache",
    "set_program_cache_size",
    "program_cache_size",
]

_Z95 = 1.959963984540054  # two-sided 95% normal quantile


class _Carry(NamedTuple):
    params: object
    ctrl_state: object
    sim_time: torch.Tensor
    key: torch.Tensor


class MonteCarloResult(NamedTuple):
    """``time``/``loss``/``k``: (R, n_evals) tensors on the run's device;
    ``iteration``: (n_evals,) numpy, the iteration count at each eval point
    (multiples of ``eval_every``, and ``num_iters`` last)."""

    time: torch.Tensor
    loss: torch.Tensor
    k: torch.Tensor
    iteration: np.ndarray


def _hashable(obj):
    """Frozen-dataclass configs -> hashable cache-key components (lists as
    tuples, arrays by content, repr as the last resort)."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (
            type(obj).__module__,
            type(obj).__qualname__,
            tuple((f.name, _hashable(getattr(obj, f.name))) for f in dataclasses.fields(obj)),
        )
    if isinstance(obj, (list, tuple)):
        return tuple(_hashable(x) for x in obj)
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.shape, str(obj.dtype), obj.tobytes())
    try:
        hash(obj)
        return obj
    except TypeError:
        return repr(obj)


class _LRUProgramCache:
    """Bounded least-recently-used program cache; an evicted configuration
    is rebuilt (and its graphs recaptured) once on re-entry."""

    def __init__(self, maxsize: int = 32):
        self.maxsize = maxsize
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def __setitem__(self, key, value):
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def __len__(self):
        return len(self._entries)

    def clear(self):
        self._entries.clear()

    def resize(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"program cache maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)


def _default_program_cache_size() -> int:
    """``REPRO_PROGRAM_CACHE_SIZE`` if set (read at import), else 32."""
    raw = os.environ.get("REPRO_PROGRAM_CACHE_SIZE", "")
    if not raw:
        return 32
    try:
        size = int(raw)
    except ValueError:
        raise ValueError(f"REPRO_PROGRAM_CACHE_SIZE={raw!r} is not an integer") from None
    if size < 1:
        raise ValueError(f"REPRO_PROGRAM_CACHE_SIZE must be >= 1, got {size}")
    return size


_PROGRAM_CACHE = _LRUProgramCache(maxsize=_default_program_cache_size())
_N_TRACES = 0


def set_program_cache_size(maxsize: int) -> None:
    """Resize the program cache, evicting least-recently-used entries."""
    _PROGRAM_CACHE.resize(maxsize)


def program_cache_size() -> int:
    return _PROGRAM_CACHE.maxsize


def program_cache_stats() -> dict:
    return {"programs": len(_PROGRAM_CACHE), "traces": _N_TRACES}


def clear_program_cache() -> None:
    global _N_TRACES
    _PROGRAM_CACHE.clear()
    _N_TRACES = 0


def default_unroll(mode: str) -> int:
    """Iterations one CUDA graph holds when the caller gives none: the
    reference's scan unroll of 8, but 1 for kbatch, whose iteration alone
    launches ~10^4 kernels (n_slots draws and shard gradients): a graph of
    one iteration captures in a tenth of the time and replays as fast
    (PERF.md §6).  It never changes the arithmetic."""
    return 1 if mode == "kbatch" else 8


def _ctrl_k(state) -> torch.Tensor:
    return state.k if hasattr(state, "k") else state[0]


def _sampler(straggler, n_workers: int, dev: torch.device) -> Callable:
    """``sample(sub, sim_time) -> (n_workers,)`` response times: a fleet's
    packed rows through its rate schedule and the full family sampler (as
    the reference's fleet path), or the model's own sampler.  A fleet's
    tensors are made here, on ``dev``, so the step builds nothing from host
    data and can be captured."""
    if not isinstance(straggler, WorkerFleet):

        def sample(sub, sim_time):
            del sim_time
            return straggler.sample(sub, n_workers)

        return sample
    pmat_np, kinds_np, _ = pack_params_per_worker(straggler, n_workers)
    n_knots = len(straggler.schedule.times) if straggler.schedule else 0
    pmat = torch.from_numpy(pmat_np).to(dev)
    masks = family_select_masks(torch.from_numpy(kinds_np).to(dev))
    if not n_knots:
        # no schedule: its multiplier is exactly 1.0, so the rows are as packed
        return lambda sub, sim_time: sample_times_selected(masks, pmat, sub)
    sched = tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in pack_schedule(straggler.schedule, n_knots))

    def sample(sub, sim_time):
        return sample_times_selected(masks, apply_rate_schedule(pmat, *sched, sim_time), sub)

    return sample


def _mean_loss(fns, straggler, n_active) -> Callable:
    """The eval loss: a fleet's active shards only (``n_active`` a device
    int32 scalar), else every shard."""
    if isinstance(straggler, WorkerFleet):
        return lambda params: fns.eval_loss_active(params, n_active)
    return fns.eval_loss


def make_step(source: GradSource, data, n_workers: int, controller, straggler, comm, eta: float,
              n_active: Optional[torch.Tensor] = None):
    """The sync engine's ``(step, evaluate)`` over R replicas.

    ``step(carry) -> (carry, k)`` advances every replica one iteration and
    returns the k each used; ``evaluate(params) -> (R,)`` is the eval loss
    (active shards only for a fleet, ``n_active`` a device int32 scalar).
    """
    fns = source.build(data, n_workers)
    sample = _sampler(straggler, n_workers, _pytree.tree_leaves(data)[0].device)

    def one_step(carry: _Carry):
        keys = prng.split(carry.key)
        k = _ctrl_k(carry.ctrl_state)  # decided before the step
        mask, t_iter = aggregation.fastest_k_mask_time(sample(keys[1], carry.sim_time), k)
        if comm is not None:
            t_iter = t_iter + comm.time(k)
        g = fns.grad(carry.params, mask, k)
        params = tree_map(lambda p, gi: p - eta * gi, carry.params, g)
        sim_time = carry.sim_time + t_iter
        ctrl_state, _ = controller.update(carry.ctrl_state, g, sim_time)
        return _Carry(params, ctrl_state, sim_time, keys[0]), k

    return torch.func.vmap(one_step), torch.func.vmap(_mean_loss(fns, straggler, n_active))


def _robustness_fns(fault, agg: str, agg_param: float, straggler, n_workers: int, params_like, dev: torch.device):
    """(`faults.FaultFns` or None, robust select or None) of one looped
    configuration: the plan packed to per-slot tensors on ``dev``, and the
    aggregator's select over the kinds {mean, ``agg``}."""
    n_active = straggler.n_active if isinstance(straggler, WorkerFleet) else n_workers
    packed = (torch.from_numpy(a).to(dev) for a in faults.pack_faults(fault, n_workers, n_active))
    fault_fns = faults.make_fault_fns(*packed, faults.plan_kinds_present(fault), params_like, n_workers)
    kind = aggregation.AGG_KINDS[agg]
    robust = aggregation.make_robust_select(kind, float(agg_param), tuple(sorted({aggregation.AGG_MEAN, kind})))
    return fault_fns, robust


def make_mode_step(source: GradSource, data, n_workers: int, controller, straggler, comm, eta: float, mode: str,
                   n_active: Optional[torch.Tensor] = None, fault=None, agg: str = "mean", agg_param: float = 0.1,
                   params_like=None):
    """`make_step` for any mode: ``mode``'s step from `execmode.make_mode_steps`
    over the `execmode.ExecCarry` of R replicas, with the faults of
    ``fault`` and the aggregator ``agg`` (``params_like``: one replica's
    params, the shapes of the gauss noise).  The controller's update gets
    the `execmode.ExecStats` of each update; a user controller whose
    ``update`` takes three arguments is called without them, as the
    reference tolerates."""
    stale_grad, shard_grad_at = source.build_stale(data, n_workers)
    fns = source.build(data, n_workers)
    dev = _pytree.tree_leaves(data)[0].device
    fault_fns, robust = _robustness_fns(fault, agg, agg_param, straggler, n_workers, params_like, dev)
    try:
        accepts_stats = len(inspect.signature(controller.update).parameters) >= 4
    except (TypeError, ValueError):  # builtins and other callables without a signature
        accepts_stats = True

    def ctrl_update(state, g, sim_time, stats):
        if accepts_stats:
            return controller.update(state, g, sim_time, stats)
        return controller.update(state, g, sim_time)

    steps = execmode.make_mode_steps(
        n_slots=n_workers, draw=_sampler(straggler, n_workers, dev),
        sync_grad=fns.grad, stale_grad=stale_grad, shard_grad_at=shard_grad_at,
        comm_time=comm.time if comm is not None else None, eta=eta, ctrl_update=ctrl_update, ctrl_k=_ctrl_k,
        faults=fault_fns, robust_agg=robust,
    )
    dims = execmode.CARRY_DIMS
    step = torch.func.vmap(steps[MODES[mode]], in_dims=(dims,), out_dims=(dims, 0))
    return step, torch.func.vmap(_mean_loss(fns, straggler, n_active))


def _replicate(carry, keys: torch.Tensor):
    """``carry`` of one replica as R = len(keys) replicas: every field but
    the key repeated (a copy each), the key replaced by ``keys``."""
    r = keys.shape[0]

    def rep(x):
        return x if x is None else x.unsqueeze(0).expand((r,) + tuple(x.shape)).clone()

    fields = {f: tree_map(rep, getattr(carry, f)) for f in carry._fields if f != "key"}
    return carry._replace(key=keys.clone(), **fields)


def initial_carry(controller, params0, keys: torch.Tensor) -> _Carry:
    """The carry of R = len(keys) replicas before their first iteration:
    params0 and the controller's initial state repeated R times, clock 0."""
    sim_time = torch.zeros((), dtype=torch.float32, device=keys.device)
    return _replicate(_Carry(params0, controller.init(params0), sim_time, keys[0]), keys)


def initial_exec_carry(controller, params0, n_slots: int, keys: torch.Tensor) -> execmode.ExecCarry:
    """The async modes' `initial_carry`: `execmode.init_exec_carry` repeated
    over R = len(keys) replicas."""
    return _replicate(execmode.init_exec_carry(params0, n_slots, controller.init(params0), keys[0]), keys)


def _tensors(tree) -> list:
    """The tensor leaves of ``tree`` (an ExecCarry's opt_state is None)."""
    return [x for x in _pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _signature(tree) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in _tensors(tree))


def _clone(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _copy_into(dst_tree, src_tree) -> None:
    for dst, src in zip(_tensors(dst_tree), _tensors(src_tree)):
        dst.copy_(src)


class _Inputs(NamedTuple):
    """What one run of the engine reads besides its configuration."""

    params0: object
    data: object
    keys: torch.Tensor
    n_active: Optional[torch.Tensor]  # a fleet's active slots, device int32; None otherwise


@dataclasses.dataclass(frozen=True)
class _Engine:
    """The looped engine's configuration: ``build(inputs) -> (step,
    evaluate)`` and ``initial(inputs) -> carry``, what `_Program` runs."""

    source: GradSource
    n_workers: int
    controller: object
    straggler: object
    comm: Optional[aggregation.CommModel]
    eta: float
    mode: str = "sync"
    fault: Optional[faults.FaultPlan] = None
    agg: str = "mean"
    agg_param: float = 0.1

    @property
    def moded(self) -> bool:
        """Whether the step is a mode tail's: any async mode, fault or robust
        aggregator (the lean sync step runs none of them)."""
        return self.mode != "sync" or self.fault is not None or self.agg != "mean"

    def build(self, inputs: _Inputs):
        args = (self.source, inputs.data, self.n_workers, self.controller, self.straggler, self.comm, self.eta)
        if not self.moded:
            return make_step(*args, n_active=inputs.n_active)
        return make_mode_step(*args, self.mode, n_active=inputs.n_active, fault=self.fault, agg=self.agg,
                              agg_param=self.agg_param, params_like=inputs.params0)

    def initial(self, inputs: _Inputs):
        if not self.moded:
            return initial_carry(self.controller, inputs.params0, inputs.keys)
        return initial_exec_carry(self.controller, inputs.params0, self.n_workers, inputs.keys)


class _Captured:
    """Static buffers and CUDA graphs of one input signature: a copy of the
    inputs that the graphs read, a graph for each block length the run
    needs (advancing the carry in place) and one for the eval loss.
    ``load`` copies another run's inputs of the same signature into the
    buffers, so the graphs serve it without a new capture."""

    def __init__(self, engine, inputs, lengths):
        self.inputs = _clone(inputs)
        self.carry = engine.initial(self.inputs)
        self.flat = _tensors(self.carry)
        lanes, dev = self.carry.sim_time.shape[0], self.carry.sim_time.device
        self.k = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.loss = torch.zeros((lanes,), dtype=torch.float32, device=dev)
        step, evaluate = engine.build(self.inputs)
        # The graphs read the tensors build made (a fleet's packed rows) at
        # their addresses: hold them as long as the graphs, or their memory is
        # handed to other tensors.
        self.fns = (step, evaluate)

        def advance(length: int):
            c, k = self.carry, None
            for _ in range(length):
                c, k = step(c)
            # k first: after one step it is the static controller state's k
            # itself, which the carry's copy below overwrites
            self.k.copy_(k)
            for dst, src in zip(self.flat, _tensors(c)):
                dst.copy_(src)

        def run_eval():
            self.loss.copy_(evaluate(self.carry.params))

        # warm up on a side stream (library handles, workspaces), as capture wants
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            advance(1)
            run_eval()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs = {}
        for length in sorted(lengths):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                advance(length)
            self.graphs[length] = g
        self.eval_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.eval_graph):
            run_eval()

    def load(self, engine, inputs) -> None:
        _copy_into(self.inputs, inputs)
        _copy_into(self.flat, engine.initial(self.inputs))


class _Program:
    """One configuration of an engine (`_Engine`, or the sweep's grid
    engine): eager, or CUDA graphs per input signature.  ``on_build`` is
    called once for each signature it builds, the owner's trace count."""

    def __init__(self, engine, num_iters: int, eval_every: int, unroll: int, capture: bool, partitionable: bool,
                 on_build: Callable[[], None]):
        self.engine, self.on_build = engine, on_build
        self.unroll, self.capture, self.partitionable = max(1, int(unroll)), capture, partitionable
        n_full, rem = divmod(num_iters, eval_every)
        self.blocks = [eval_every] * n_full + ([rem] if rem else [])
        self._captured: dict = {}
        self._signatures: set = set()

    def _graph_lengths(self) -> set:
        lengths = set()
        for b in set(self.blocks):
            u = min(self.unroll, b)
            lengths.add(u)
            if b % u:
                lengths.add(b % u)
        return lengths

    def __call__(self, inputs):
        """Run every block from the engine's initial carry; (time, loss, k)
        records, each (lanes, n_evals)."""
        sig = _signature(inputs)
        with prng.threefry_mode(self.partitionable):
            if self.capture:
                cap = self._captured.get(sig)
                if cap is None:
                    self.on_build()
                    cap = self._captured[sig] = _Captured(self.engine, inputs, self._graph_lengths())
                return self._run_captured(cap, inputs)
            if sig not in self._signatures:
                self.on_build()
                self._signatures.add(sig)
            return self._run_eager(inputs)

    def _records(self, lanes: int, dev):
        n = len(self.blocks)
        return (torch.empty((lanes, n), dtype=torch.float32, device=dev),
                torch.empty((lanes, n), dtype=torch.float32, device=dev),
                torch.empty((lanes, n), dtype=torch.int32, device=dev))

    def _run_eager(self, inputs):
        step, evaluate = self.engine.build(inputs)
        carry = self.engine.initial(inputs)
        times, losses, ks = self._records(carry.sim_time.shape[0], carry.sim_time.device)
        for j, length in enumerate(self.blocks):
            for _ in range(length):
                carry, k = step(carry)
            times[:, j] = carry.sim_time
            losses[:, j] = evaluate(carry.params)
            ks[:, j] = k
        return times, losses, ks

    def _run_captured(self, cap: _Captured, inputs):
        cap.load(self.engine, inputs)
        times, losses, ks = self._records(cap.k.shape[0], cap.k.device)
        for j, length in enumerate(self.blocks):
            u = min(self.unroll, length)
            for _ in range(length // u):
                cap.graphs[u].replay()
            if length % u:
                cap.graphs[length % u].replay()
            cap.eval_graph.replay()
            times[:, j] = cap.carry.sim_time
            losses[:, j] = cap.loss
            ks[:, j] = cap.k
        return times, losses, ks


def _count_build() -> None:
    global _N_TRACES
    _N_TRACES += 1


def _to_device(tree, dev: torch.device):
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.from_numpy(np.array(x)).to(dev)

    return tree_map(one, tree)


def run_monte_carlo_source(
    source: GradSource,
    params0,
    data,
    n_workers: int,
    controller,
    straggler,
    eta: float,
    num_iters: int,
    keys=None,
    key=None,
    n_replicas: Optional[int] = None,
    comm: Optional[aggregation.CommModel] = None,
    eval_every: int = 10,
    unroll: Optional[int] = None,
    mode: str = "sync",
    fault=None,
    agg: str = "mean",
    agg_param: float = 0.1,
    device="cuda",
    capture: bool = True,
) -> MonteCarloResult:
    """Run R fastest-k SGD replicas of a ``GradSource`` on ``device``.

    ``params0`` and ``data`` are pytrees of tensors or numpy arrays, moved
    to ``device``; ``keys`` are R keys ((R, 2), numpy uint32 from JAX or
    `prng` keys), or pass ``key`` and ``n_replicas`` to split one.
    ``capture`` (CUDA only) replays CUDA graphs of ``unroll`` iterations
    (None: `default_unroll` of the mode); False runs the same step eagerly.  The threefry mode in force
    (`prng.set_partitionable`) applies to the whole run.  ``fault`` is a
    `faults.FaultPlan` or None, ``agg`` an `aggregation.AGG_KINDS` name
    (robust ones refused in kbatch mode) with ``agg_param`` the trimmed
    mean's trim fraction.
    """
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
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {sorted(MODES)}")
    if agg not in aggregation.AGG_KINDS:
        raise ValueError(f"unknown aggregator {agg!r}; options {sorted(aggregation.AGG_KINDS)}")
    if agg != "mean" and mode == "kbatch":
        raise ValueError(
            f"robust aggregation ({agg!r}) is not supported in kbatch mode — kbatch arrivals are "
            "sequential, there is no per-worker row stack to aggregate"
        )
    if fault is not None and not isinstance(fault, faults.FaultPlan):
        raise ValueError(f"fault must be a faults.FaultPlan or None, got {fault!r}")
    if isinstance(straggler, WorkerFleet):
        cn = getattr(controller, "n_workers", None)
        if cn is not None and cn != straggler.n_active:
            raise ValueError(f"fleet has {straggler.n_active} models but controller.n_workers={cn}")
    faults.pack_faults(fault, n_workers, straggler.n_active if isinstance(straggler, WorkerFleet) else n_workers)

    if unroll is None:
        unroll = default_unroll(mode)
    capture = bool(capture) and dev.type == "cuda"
    partitionable = prng.is_partitionable()
    cache_key = (
        source.cache_token(), n_workers, _hashable(controller), _hashable(straggler), _hashable(comm),
        float(eta), int(num_iters), int(eval_every), int(unroll), str(mode), _hashable(fault), str(agg),
        float(agg_param), str(dev), capture, partitionable,
    )
    program = _PROGRAM_CACHE.get(cache_key)
    if program is None:
        engine = _Engine(source, n_workers, controller, straggler, comm, float(eta), str(mode), fault, str(agg),
                         float(agg_param))
        program = _Program(engine, int(num_iters), int(eval_every), unroll, capture, partitionable, _count_build)
        _PROGRAM_CACHE[cache_key] = program
    n_active = None
    if isinstance(straggler, WorkerFleet):
        n_active = torch.full((), straggler.n_active, dtype=torch.int32, device=dev)
    times, losses, ks = program(_Inputs(params0, data, keys, n_active))
    iteration = np.minimum(np.arange(1, times.shape[1] + 1) * eval_every, num_iters).astype(np.int64)
    return MonteCarloResult(time=times, loss=losses, k=ks, iteration=iteration)


def run_monte_carlo(
    per_example_loss_fn: Callable,
    params0,
    X,
    y,
    n_workers: int,
    controller,
    straggler,
    eta: float,
    num_iters: int,
    keys=None,
    key=None,
    n_replicas: Optional[int] = None,
    comm: Optional[aggregation.CommModel] = None,
    eval_every: int = 10,
    unroll: Optional[int] = None,
    mode: str = "sync",
    fault=None,
    agg: str = "mean",
    agg_param: float = 0.1,
    device="cuda",
    capture: bool = True,
) -> MonteCarloResult:
    """Run R independent fastest-k SGD replicas (``run_monte_carlo_source``
    over ``PerExampleSource(per_example_loss_fn)``).

    ``per_example_loss_fn(params, X, y) -> (m,)`` losses, rows worker-major
    (worker i owns rows [i*s, (i+1)*s)); each replica reproduces the
    trajectory of the reference's engine for its key.  ``straggler`` may be
    a ``WorkerFleet`` (per-worker models, an optional rate schedule driven
    by the carried clock, +inf-padded inactive slots held out of training
    and of the eval loss).
    """
    return run_monte_carlo_source(
        PerExampleSource(per_example_loss_fn), params0, (X, y), n_workers=n_workers, controller=controller,
        straggler=straggler, eta=eta, num_iters=num_iters, keys=keys, key=key, n_replicas=n_replicas,
        comm=comm, eval_every=eval_every, unroll=unroll, mode=mode, fault=fault, agg=agg,
        agg_param=agg_param, device=device, capture=capture,
    )


def summarize(result: MonteCarloResult) -> dict:
    """Replica means and 95% CI half-widths (numpy, shape (n_evals,)):
    ``{'iteration', 'n_replicas', 'time_mean', 'time_ci95', 'loss_mean',
    'loss_ci95', 'k_mean', 'k_ci95'}``; the CI is ``z s / sqrt(R)``, zero
    when R < 2."""
    out = {"iteration": np.asarray(result.iteration)}
    r = None
    for name, arr in (("time", result.time), ("loss", result.loss), ("k", result.k)):
        a = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)).astype(np.float64)
        r = a.shape[0]
        out[f"{name}_mean"] = a.mean(axis=0)
        if r > 1:
            out[f"{name}_ci95"] = _Z95 * a.std(axis=0, ddof=1) / math.sqrt(r)
        else:
            out[f"{name}_ci95"] = np.zeros(a.shape[1])
    out["n_replicas"] = r
    return out
