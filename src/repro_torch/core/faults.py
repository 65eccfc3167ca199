"""Per-worker fault injection: Byzantine gradients and mid-run crashes, in torch.

The port of `repro.core.faults`.  A fault is a transform on sampled response
times and on gradients, never on the sampler, so every cell keeps drawing
its times exactly as a healthy one does.  Each worker slot carries a packed
row ``(family, onset_time, param)``:

* ``none``         — a healthy worker (every slot's default);
* ``sign_flip``    — once ``sim_time >= onset`` the worker's gradient
  contribution is multiplied by -1;
* ``rescale``      — the contribution is multiplied by ``param``;
* ``random_gauss`` — the contribution is replaced by ``param * N(0, I)``
  noise, whose key is folded in from the event's subkey, so the engines'
  chain of key splits never advances for it;
* ``crash``        — the worker's response time (and, in the async modes,
  its residual clock) becomes +inf once ``sim_time >= onset``: it ranks
  after every live worker, as an inactive slot does.

Every transform is a closure over the packed per-slot vectors (a lane's
leaves in the sweep, tensors made once on the device in the looped
engine), built only for the families a program holds: a fault-free program
runs none of it, and inside a faulty program a healthy slot multiplies by
exactly 1.0 or passes a `torch.where` unchanged.  Gradient faults enter the
eq.-(2) weighted mean through its participation mask (the weighted loss is
linear in it; a gauss slot's mask entry is 0 and its noise is added
beside), and the robust aggregators (`aggregation.make_robust_select`)
through the per-worker row stack (`apply_row_faults`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.core import prng
from repro_torch.core.straggler import onset_mask
from repro_torch.core.tree import map_with_index

__all__ = [
    "FAULT_FAMILIES",
    "FAULT_NONE",
    "FAULT_SIGN_FLIP",
    "FAULT_RESCALE",
    "FAULT_GAUSS",
    "FAULT_CRASH",
    "GRAD_FAULTS",
    "FaultModel",
    "FaultPlan",
    "FaultFns",
    "byzantine_plan",
    "pack_faults",
    "plan_kinds_present",
    "crash_times",
    "fault_weights",
    "gauss_rows",
    "apply_row_faults",
    "make_fault_fns",
]

# The reference's family indices: the sweep stores them in its fault leaves.
# Append new families; never reorder.
FAULT_FAMILIES = {
    "none": 0,
    "sign_flip": 1,
    "rescale": 2,
    "random_gauss": 3,
    "crash": 4,
}
FAULT_NONE, FAULT_SIGN_FLIP, FAULT_RESCALE, FAULT_GAUSS, FAULT_CRASH = range(5)

# The families that corrupt a gradient's content (crash corrupts time only).
GRAD_FAULTS = (FAULT_SIGN_FLIP, FAULT_RESCALE, FAULT_GAUSS)

# The fold_in tag of the gauss noise's key, folded into the event's subkey:
# splitting the engine's key instead would move every other cell's draws.
_NOISE_TAG = 0x0FA17


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One worker's fault: ``(family, onset, param)``.  ``onset`` is in
    simulated time (the fault is active from the first master event whose
    start time reaches it); ``param`` is the rescale factor or the gauss
    noise scale (``sign_flip`` and ``crash`` ignore it)."""

    family: str
    onset: float = 0.0
    param: float = 1.0

    def __post_init__(self):
        if self.family not in FAULT_FAMILIES:
            raise ValueError(f"unknown fault family {self.family!r}; options {sorted(FAULT_FAMILIES)}")

    @property
    def kind(self) -> int:
        return FAULT_FAMILIES[self.family]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-worker faults (``None``: a healthy worker).  ``models[i]`` is
    active worker i's; workers past the plan's length are healthy, and so
    are inactive (padded) slots."""

    models: Sequence[Optional[FaultModel]]

    def __post_init__(self):
        object.__setattr__(self, "models", tuple(self.models))
        for m in self.models:
            if m is not None and not isinstance(m, FaultModel):
                raise ValueError(f"FaultPlan entries must be FaultModel or None, got {m!r}")

    def kinds_present(self) -> tuple:
        """The sorted non-``none`` family indices this plan can activate."""
        return tuple(sorted({m.kind for m in self.models if m is not None and m.kind != FAULT_NONE}))


def byzantine_plan(n_active: int, frac: float, family: str, onset: float = 0.0,
                   param: float = 1.0) -> Optional[FaultPlan]:
    """A fleet whose LAST ``round(frac * n_active)`` workers are faulty (so
    worker 0 stays honest and nested fractions are nested sets); ``None``
    when that rounds to zero workers or the family is ``none``."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"fault fraction must be in [0, 1], got {frac}")
    n_bad = int(round(frac * n_active))
    if n_bad == 0 or family == "none":
        return None
    fm = FaultModel(family=family, onset=onset, param=param)
    return FaultPlan(models=(None,) * (n_active - n_bad) + (fm,) * n_bad)


def pack_faults(plan: Optional[FaultPlan], n_slots: int, n_active: int) -> tuple:
    """A plan as per-slot numpy vectors ``(kinds int32, onset f32, param
    f32)``, each (n_slots,); ``None`` packs to healthy rows (kind 0, onset
    0, param 1)."""
    kinds = np.zeros((n_slots,), np.int32)
    onset = np.zeros((n_slots,), np.float32)
    param = np.ones((n_slots,), np.float32)
    if plan is None:
        return kinds, onset, param
    if len(plan.models) > n_active:
        raise ValueError(f"fault plan has {len(plan.models)} entries but only {n_active} active workers")
    for i, m in enumerate(plan.models):
        if m is None:
            continue
        kinds[i] = m.kind
        onset[i] = m.onset
        param[i] = m.param
    return kinds, onset, param


def plan_kinds_present(plan: Optional[FaultPlan]) -> tuple:
    """The signature component: the families a cell's plan can activate."""
    return () if plan is None else plan.kinds_present()


# ------------------------------------------------------- transforms on tensors


def crash_times(times, kinds, onset, t) -> torch.Tensor:
    """Response times (or residual clocks) with the crashed-past-onset slots
    at +inf, applied after the draw: they rank after every live worker."""
    crashed = (kinds == FAULT_CRASH) & onset_mask(onset, t)
    return torch.where(crashed, float("inf"), times)


def fault_weights(kinds, onset, param, t, present: tuple) -> torch.Tensor:
    """Per-slot multiplier of the eq.-(2) mask: ``sign_flip`` -1,
    ``rescale`` param, ``random_gauss`` 0 (its noise is added by the
    caller), exactly 1.0 for a healthy or not-yet-faulty slot.  Only the
    families in ``present`` are computed."""
    active = onset_mask(onset, t)
    w = torch.ones(kinds.shape, dtype=torch.float32, device=kinds.device)
    if FAULT_SIGN_FLIP in present:
        w = torch.where((kinds == FAULT_SIGN_FLIP) & active, -1.0, w)
    if FAULT_RESCALE in present:
        w = torch.where((kinds == FAULT_RESCALE) & active, param, w)
    if FAULT_GAUSS in present:
        w = torch.where((kinds == FAULT_GAUSS) & active, 0.0, w)
    return w


def gauss_rows(key, kinds, onset, param, t, params_like, n_slots: int):
    """Each worker's replacement noise, ``1[gauss & onset] * param * N(0, I)``:
    a params-shaped pytree of (n_slots, ...) leaves.  Leaf j (in JAX's leaf
    order) draws from ``fold_in(fold_in(key, _NOISE_TAG), j)``."""
    kz = prng.fold_in(key, _NOISE_TAG)
    gate = torch.where((kinds == FAULT_GAUSS) & onset_mask(onset, t), param, 0.0)

    def noise(j, leaf):
        z = prng.normal(prng.fold_in(kz, j), (n_slots,) + tuple(leaf.shape))
        return gate.reshape((n_slots,) + (1,) * leaf.dim()) * z

    return map_with_index(noise, params_like)


def _slot_bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(tuple(v.shape) + (1,) * (like.dim() - 1))


def apply_row_faults(rows, z, kinds, onset, param, t, present: tuple):
    """Gradient faults on the per-worker row stack (the robust path):
    ``sign_flip`` and ``rescale`` multiply a faulty row, a ``random_gauss``
    row is replaced by its noise row of ``z`` (the draw the mean path adds);
    a healthy row multiplies by exactly 1.0."""
    active = onset_mask(onset, t)
    mult = torch.ones(kinds.shape, dtype=torch.float32, device=kinds.device)
    if FAULT_SIGN_FLIP in present:
        mult = torch.where((kinds == FAULT_SIGN_FLIP) & active, -1.0, mult)
    if FAULT_RESCALE in present:
        mult = torch.where((kinds == FAULT_RESCALE) & active, param, mult)
    out = tree_map(lambda r: _slot_bcast(mult, r) * r, rows)
    if FAULT_GAUSS in present:
        gsel = (kinds == FAULT_GAUSS) & active
        out = tree_map(lambda r, zl: torch.where(_slot_bcast(gsel, r), zl, r), out, z)
    return out


class FaultFns(NamedTuple):
    """The fault closures the mode tails take; a field is None when its
    families are absent, and the tails then run nothing for it.

    * ``time(times, t)`` — the crash transform of times and clocks;
    * ``weight(t)`` — the per-slot multiplier of the eq.-(2) mask;
    * ``noise_rows(key, t)`` — the gauss noise rows (gated, scaled);
    * ``gauss_mask(t)`` — per slot: a gauss fault is active at t;
    * ``any_gauss`` — per cell: any slot is a gauss one (gates the mean
      path's noise add, so a gauss-free cell's gradient passes unchanged);
    * ``row_faults(rows, z, t)`` — the row-stack transform.
    """

    time: Optional[Callable]
    weight: Optional[Callable]
    noise_rows: Optional[Callable]
    gauss_mask: Optional[Callable]
    any_gauss: Any
    row_faults: Optional[Callable]


def make_fault_fns(kinds, onset, param, present: tuple, params_like, n_slots: int) -> Optional[FaultFns]:
    """The fault closures of one program over the packed per-slot tensors
    (a lane's leaves, or the looped engine's tensors); ``present`` is the
    static set of families the program runs, and with none it returns
    None."""
    if not present:
        return None
    has_grad = any(f in present for f in GRAD_FAULTS)
    has_gauss = FAULT_GAUSS in present
    has_crash = FAULT_CRASH in present
    return FaultFns(
        time=(lambda times, t: crash_times(times, kinds, onset, t)) if has_crash else None,
        weight=(lambda t: fault_weights(kinds, onset, param, t, present)) if has_grad else None,
        noise_rows=(lambda key, t: gauss_rows(key, kinds, onset, param, t, params_like, n_slots))
        if has_gauss else None,
        gauss_mask=(lambda t: (kinds == FAULT_GAUSS) & onset_mask(onset, t)) if has_gauss else None,
        any_gauss=(kinds == FAULT_GAUSS).any() if has_gauss else None,
        row_faults=(lambda rows, z, t: apply_row_faults(rows, z, kinds, onset, param, t, present))
        if has_grad else None,
    )
