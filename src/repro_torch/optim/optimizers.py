"""SGD (with momentum and Nesterov), Adam and AdamW over dicts of tensors.

The port of `repro/optim/optimizers.py`.  States are the reference's named
tuples (`SGDState`, `AdamState(step, mu, nu)`) with the same leaves, and
the arithmetic is the reference's: moments in f32 (or `moments_dtype`),
the bias correction from `step` as f32, and ``(p + u)`` cast back to the
parameter's dtype.  torch.optim is not used: its state and its order of
operations are not the reference's.

Each optimizer is one function of a single leaf, run two ways:

* ``update(grads, state, params) -> (updates, state)``: the reference's
  interface, functional, every update kept as an f32 tree;
* ``apply(grads, state, params) -> (params, state)``: the update and
  `apply_updates` leaf by leaf, writing the moments and the parameters in
  place.  This is what a train step at full width needs: the reference's
  jit donates the train state, so XLA reuses its buffers, and eager torch
  only does so when told.  The caller's ``state`` and ``params`` are
  consumed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.core.tree import tree_leaves

__all__ = ["Optimizer", "SGDState", "AdamState", "sgd", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "chain_clip", "get_optimizer"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]
    apply: Callable[..., Tuple[Any, Any]]


def _new_param(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (p + u).to(p.dtype)


def apply_updates(params, updates):
    return tree_map(_new_param, params, updates)


def _flat(tree):
    return tree_flatten(tree)[0]


def _zeros(params, dtype=F32):
    """Zero slots shaped as the parameters (DTensors with their layout, for
    sharded parameters)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype, memory_format=torch.contiguous_format), params)


class SGDState(NamedTuple):
    momentum: Any  # a tree of f32 buffers, or () when momentum == 0


def _optimizer(init, prepare, new_slots, direction, slots_of, rebuild) -> Optimizer:
    """An `Optimizer` from its two leaf functions.  ``prepare(state)`` gives
    the update's scalars (Adam's step and bias corrections);
    ``new_slots(g, slots, ctx)`` is one parameter's new state leaves, and
    ``direction(g, slots, p, ctx)`` its update from them; ``slots_of(state)``
    lists each parameter's state leaves, and ``rebuild(state, slots, ctx)``
    makes the new state from them.  `apply` writes a leaf's new slots into
    the old ones before it takes the direction, so only one leaf's
    temporaries are alive at a time."""

    def update(grads, state, params=None):
        ctx = prepare(state)
        g_leaves, spec = tree_flatten(grads)
        p_leaves = _flat(params) if params is not None else itertools.repeat(None)
        slots = [new_slots(g, s, ctx) for g, s in zip(g_leaves, slots_of(state))]
        updates = [direction(g, s, p, ctx) for g, s, p in zip(g_leaves, slots, p_leaves)]
        return tree_unflatten(updates, spec), rebuild(state, slots, ctx)

    def apply(grads, state, params):
        ctx = prepare(state)
        slots = list(itertools.islice(slots_of(state), len(_flat(params))))
        for g, old, p in zip(_flat(grads), slots, _flat(params)):
            for o, n in zip(old, new_slots(g, old, ctx)):
                o.copy_(n)
            p.copy_(_new_param(p, direction(g, old, p, ctx)))
        return params, rebuild(state, slots, ctx)

    return Optimizer(init=init, update=update, apply=apply)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        return SGDState(momentum=_zeros(params) if momentum else ())

    def new_slots(g, slots, ctx):
        return (momentum * slots[0] + g.to(F32),) if momentum else ()

    def direction(g, slots, p, ctx):
        if not momentum:
            return -lr * g.to(F32)
        return -lr * (momentum * slots[0] + g) if nesterov else -lr * slots[0]

    def slots_of(state):
        return ((m,) for m in _flat(state.momentum)) if momentum else itertools.repeat(())

    def rebuild(state, slots, ctx):
        if not momentum:
            return state
        return SGDState(momentum=tree_unflatten([s[0] for s in slots], tree_flatten(state.momentum)[1]))

    return _optimizer(init, lambda state: None, new_slots, direction, slots_of, rebuild)


class AdamState(NamedTuple):
    step: torch.Tensor  # int32
    mu: Any
    nu: Any


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
         moments_dtype: str = "float32") -> Optimizer:
    """Adam; with weight_decay > 0 this is AdamW (decoupled decay).
    ``moments_dtype="bfloat16"`` halves the moments' memory; the update
    still runs in f32."""
    mdt = getattr(torch, moments_dtype)

    def init(params):
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
                         mu=_zeros(params, mdt), nu=_zeros(params, mdt))

    def prepare(state):
        step = state.step + 1
        step_f = step.to(F32)
        # b ** step with b as an f32 scalar, as JAX takes a Python float
        bc1 = 1 - torch.pow(torch.full((), b1, dtype=F32, device=step.device), step_f)
        bc2 = 1 - torch.pow(torch.full((), b2, dtype=F32, device=step.device), step_f)
        return step, bc1, bc2

    def new_slots(g, slots, ctx):
        m, v = slots
        g32 = g.to(F32)
        # b1 * m + (1 - b1) * g, the reference's operands (the scalars as f32)
        m_new = (b1 * m.to(F32)).add_((1 - b1) * g32).to(mdt)
        v_new = (b2 * v.to(F32)).add_(torch.square(g32).mul_(1 - b2)).to(mdt)
        return m_new, v_new

    def direction(g, slots, p, ctx):
        # -lr * (m / bc1) / (sqrt(v / bc2) + eps) - lr wd p, the reference's
        # operations in its order, in place on fresh temporaries: a leaf of
        # the full model holds 0.7 G elements, 2.8 GB a temporary
        (m, v), (_, bc1, bc2) = slots, ctx
        u = (m.to(F32) / bc1).mul_(-lr).div_(torch.sqrt(v.to(F32) / bc2).add_(eps))
        if weight_decay and p is not None:
            u.sub_((lr * weight_decay) * p.to(F32))
        return u

    def slots_of(state):
        return zip(_flat(state.mu), _flat(state.nu))

    def rebuild(state, slots, ctx):
        spec = tree_flatten(state.mu)[1]
        return AdamState(step=ctx[0], mu=tree_unflatten([s[0] for s in slots], spec),
                         nu=tree_unflatten([s[1] for s in slots], spec))

    return _optimizer(init, prepare, new_slots, direction, slots_of, rebuild)


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm):
    the squares summed per leaf in f32, the leaves in the JAX package's
    order; a leaf below f32 comes back in f32, as JAX promotes it."""
    sq = [torch.sum(torch.square(g.to(F32))) for g in tree_leaves(grads)]
    gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, F32)) * scale, grads), gnorm


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping."""

    def update(grads, state, params=None):
        return opt.update(clip_by_global_norm(grads, max_norm)[0], state, params)

    def apply(grads, state, params):
        return opt.apply(clip_by_global_norm(grads, max_norm)[0], state, params)

    return Optimizer(init=opt.init, update=update, apply=apply)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    registry = {"sgd": sgd, "adam": adam, "adamw": adamw}
    if name not in registry:
        raise ValueError(f"unknown optimizer {name!r}; options {sorted(registry)}")
    return registry[name](lr, **kw)
