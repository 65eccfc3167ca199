"""Activation-sharding context: models call `constrain(x, ...logical axes)`;
launch code installs a resolver mapping logical axis names to mesh axes.

The port of `repro/shardctx.py`.  The model code stays mesh-agnostic:
with no resolver installed, or on a plain tensor, every call is a no-op
that returns ``x`` itself, so a run without a mesh computes the same bits
as before.  Under a resolver (`launch.sharding.activation_resolver`) a
DTensor activation is redistributed to the resolved placements, the
counterpart of `jax.lax.with_sharding_constraint`: it pins the layout that
DTensor's sharding propagation would otherwise pick op by op.

Logical activation axes:
  batch   — data parallelism: ('pod','data')
  tp      — tensor parallelism: ('model',)
  experts — expert parallelism (MoE dispatch tensors): ('model',)
  none    — explicitly replicated
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import axis_names

_STATE = threading.local()


def _resolver() -> Optional[Callable]:
    return getattr(_STATE, "resolver", None)


@contextlib.contextmanager
def activation_sharding(resolver: Callable[..., object]):
    """resolver(logical_dims, shape, strict=False) -> a sharding with
    ``mesh`` and ``placements`` (`launch.sharding.Named`), or None to skip."""
    prev = _resolver()
    _STATE.resolver = resolver
    try:
        yield
    finally:
        _STATE.resolver = prev


def recompute_context() -> Optional[Callable]:
    """For a checkpointed region: a factory of the context the region's
    recomputation must run in to lay its activations out as the forward
    pass did (the installed resolver, and DTensor's implicit replication
    that `launch.sharding.mesh_context` installs beside it), or None when
    no resolver is installed.  The backward of CUDA tensors runs on
    autograd's device thread, where this thread-local state is unset."""
    resolver = _resolver()
    if resolver is None:
        return None

    @contextlib.contextmanager
    def context():
        from torch.distributed.tensor.experimental import implicit_replication

        with activation_sharding(resolver), implicit_replication():
            yield

    return context


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; imports nothing of torch.distributed for
    a plain tensor."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _apply(x: torch.Tensor, sharding) -> torch.Tensor:
    placements = tuple(sharding.placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with tensor dims ``dims`` whole on every rank: a DTensor's
    `Shard` of any of them (and any `Partial`) becomes `Replicate`, the
    rest of its layout kept.  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = {d % x.ndim for d in dims}
    placements = tuple(Replicate() if (isinstance(p, Shard) and p.dim % x.ndim in want) or p.is_partial() else p
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x: torch.Tensor, *logical: str) -> torch.Tensor:
    fn = _resolver()
    if fn is None or not is_dtensor(x):
        return x
    sharding = fn(tuple(logical), tuple(x.shape))
    if sharding is None:
        return x
    return _apply(x, sharding)


def constrain_alt(x: torch.Tensor, *alternatives: Tuple[str, ...]) -> torch.Tensor:
    """Constrain with the FIRST alternative whose every non-'none' dim is
    satisfiable (divisible by its mesh extent); no-op if none fits.

    This is how e.g. attention picks head-sharding when the head count
    divides the model axis and falls back to sequence (context) parallelism
    otherwise (llama's 24 heads / hymba's 25 heads on a 16-way axis)."""
    fn = _resolver()
    if fn is None or not is_dtensor(x):
        return x
    for alt in alternatives:
        sharding = fn(tuple(alt), tuple(x.shape), strict=True)
        if sharding is not None:
            return _apply(x, sharding)
    return x


def current_sweep_mesh():
    """The 2-D sweep mesh installed by ``sweep_mesh`` (None when unset)."""
    return getattr(_STATE, "sweep_mesh", None)


@contextlib.contextmanager
def sweep_mesh(mesh):
    """Install a ``("cells", "replicas")`` mesh for every ``run_sweep`` /
    ``run_sweep_source`` dispatch in the dynamic extent — the same
    context-not-argument pattern as ``activation_sharding``, so launch code
    (sim and LM paths alike) pins the dispatch mesh without threading a
    parameter through every call site.  An explicit ``mesh=`` argument to
    the sweep entry points still wins over the context."""
    if axis_names(mesh) != ("cells", "replicas"):
        raise ValueError(f"sweep mesh must have axes ('cells', 'replicas'), got {axis_names(mesh)}")
    prev = current_sweep_mesh()
    _STATE.sweep_mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.sweep_mesh = prev


def on_local_shards(fn: Callable, xs: Sequence, dims: Sequence[Tuple[Optional[int], Optional[int]]],
                    heads: Sequence[int], out_dims: Sequence[Tuple[Optional[int], Optional[int]]]):
    """``fn(*local tensors)`` on each rank's shard of ``xs``, for work that is
    independent across the batch and the heads (attention, the wkv scan):
    the counterpart of `local_map` over a (batch, heads) layout.

    ``dims[j]`` is (batch dim, head dim) of ``xs[j]`` (None where it has
    none).  The DTensors among ``xs`` with both (with a batch dim, where
    none has heads) decide the layout: for each mesh dim, `Shard` of the
    batch where every one of them shards its batch there, `Shard` of the
    heads where every one shards its heads there and every count in
    ``heads`` divides by the extent of all mesh dims that shard heads (so
    each rank's q heads keep their kv head), else `Replicate`.  A layout
    that shards another dim (a sequence, a head's features) or is partial
    is gathered first: an explicit redistribute.  A plain tensor among
    ``xs`` is one that every rank holds whole, and each rank takes its
    slice; None passes through.  The outputs (one, or a tuple) are
    DTensors with ``out_dims``' (batch dim, head dim) sharded as the
    layout says.  Every step is differentiable."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh = next(x.device_mesh for x in xs if is_dtensor(x))
    n = len(mesh.shape)

    def placements(x):
        return tuple(x.placements) if is_dtensor(x) else (Replicate(),) * n

    deciding = [(placements(x), bd, hd) for x, (bd, hd) in zip(xs, dims) if is_dtensor(x) and bd is not None
                and (hd is not None or all(h is None for _, h in dims))]
    layout = []
    for i in range(n):
        if deciding and all(p[i].is_shard(bd) for p, bd, _ in deciding):
            layout.append("batch")
        elif deciding and all(hd is not None and p[i].is_shard(hd) for p, _, hd in deciding):
            layout.append("heads")
        else:
            layout.append(None)
    ext = 1
    for i, o in enumerate(layout):
        ext *= int(mesh.shape[i]) if o == "heads" else 1
    if ext > 1 and any(h % ext for h in heads):
        layout = [None if o == "heads" else o for o in layout]

    def under(bd, hd):
        return tuple(Shard(bd) if o == "batch" and bd is not None else Shard(hd) if o == "heads" and hd is not None
                     else Replicate() for o in layout)

    def local(x, bd, hd):
        if x is None:
            return None
        want = under(bd, hd)
        if is_dtensor(x):
            return (x if tuple(x.placements) == want else x.redistribute(mesh, want)).to_local()
        return distribute_tensor(x, mesh, want, src_data_rank=None).to_local()

    out = fn(*(local(x, bd, hd) for x, (bd, hd) in zip(xs, dims)))

    def wrap(y, bd, hd):
        y = y.contiguous()  # the DTensor's strides are the contiguous ones of its global shape
        shape = list(y.shape)
        for i, o in enumerate(layout):
            d = bd if o == "batch" else hd if o == "heads" else None
            if d is not None:
                shape[d] *= int(mesh.shape[i])
        return DTensor.from_local(y, mesh, under(bd, hd), run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    if isinstance(out, tuple):
        return tuple(wrap(y, bd, hd) for y, (bd, hd) in zip(out, out_dims))
    return wrap(out, *out_dims[0])
