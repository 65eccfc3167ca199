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
import math
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


def _apply(x: torch.Tensor, placements: tuple) -> torch.Tensor:
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
    return _apply(x, tuple(sharding.placements))


class _GradAs(torch.autograd.Function):
    """Identity whose backward redistributes the gradient to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _apply(grad, ctx.placements), None


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient the backward pass lays out as ``x`` is laid out
    (the cotangent's constraint that the transpose of
    `jax.lax.with_sharding_constraint` adds).  DTensor otherwise gives a
    product's input gradient the layout its sharding rule picks: the
    residual stream's batch split over the model axis too, which each
    elementwise op of the backward then meets by gathering the saved
    operands that shard the head dim.  No-op on a plain tensor or without a
    resolver."""
    if _resolver() is None or not is_dtensor(x):
        return x
    return _GradAs.apply(x, tuple(x.placements))


def constrain_alt(x: torch.Tensor, *alternatives: Tuple[str, ...]) -> torch.Tensor:
    """Constrain with the FIRST alternative whose every non-'none' dim is
    satisfiable (divisible by its mesh extent); no-op if none fits.

    This is how e.g. attention picks head-sharding when the head count
    divides the model axis and falls back to sequence (context) parallelism
    otherwise (llama's 24 heads / hymba's 25 heads on a 16-way axis)."""
    layout = layout_of(x, *alternatives) if is_dtensor(x) else None
    return x if layout is None else _apply(x, layout[1])


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


def all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``x`` reduced by ``op`` over each (mesh, mesh dim) of ``groups``, as
    functional collectives, which a fake process group and
    `roofline.count_step` both see."""
    from torch.distributed import _functional_collectives as funcol

    for group in groups:
        x = funcol.all_reduce(x, op, group)
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


def block_of(mesh, dims: Sequence[int]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a tensor dim split over
    mesh dims ``dims``: the first of them splits it first, as DTensor's
    `Shard` on several mesh dims does."""
    coord = mesh.get_coordinate()
    rank, extent = 0, 1
    for i in dims:
        rank, extent = rank * mesh.size(i) + coord[i], extent * mesh.size(i)
    return rank, extent


def local_of(x, mesh, want: tuple, partial_dims=()) -> Optional[torch.Tensor]:
    """This rank's local tensor of ``x`` laid out as ``want`` (a DTensor is
    redistributed, a plain tensor that every rank holds whole is sliced;
    None passes through).  The gradient of a DTensor is partial on the mesh
    dims of ``partial_dims`` where ``want`` replicates it: every rank there
    holds it whole and uses its own part of it."""
    from torch.distributed.tensor import Partial, distribute_tensor

    if x is None:
        return None
    if not is_dtensor(x):
        return distribute_tensor(x, mesh, want, src_data_rank=None).to_local()
    grad = tuple(Partial() if i in partial_dims and p.is_replicate() else p for i, p in enumerate(want))
    return (x if tuple(x.placements) == want else x.redistribute(mesh, want)).to_local(grad_placements=grad)


def global_of(y: torch.Tensor, mesh, placements: tuple) -> torch.Tensor:
    """The DTensor whose local tensor on this rank is ``y``, laid out as
    ``placements``, evenly: each sharded dim is its local size times the
    extent of the mesh dims that shard it."""
    from torch.distributed.tensor import DTensor

    y = y.contiguous()  # the DTensor's strides are the contiguous ones of its global shape
    shape = list(y.shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] *= int(mesh.size(i))
    return DTensor.from_local(y, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def layout_of(x: torch.Tensor, *alternatives: Tuple[str, ...]) -> Optional[Tuple[int, tuple]]:
    """(index, placements) of the first of ``alternatives`` (logical dims,
    as `constrain_alt` takes them) that the installed resolver can satisfy
    for ``x``'s shape, each dim divisible by its mesh extent; None without a
    resolver or where none fits."""
    fn = _resolver()
    if fn is None:
        return None
    for i, alt in enumerate(alternatives):
        sharding = fn(tuple(alt), tuple(x.shape), strict=True)
        if sharding is not None:
            return i, tuple(sharding.placements)
    return None


# The reference's attention layouts (`repro/models/layers.py::_sdpa`) of a
# (B, T or S, heads, hd) tensor: the heads on the model axis where they
# divide it, else the sequence (a query's, or a decode cache's).
BY_HEADS, BY_SEQUENCE = ("batch", "none", "tp", "none"), ("batch", "tp", "none", "none")


def head_block(h: int, kvh: int, rank: int, extent: int) -> Tuple[int, int, int, int]:
    """(q0, hl, k0, k1): block ``rank`` of ``extent`` of ``h`` q heads is
    heads [q0, q0 + hl), and they read kv heads [k0, k1) of ``kvh`` (q head
    j reads kv head j // (h / kvh), as the reference's `jnp.repeat`)."""
    hl, g = h // extent, h // kvh
    q0 = rank * hl
    return q0, hl, q0 // g, (q0 + hl - 1) // g + 1


def kv_for_heads(k: torch.Tensor, h: int, kvh: int, rank: int, extent: int, first: int = 0) -> torch.Tensor:
    """The kv heads of (B, S, KV, hd) ``k`` that q-head block ``rank`` of
    ``extent`` reads (`head_block`), ``k`` holding kv heads [first, first +
    k.shape[2]) of ``kvh``.  Where the block's q heads are whole groups of
    one kv head (or share one), a slice keeps GQA; where they straddle kv
    heads, the slice is repeated to one kv head a q head."""
    q0, hl, k0, k1 = head_block(h, kvh, rank, extent)
    g = h // kvh
    x = k[:, :, k0 - first:k1 - first]
    if hl % g == 0 or g % hl == 0:
        return x
    return torch.repeat_interleave(x, g, dim=2)[:, :, q0 - k0 * g:q0 - k0 * g + hl]


def heads_piece(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rank: int, extent: int):
    """The local tensors of block ``rank`` of ``extent`` of head-parallel
    attention, cut from whole (B, T, H, hd) ``q`` and (B, S, KV, hd) ``k``,
    ``v`` as `on_attention_shards` lays them out on a rank: its H/m q heads,
    and its own KV/m kv heads where KV divides m, else k and v whole."""
    h, kvh = q.shape[2], k.shape[2]
    hl = h // extent
    ql = q[:, :, rank * hl:(rank + 1) * hl]
    if kvh % extent:
        return ql, k, v
    kl = kvh // extent
    return ql, k[:, :, rank * kl:(rank + 1) * kl], v[:, :, rank * kl:(rank + 1) * kl]


def heads_step(fn: Callable, ql, kl, vl, h: int, kvh: int, rank: int, extent: int):
    """``fn(q, k, v, 0)`` on block ``rank`` of ``extent`` of head-parallel
    attention over ``h`` q heads and ``kvh`` kv heads, from the rank's local
    tensors (`heads_piece`): its q heads and the kv heads they read
    (`kv_for_heads`)."""
    first = rank * (kvh // extent) if kvh % extent == 0 else 0
    return fn(ql, kv_for_heads(kl, h, kvh, rank, extent, first), kv_for_heads(vl, h, kvh, rank, extent, first), 0)


def on_attention_shards(fn: Callable, q, k, v, *, query: bool = True):
    """``fn(q, k, v, t0)`` on each rank's piece of attention over DTensor
    (B, T, H, hd) ``q`` and (B, S, KV, hd) ``k``, ``v`` (DTensors, or plain
    tensors that every rank holds whole), in the reference's layout
    (`layout_of(q, BY_HEADS, BY_SEQUENCE)`; ``t0`` is the piece's first
    query row):

    - heads, where the batch and H divide their mesh extents: each rank
      takes its H/m q heads and the kv heads they read (`kv_for_heads`),
      from its own kv heads where KV divides m too, else from k and v whole
      on the model axis;
    - the query sequence, where H does not divide m and T does (and
      ``query``): each rank takes its T/m rows of q and k, v whole along S.

    The output has q's layout.  q's gradient is sharded as q, that of a k
    or v held whole on the model axis is partial there.  Where neither
    layout fits, or without a resolver, the work runs on (batch, heads)
    shards (`on_local_shards`), the heads gathered unless H and KV both
    divide."""
    from torch.distributed.tensor import Replicate, Shard

    layout = layout_of(q, BY_HEADS, BY_SEQUENCE)
    if layout is None or (layout[0] == 1 and not query):
        return on_local_shards(lambda *qkv: fn(*qkv, 0), (q, k, v), [(0, 2)] * 3, (q.shape[2], k.shape[2]),
                               [(0, 2)])
    mode, qp = layout
    mesh = q.device_mesh
    split = [i for i, p in enumerate(qp) if p.is_shard(2 if mode == 0 else 1)]
    rank, extent = block_of(mesh, split)
    h, kvh = q.shape[2], k.shape[2]
    own_kv = mode == 0 and kvh % extent == 0
    kvp = tuple(Shard(0) if p.is_shard(0) else Shard(2) if own_kv and i in split else Replicate()
                for i, p in enumerate(qp))
    ql = local_of(q, mesh, qp)
    kl, vl = (local_of(x, mesh, kvp, split) for x in (k, v))
    if mode == 0:
        return global_of(heads_step(fn, ql, kl, vl, h, kvh, rank, extent), mesh, qp)
    return global_of(fn(ql, kl, vl, rank * (q.shape[1] // extent)), mesh, qp)


def on_local_shards(fn: Callable, xs: Sequence, dims: Sequence[Tuple[Optional[int], ...]],
                    heads: Sequence[int], out_dims: Sequence[Tuple[Optional[int], ...]]):
    """``fn(*local tensors)`` on each rank's shard of ``xs``, for work that is
    independent across the batch and the heads (attention, the scans), and,
    for the scans, across the value side of each head: the counterpart of
    `local_map` over a (batch, heads, value) layout.

    ``dims[j]`` is (batch dim, head dim) of ``xs[j]``, or (batch dim, head
    dim, value dim) for a tensor of the value side (None where it has
    none): a dim that the work does not contract, such as the V of the wkv
    scan's v, state and y, or the P of the SSM's xs, state and y.  The
    DTensors among ``xs`` with a batch dim and a head dim (with a batch dim,
    where none has heads) decide the layout, for each mesh dim:

    - `Shard` of the batch, where every one of them shards its batch there;
    - `Shard` of the heads, where every one shards its heads there and
      every count in ``heads`` divides by the extent of all mesh dims that
      shard heads (so each rank's q heads keep their kv head);
    - `Shard` of the value dim, where every one of them that has a value dim
      shards it there (the reference's layout where the heads do not divide
      the model axis and the head dim does: rwkv6-3b's 40 heads and
      hymba-1.5b's 25 on 16 ranks) and each value-side tensor's value dim
      divides by the extent of the mesh dims that shard it: the value-side
      tensors keep their shard, the others (the key side: wkv's r, k, w,
      u; the SSM's dt, a, B, C) are gathered whole;
    - else `Replicate`: a layout that shards another dim (a sequence, a
      head's features where no value dim is named, heads that do not
      divide) or is partial is gathered first, an explicit redistribute.

    A plain tensor among ``xs`` is one that every rank holds whole, and each
    rank takes its slice; None passes through.  The outputs (one, or a
    tuple) are DTensors with ``out_dims``' dims sharded as the layout says.
    Every step is differentiable; the gradient of a DTensor that every rank
    of a sharded mesh dim holds whole (a parameter beside the batch, a
    tensor without heads beside the heads, the key side beside the value
    dim) is partial there, each rank's shard's part of the sum."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = next(x.device_mesh for x in xs if is_dtensor(x))
    n = len(mesh.shape)
    dims = [tuple(d) + (None,) * (3 - len(d)) for d in dims]
    out_dims = [tuple(d) + (None,) * (3 - len(d)) for d in out_dims]

    def placements(x):
        return tuple(x.placements) if is_dtensor(x) else (Replicate(),) * n

    deciding = [(placements(x), bd, hd, vd) for x, (bd, hd, vd) in zip(xs, dims) if is_dtensor(x)
                and bd is not None and (hd is not None or all(h is None for _, h, _ in dims))]
    valued = [(p, vd) for p, _, _, vd in deciding if vd is not None]
    layout = []
    for i in range(n):
        if deciding and all(p[i].is_shard(bd) for p, bd, _, _ in deciding):
            layout.append("batch")
        elif deciding and all(hd is not None and p[i].is_shard(hd) for p, _, hd, _ in deciding):
            layout.append("heads")
        elif valued and all(p[i].is_shard(vd) for p, vd in valued):
            layout.append("value")
        else:
            layout.append(None)

    def extent(kind):
        return math.prod(int(mesh.shape[i]) for i, o in enumerate(layout) if o == kind)

    if any(h % extent("heads") for h in heads):
        layout = [None if o == "heads" else o for o in layout]
    if any(vd is not None and x is not None and x.shape[vd] % extent("value") for x, (_, _, vd) in zip(xs, dims)):
        layout = [None if o == "value" else o for o in layout]

    def under(bd, hd, vd):
        return tuple(Shard(bd) if o == "batch" and bd is not None else Shard(hd) if o == "heads" and hd is not None
                     else Shard(vd) if o == "value" and vd is not None else Replicate() for o in layout)

    sharded = [i for i, o in enumerate(layout) if o is not None]
    out = fn(*(local_of(x, mesh, under(*d), sharded) for x, d in zip(xs, dims)))
    if isinstance(out, tuple):
        return tuple(global_of(y, mesh, under(*d)) for y, d in zip(out, out_dims))
    return global_of(out, mesh, under(*out_dims[0]))
