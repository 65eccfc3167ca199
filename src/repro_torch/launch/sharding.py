"""Sharding rules: FSDP (+TP) parameter layout and batch/cache specs, over
DTensor.

The port of `repro/launch/sharding.py`.  Name-based rules (MaxText-style
logical axes, with divisibility fallback): every parameter leaf name maps to
a tuple of logical dims; logical dims map to mesh axes; any dim whose size
is not divisible by its mesh-axis extent falls back to replication (e.g.
hymba's 25 q-heads or paligemma's single kv head on a 16-way model axis).

The same leaf-name rules apply to optimizer moments and the Pflug
controller's prev_grad (they mirror the params pytree), so the whole train
state inherits the FSDP+TP layout without extra code.  The port stores every
parameter leaf under the reference's name and in its layout
(`checkpoint/convert.py`), so the rules apply unchanged.

The rules are pure functions of the mesh's axis names and sizes
(`MeshAxes`), and a spec is the port's own partition-spec tuple: one entry
per tensor dim, None (replicated), a mesh axis name, or a tuple of names
(the dim split over several axes, major first), as `jax.sharding.
PartitionSpec` holds them.  `to_placements` turns a spec into DTensor
placements on a DeviceMesh; `place_spanning` puts a tensor that every
rank holds whole under one.  On the `launch.mesh.HostMesh` stand-in,
placing is a no-op and nothing becomes a DTensor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import MappingKey, tree_map_with_path

from repro_torch.launch.mesh import axis_names, axis_sizes, is_device_mesh

# logical dimension -> mesh axes (resolved against the active mesh's names)
LOGICAL = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "experts": ("model",),
    "none": None,
}

# parameter leaf name -> logical dims per trailing dimension (the stacked
# layer axis, when present, is always unsharded and handled separately)
PARAM_RULES: Dict[str, Tuple[str, ...]] = {
    # embeddings
    "embed": ("tp", "fsdp"),  # (V, D) — vocab on tp, d_model FSDP on data
    "lm_head": ("fsdp", "tp"),  # (D, V)
    # attention
    "wq": ("fsdp", "tp", "none"),  # (D, H, hd)
    "wk": ("fsdp", "tp", "none"),
    "wv": ("fsdp", "tp", "none"),
    "wo": ("tp", "none", "fsdp"),  # (H, hd, D)
    "bq": ("tp", "none"),
    "bk": ("tp", "none"),
    "bv": ("tp", "none"),
    # mlp
    "w_gate": ("fsdp", "tp"),  # (D, F)   [moe: (E, D, F) handled by ndim]
    "w_in": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),  # (F, D)
    "w_recept": ("fsdp", "tp"),
    # moe
    "router": ("fsdp", "tp"),  # (D, E)
    # rwkv time-mix
    "wr": ("fsdp", "tp", "none"),
    "wg": ("fsdp", "tp", "none"),
    "decay_a1": ("fsdp", "none"),
    "decay_a2": ("none", "tp", "none"),
    "decay_w0": ("tp", "none"),
    "bonus_u": ("tp", "none"),
    "ln_out": ("tp", "none"),
    "mu": ("none", "fsdp"),
    "mu_c": ("none", "fsdp"),
    # hymba ssm branch
    "w_xs": ("fsdp", "tp", "none"),
    "w_dt": ("fsdp", "tp"),
    "w_b": ("fsdp", "tp", "none"),
    "w_c": ("fsdp", "tp", "none"),
    "w_os": ("tp", "none", "fsdp"),
    "skip_d": ("tp", "none"),
    # small/replicated
    "scale": ("none",),
    "dt_bias": ("none",),
    "a_log": ("none",),
    "norm_attn": ("none",),
    "norm_ssm": ("none",),
}

# Alternative layouts tried (strictly — every named dim must divide) before
# the lenient PARAM_RULES fallback.  E.g. RWKV-6's 40 heads don't divide a
# 16-way model axis, but head_dim 64 does: shard the head_dim instead so the
# projections stay tensor-parallel.
PARAM_ALTS: Dict[str, list] = {
    "wq": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "wk": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "wv": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "wo": [("tp", "none", "fsdp"), ("none", "tp", "fsdp")],
    "wr": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "wg": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "w_xs": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "w_os": [("tp", "none", "fsdp"), ("none", "tp", "fsdp")],
    "w_b": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "w_c": [("fsdp", "tp", "none"), ("fsdp", "none", "tp")],
    "decay_a2": [("none", "tp", "none"), ("none", "none", "tp")],
    "decay_w0": [("tp", "none"), ("none", "tp")],
    "bonus_u": [("tp", "none"), ("none", "tp")],
    "ln_out": [("tp", "none"), ("none", "tp")],
}

# MoE expert tensors are rank-3 with leading experts dim
MOE_RULES = {
    "w_gate": ("tp", "fsdp", "none"),  # (E, D, F)
    "w_in": ("tp", "fsdp", "none"),
    "w_out": ("tp", "none", "fsdp"),  # (E, F, D)
}

# KV-cache alternatives (strict, tried in order): shard kv heads when they
# divide |model| (classic TP); otherwise shard the cache SEQUENCE dim — for
# GQA archs with few kv heads (qwen1.5-110b kv=8, llama kv=8) this is what
# keeps a 32k-deep cache on-chip (§Perf pair 3).
CACHE_ALTS: Dict[str, list] = {
    "k": [("none", "batch", "none", "tp", "none"),
          ("none", "batch", "tp", "none", "none")],
    "v": [("none", "batch", "none", "tp", "none"),
          ("none", "batch", "tp", "none", "none")],
}

CACHE_RULES: Dict[str, Tuple[str, ...]] = {
    # stacked (L, B, S, KV, hd)
    "k": ("none", "batch", "none", "tp", "none"),
    "v": ("none", "batch", "none", "tp", "none"),
    # rwkv: (L, B, D) / (L, B, H, K, V)
    "x_att": ("none", "batch", "none"),
    "x_ffn": ("none", "batch", "none"),
    "s": ("none", "batch", "tp", "none", "none"),
    # hymba ssm state (L, B, H, N, P)
    "ssm": ("none", "batch", "tp", "none", "none"),
}

BATCH_RULES: Dict[str, Tuple[str, ...]] = {
    "tokens": ("batch", "none"),
    "targets": ("batch", "none"),
    "token": ("batch", "none"),
    "patches": ("batch", "none", "none"),
    "frames": ("batch", "none", "none"),
}


Spec = Tuple[Any, ...]


class MeshAxes(NamedTuple):
    """A mesh's axis names and their sizes: all the rules read of a mesh."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @classmethod
    def of(cls, mesh) -> "MeshAxes":
        if isinstance(mesh, MeshAxes):
            return mesh
        sizes = axis_sizes(mesh)
        return cls(axis_names(mesh), tuple(sizes[a] for a in axis_names(mesh)))

    def size(self, axis: str) -> int:
        return self.sizes[self.names.index(axis)]


def _resolve(logical: str, axes: MeshAxes) -> Optional[Tuple[str, ...]]:
    mesh_axes = LOGICAL[logical]
    if mesh_axes is None:
        return None
    present = tuple(a for a in mesh_axes if a in axes.names)
    return present or None


def _axis_extent(mesh_axes: Optional[Tuple[str, ...]], axes: MeshAxes) -> int:
    if not mesh_axes:
        return 1
    return math.prod(axes.size(a) for a in mesh_axes)


def _spec_from_dims(dims, shape, axes: MeshAxes, strict: bool) -> Optional[Spec]:
    dims = list(dims)
    # stacked layer axis (params): rank = len(rule)+1 -> prepend replicated
    while len(dims) < len(shape):
        dims = ["none"] + dims
    if len(dims) > len(shape):  # e.g. biases reusing a longer rule
        dims = dims[-len(shape):]
    out = []
    for size, logical_dim in zip(shape, dims):
        mesh_axes = _resolve(logical_dim, axes)
        if mesh_axes and size % _axis_extent(mesh_axes, axes) == 0:
            out.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        elif strict and mesh_axes:
            return None
        else:
            out.append(None)
    return tuple(out)


def spec_for(name: str, shape: Tuple[int, ...], axes: MeshAxes, rules: Dict[str, Tuple[str, ...]]) -> Spec:
    """The spec of a leaf: alternatives first (all-dims-strict), then the
    lenient per-dim fallback of the primary rule."""
    logical = rules.get(name)
    if logical is None:
        return ()
    for alt in PARAM_ALTS.get(name, []):
        spec = _spec_from_dims(alt, shape, axes, strict=True)
        if spec is not None:
            return spec
    return _spec_from_dims(logical, shape, axes, strict=False)


def _param_spec(keys: Sequence[str], shape: Tuple[int, ...], axes: MeshAxes) -> Spec:
    """The spec of the parameter leaf at dict-key path ``keys``."""
    if not keys:
        return ()
    name = keys[-1]
    rules = PARAM_RULES
    # MoE expert tensors (under the 'moe' subtree) carry a leading experts dim.
    if "moe" in keys and name in MOE_RULES:
        rules = {**PARAM_RULES, name: MOE_RULES[name]}
    return spec_for(name, shape, axes, rules)


def _batch_spec(name: Optional[str], shape: Tuple[int, ...], axes: MeshAxes) -> Spec:
    """The spec of a batch or cache leaf: the cache alternatives first."""
    for alt in CACHE_ALTS.get(name, []):
        s = _spec_from_dims(alt, shape, axes, strict=True)
        if s is not None:
            return s
    rules = {**BATCH_RULES, **CACHE_RULES}
    if name in rules:
        return spec_for(name, shape, axes, rules)
    return ()


def _dict_keys(path) -> list:
    return [p.key for p in path if isinstance(p, MappingKey)]


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` for ``spec``: one per mesh dim,
    `Shard(d)` where tensor dim d is split over that mesh axis, else
    `Replicate()`.  A dim over two axes, e.g. ("pod", "data"), is
    `Shard(d)` on both mesh dims; DTensor splits it over the first mesh
    dim first, the pod-major order of a JAX PartitionSpec."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        entry = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in entry]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in dims:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two tensor dims in spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Named:
    """A spec on a mesh: the counterpart of `jax.sharding.NamedSharding`."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def param_shardings(params: Any, mesh):
    """`Named` shardings for a params-like tree (works on any leaves with a
    ``shape``: tensors, DTensors, `torch.Size`-holding stand-ins; a None
    leaf, such as a sync `TrainState`'s ``exec_async``, stays None)."""
    axes = MeshAxes.of(mesh)
    return tree_map_with_path(lambda path, leaf: None if leaf is None else Named(
        mesh, _param_spec(_dict_keys(path), tuple(leaf.shape), axes)), params)


def named(mesh, *dims: str) -> Named:
    """`Named` from logical dim names (no divisibility check)."""
    axes = MeshAxes.of(mesh)
    out = []
    for d in dims:
        mesh_axes = _resolve(d, axes)
        out.append(mesh_axes if mesh_axes and len(mesh_axes) > 1 else (mesh_axes[0] if mesh_axes else None))
    return Named(mesh, tuple(out))


def batch_shardings(batch: Any, mesh):
    """`Named` shardings for a batch or decode-cache tree, by leaf name:
    the cache alternatives (kv heads on the model axis, else the cache's
    sequence) first, then the batch and cache rules; others replicated."""
    axes = MeshAxes.of(mesh)

    def spec(path, leaf):
        keys = _dict_keys(path)
        return Named(mesh, _batch_spec(keys[-1] if keys else None, tuple(leaf.shape), axes))

    return tree_map_with_path(spec, batch)


def replicated(mesh) -> Named:
    return Named(mesh, ())


def place_spanning(x: torch.Tensor, sharding: Named):
    """Put ``x``, which every rank of the mesh holds whole, under
    ``sharding``: each rank keeps its own slice, with no broadcast (as
    `distribute_tensor` with ``src_data_rank=None``, but with no copy where
    the slice is the whole tensor, as on a world of one rank).  The
    counterpart of the reference's `place_spanning` (every process holds
    the full host array).  On a `HostMesh` ``x`` is returned as it is; a
    DTensor is redistributed."""
    if not is_device_mesh(sharding.mesh):
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = sharding.placements
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == placements else x.redistribute(sharding.mesh, placements)
    if any(p.is_shard() and x.shape[p.dim] % int(n) for p, n in zip(placements, sharding.mesh.shape)):
        return distribute_tensor(x, sharding.mesh, placements, src_data_rank=None)  # an uneven split
    local = _local_slice(x, sharding.mesh, placements)
    if local.numel() < x.numel():  # a shard of its own, so that the whole host tensor can be freed
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, placements, run_check=False, shape=x.shape, stride=x.stride())


def _local_slice(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``x`` under ``placements`` (even splits, as the
    rules make them), a view: a dim split over several mesh dims is split
    by the first of them first."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            n = int(mesh.shape[i])
            size = x.shape[p.dim] // n
            x = x.narrow(p.dim, coord[i] * size, size)
    return x



def activation_resolver(mesh):
    """Resolver for `repro_torch.shardctx.activation_sharding`: logical
    activation dims -> `Named`.  Default: per-dim divisibility fallback.
    With strict=True, returns None unless EVERY requested dim is
    satisfiable (used by constrain_alt to pick among alternative layouts)."""
    axes = MeshAxes.of(mesh)

    def resolve(logical: Tuple[str, ...], shape: Tuple[int, ...], strict: bool = False):
        if len(logical) != len(shape):
            return None
        spec = _spec_from_dims(logical, shape, axes, strict)
        return None if spec is None else Named(mesh, spec)

    return resolve


def place_state(tree: Any, mesh):
    """Place a train-state-like tree by the parameter rules: every tensor
    leaf of rank >= 1 under `param_shardings` (params, optimizer moments and
    Pflug's prev_grad mirror the params tree, so the leaf names pick their
    rules); scalars (step counts, k, the renewal clock) stay plain tensors,
    which every rank holds whole.  A no-op on a `HostMesh`."""
    if not is_device_mesh(mesh):
        return tree
    axes = MeshAxes.of(mesh)

    def leaf(path, x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        return place_spanning(x, Named(mesh, _param_spec(_dict_keys(path), tuple(x.shape), axes)))

    return tree_map_with_path(leaf, tree)


def place_batch(tree: Any, mesh):
    """Place a batch or decode-cache tree by `batch_shardings`; scalars
    (a decode position) stay plain.  A no-op on a `HostMesh`."""
    if not is_device_mesh(mesh):
        return tree
    axes = MeshAxes.of(mesh)

    def leaf(path, x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        keys = _dict_keys(path)
        return place_spanning(x, Named(mesh, _batch_spec(keys[-1] if keys else None, tuple(x.shape), axes)))

    return tree_map_with_path(leaf, tree)


def gathered(tree: Any):
    """Every DTensor leaf of ``tree`` as the whole plain tensor
    (`DTensor.full_tensor`); other leaves as they are."""
    from torch.utils._pytree import tree_map

    from repro_torch.shardctx import is_dtensor

    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def gathered_scalars(tree: Any):
    """Every rank-0 DTensor leaf of ``tree`` as a plain tensor; the rest as
    it is (what a step's controller bookkeeping leaves in its state)."""
    from torch.utils._pytree import tree_map

    from repro_torch.shardctx import is_dtensor

    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) and x.ndim == 0 else x, tree)


@contextlib.contextmanager
def mesh_context(mesh):
    """Run a sharded model under ``mesh``: the activation resolver installed
    (`shardctx.activation_sharding`, as the reference's launch code does)
    and plain tensors that meet a DTensor taken as replicated (DTensor's
    `implicit_replication`: masks, positions and the straggler draw are
    made on every rank whole).  On a `HostMesh` it does nothing."""
    if not is_device_mesh(mesh):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.shardctx import activation_sharding

    with activation_sharding(activation_resolver(mesh)), implicit_replication():
        yield
