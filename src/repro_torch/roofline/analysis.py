"""Roofline analysis of one traced step on the H100.

The port of `repro/roofline/analysis.py`.  Three terms per (arch x shape x
mesh), all per-rank seconds:

    compute_s    = flops / peak_FLOP/s
    memory_s     = bytes accessed / HBM bandwidth
    collective_s = collective bytes / link bandwidth

The reference reads flops and bytes from XLA's `cost_analysis` of the
compiled per-device program and parses collective bytes from its HLO.  The
port has no compiled program: `count_step` runs the step once under a
counting `TorchDispatchMode` and sums, over every op a rank runs,

- flops, from `torch.utils.flop_counter`'s formulas (the products, and the
  two kernels' custom ops, whose formulas `kernels/*/ops.py` register);
- bytes accessed, each op's input and output bytes, views and metadata ops
  left out.  Eager PyTorch fuses nothing, so this is what the step moves
  through memory as the port runs it, not what a fusing compiler would;
- collective bytes, the result bytes of each `_c10d_functional` and `c10d`
  op by type: the bytes leaving this rank per op, the reference's proxy.

Only ops whose tensor arguments are plain (local) tensors are counted: a
DTensor op is passed on to DTensor (the mode returns NotImplemented), which
runs each rank's local ops and its collectives, and those are counted.  So
each rank's program counts once: counting the DTensor op too would add the
global product to the local one.  DTensor's sharding propagation runs the op
on fake global-shape arguments to learn the output's metadata; those runs
are not counted either.  An eager trace runs every layer (and remat's
recompute in the backward), so no trip-count correction is needed.

Hardware constants: NVIDIA H100 SXM5 80GB (data sheet): 989e12 FLOP/s dense
bf16 on the tensor cores (the figure `train_mfu` uses), 3.35e12 B/s HBM3.
The link term is 50e9 B/s, one 400 Gb/s NDR InfiniBand port per GPU: every
axis of the (16, 16) production mesh crosses nodes, since a model axis of
16 spans two 8-GPU nodes, so the slowest hop of a collective is the NIC.
NVLink 4 (450 GB/s each way inside a node) would bound only a mesh axis
that stays inside one node.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.utils._pytree import MappingKey, tree_flatten_with_path, tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12  # dense bf16 / GPU
    hbm_bw: float = 3.35e12  # bytes/s / GPU
    ici_bw: float = 50e9  # bytes/s / GPU: one 400 Gb/s NDR port


DTYPE_BYTES = {
    torch.float64: 8, torch.float32: 4, torch.float16: 2, torch.bfloat16: 2,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int64: 8, torch.int32: 4, torch.int16: 2, torch.int8: 1,
    torch.uint64: 8, torch.uint32: 4, torch.uint16: 2, torch.uint8: 1,
    torch.bool: 1, torch.complex64: 8, torch.complex128: 16,
}

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# op-name fragment -> collective type (point-to-point and rooted transfers
# count as permutes: data moved to named peers)
_COLLECTIVE_KIND = (
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("broadcast", "collective-permute"), ("send", "collective-permute"), ("recv", "collective-permute"),
    ("p2p", "collective-permute"), ("scatter", "collective-permute"), ("gather", "collective-permute"),
)
# communication namespaces' ops that move no data
_NO_DATA = {"wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier"}

# ops that touch no tensor data (answers about metadata) or only allocate
_METADATA = {
    "aten::is_contiguous", "aten::sym_is_contiguous", "aten::is_strides_like_format",
    "aten::is_non_overlapping_and_dense", "aten::size", "aten::sym_size", "aten::stride",
    "aten::sym_stride", "aten::storage_offset", "aten::sym_storage_offset", "aten::numel",
    "aten::sym_numel", "aten::dim", "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::set_", "aten::resize_",
    "aten::_local_scalar_dense", "prim::device", "prim::layout",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, t.element_size())


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _collective_kind(name: str) -> str | None:
    """The reference's collective type of op ``name`` ("ns::op"), None for
    an op of no communication namespace; raises for one it cannot place."""
    ns, _, op = name.partition("::")
    if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    if op in _NO_DATA:
        return "none"
    for fragment, kind in _COLLECTIVE_KIND:
        if fragment in op:
            return kind
    raise ValueError(f"count_step: op {name} is a collective of no known type")


# Depth of DTensor metadata work in progress (sharding propagation, shard
# sizes): its ops are not the rank's work.
_metadata_depth = 0
_metadata_patched = False


def _as_metadata(fn, memo: dict | None = None):
    """``fn`` run as DTensor metadata work: its ops go uncounted.  With
    ``memo``, each distinct call runs once, on real tensors under a
    `FakeTensorMode`."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def run(*args, **kwargs):
        global _metadata_depth
        key = (args, tuple(sorted(kwargs.items())))
        if memo is not None and key in memo:
            return memo[key]
        _metadata_depth += 1
        try:
            with unset_fake_temporarily() if memo is not None else contextlib.nullcontext():
                out = fn(*args, **kwargs)
        finally:
            _metadata_depth -= 1
        if memo is not None:
            memo[key] = out
        return out

    return run


@contextlib.contextmanager
def dtensor_metadata_uncounted():
    """Mark DTensor's metadata work while a counter is on, so that its ops
    are not counted: the fake runs of sharding propagation
    (`ShardingPropagator._propagate_tensor_meta*`, which run each op on
    global-shape stand-ins) and `_StridedShard.local_shard_size_and_offset`
    (which computes a shard's indices with `torch.arange(...).tolist()`).
    The second runs outside any `FakeTensorMode` (a host read of a fake
    tensor raises) and is memoised: a pure function of a placement and
    sizes, which DTensor asks the same questions for every layer."""
    global _metadata_patched
    if _metadata_patched:  # nested: the outer context has patched
        yield
        return
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
             if n in ShardingPropagator.__dict__]
    if not names:
        raise RuntimeError(f"count_step: torch {torch.__version__}'s ShardingPropagator has no tensor-meta "
                           "propagation to leave out of the count")
    patches = [(ShardingPropagator, n, ShardingPropagator.__dict__[n], None) for n in names]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in strided.__dict__:
        patches.append((strided, "local_shard_size_and_offset", strided.__dict__["local_shard_size_and_offset"], {}))
    for cls, n, fn, memo in patches:
        setattr(cls, n, _as_metadata(fn, memo))
    _metadata_patched = True
    try:
        yield
    finally:
        _metadata_patched = False
        for cls, n, fn, _ in patches:
            setattr(cls, n, fn)


class StepCounter(TorchDispatchMode):
    """Counts what each rank's program does, as `count_step` describes, and
    tallies the bytes of live storage: the storages of the tensors passed to
    `track` and of every op's outputs, each counted from its first sight to
    its collection (`peak_bytes`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {c: 0.0 for c in COLLECTIVES}
        self.kernel_calls = {"flash_attention": 0, "wkv6": 0}  # the kernels' custom ops, run or faked
        self.live = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}

    def track(self, tree) -> None:
        """Add the storages of the tensors in ``tree`` (a DTensor's local
        shard) to the live tally."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            self._hold(t._local_tensor if isinstance(t, DTensor) else t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        inputs = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in inputs):
            return NotImplemented  # DTensor runs the local ops, which come back here
        name = func._schema.name
        if _metadata_depth or name in _METADATA or func.is_view:
            return func(*args, **kwargs)
        kind = _collective_kind(name)
        if name.startswith("repro_torch::"):
            self.kernel_calls[name.partition("::")[2]] += 1
        packet = func._overloadpacket
        if kind is None and packet not in flop_registry:  # a composite op: count what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outputs = _tensors(out)
        if kind != "none":
            self.bytes += sum(_nbytes(t) for t in inputs) + sum(_nbytes(t) for t in outputs)
        if kind not in (None, "none"):
            self.collectives[kind] += float(sum(_nbytes(t) for t in outputs))
        elif packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        for t in outputs:
            self._hold(t)
        return out

    def cost(self) -> Dict[str, Any]:
        coll = dict(self.collectives)
        coll["total"] = float(sum(coll.values()))
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes), "collectives": coll,
                "peak_bytes": self.peak_bytes, "kernel_calls": dict(self.kernel_calls)}


def count_step(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under a `StepCounter` and return
    {"flops", "bytes accessed", "collectives" (the five `COLLECTIVES` types
    and "total", bytes), "peak_bytes", "kernel_calls"}, per rank.
    ``peak_bytes`` is the peak of live storage, the arguments' included;
    ``kernel_calls`` counts the calls of the kernels' custom ops."""
    with dtensor_metadata_uncounted(), StepCounter() as counter:
        counter.track((args, kwargs))
        fn(*args, **kwargs)
    return counter.cost()


# ---------------------------------------------------------------- model flops


def count_params(params_shapes: Any):
    """(total, non_expert, expert_total, expert_dim) from a params tree of
    tensors (fake or real).  MoE expert tensors are identified by the 'moe'
    path segment; model_flops discounts them by top_k / n_experts."""
    flat = tree_flatten_with_path(params_shapes)[0]
    total = 0
    expert_total = 0
    expert_dim = 0
    for path, leaf in flat:
        keys = [p.key for p in path if isinstance(p, MappingKey)]
        n = int(np.prod(leaf.shape))
        total += n
        if "moe" in keys and keys[-1] != "router":
            expert_total += n
            # expert dim is the first non-layer axis
            expert_dim = leaf.shape[1] if len(leaf.shape) == 4 else leaf.shape[0]
    return total, total - expert_total, expert_total, expert_dim


def model_flops(cfg, params_shapes, tokens: int, kind: str) -> float:
    """6*N*D (train) or 2*N*D (forward-only), with N = active params for MoE."""
    total, non_expert, expert_total, expert_dim = count_params(params_shapes)
    if cfg.n_experts:
        active = non_expert + expert_total * cfg.moe_top_k / max(cfg.n_experts, 1)
    else:
        active = total
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens


# ------------------------------------------------------------------- summary


def roofline_terms(
    cost: Dict[str, float],
    coll_bytes: float,
    hw: HW = HW(),
) -> Dict[str, float]:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / hw.peak_flops
    memory_s = byts / hw.hbm_bw
    collective_s = coll_bytes / hw.ici_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["flops"] = flops
    terms["bytes_accessed"] = byts
    terms["collective_bytes"] = coll_bytes
    return terms
