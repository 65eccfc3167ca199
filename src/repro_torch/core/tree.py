"""Pytrees of tensors, in the JAX package's leaf order.

`torch.utils._pytree` (what `torch.func` uses) keeps a dict's insertion
order; `jax.tree_util` sorts dict keys.  Where the order of leaves changes
a result (a sum over leaves) or a leaf's path is hashed (the sketched Pflug
controller seeds each leaf from `keystr` of its path), the engine uses
`leaves_with_path`, which flattens dicts, lists, tuples and named tuples as
JAX does and spells each path as `jax.tree_util.keystr` does.  Where order
does not matter (mapping over leaves) the port uses `torch.utils._pytree`.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.shardctx import is_dtensor

__all__ = ["leaves_with_keys", "leaves_with_path", "tree_leaves", "tree_dot", "first_leaf", "map_with_index"]


def leaves_with_keys(tree, prefix: tuple = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """[(path, leaf)] in JAX's flattening order (dict keys sorted), each
    path a tuple of the `str` of JAX's key entries: ``.field`` for a named
    tuple, ``['key']`` for a dict, ``[i]`` for a list or tuple."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves_with_keys(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for f in tree._fields for leaf in leaves_with_keys(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, x in enumerate(tree) for leaf in leaves_with_keys(x, prefix + (f"[{i}]",))]
    raise TypeError(f"not a pytree of tensors: {type(tree).__name__}")


def leaves_with_path(tree) -> List[Tuple[str, torch.Tensor]]:
    """[(keystr, leaf)] in JAX's flattening order (dict keys sorted)."""
    return [("".join(path), leaf) for path, leaf in leaves_with_keys(tree)]


def map_with_index(fn, tree, _count=None):
    """``tree`` with each leaf replaced by ``fn(j, leaf)``, j the leaf's
    index in JAX's flattening order; dicts keep their own key order."""
    count = [0] if _count is None else _count
    if isinstance(tree, torch.Tensor):
        count[0] += 1
        return fn(count[0] - 1, tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: map_with_index(fn, tree[k], count) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_index(fn, getattr(tree, f), count) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_index(fn, x, count) for x in tree)
    raise TypeError(f"not a pytree of tensors: {type(tree).__name__}")


def tree_leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_dot(a, b) -> torch.Tensor:
    """sum over leaves of <a_leaf, b_leaf> in float32, leaves in JAX's order
    (`jax.tree.reduce(jnp.add, jax.tree.map(jnp.vdot, a, b))`)."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if is_dtensor(x) or is_dtensor(y):
            d = _sharded_dot(x, y)
        else:
            d = torch.dot(x.to(torch.float32).reshape(-1), y.to(torch.float32).reshape(-1))
        total = d if total is None else total + d
    if total is None:
        raise ValueError("tree_dot of an empty pytree")
    return total


def _sharded_dot(x, y) -> torch.Tensor:
    """<x, y> in float32 of two leaves, one at least a DTensor: y in x's
    layout (a partial x summed first), each rank's dot of its shards, and
    the shards' dots summed over the mesh dims that split them.  A plain
    tensor, replicated on every rank.  On a world of one rank it is the
    plain dot, bit for bit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor

    if not is_dtensor(x):
        x, y = y, x
    placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    mesh = x.device_mesh
    x = x.redistribute(mesh, placements) if tuple(x.placements) != placements else x
    if is_dtensor(y):
        y = y.redistribute(mesh, placements) if tuple(y.placements) != placements else y
    else:
        y = distribute_tensor(y, mesh, placements, src_data_rank=None)
    d = torch.dot(x.to_local().to(torch.float32).reshape(-1), y.to_local().to(torch.float32).reshape(-1))
    if not any(p.is_shard() for p in placements):
        return d
    sums = tuple(Partial() if p.is_shard() else Replicate() for p in placements)
    return DTensor.from_local(d, mesh, sums, run_check=False).full_tensor()


def first_leaf(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty pytree")
    return leaves[0]
