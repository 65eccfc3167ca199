"""Dependency-free checkpoints of pytrees of tensors, in the JAX package's
format, so a checkpoint written by either package restores in the other.

Layout: ``<dir>/step_<N>/arrays.npz`` (leaf j as ``a<j>``) + ``tree.json``
(``{"names": [...], "step": N}``), written to a temporary directory and
renamed into place.  Leaves are in JAX's flattening order (dict keys
sorted), and a leaf's name is the `str` of each of its key entries joined
by ``/``: ``.params/['layers']/['w']`` (`core.tree.leaves_with_keys`).

numpy has no bfloat16, so a bf16 leaf is written as float32, which holds
it exactly; the JAX package's own bf16 arrays (ml_dtypes, stored as 2-byte
void records) are read back by their bits.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_keys, map_with_index

__all__ = ["save", "restore", "latest_step"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _names_and_leaves(tree: Any):
    flat = leaves_with_keys(tree)
    return ["/".join(path) for path, _ in flat], [leaf for _, leaf in flat]


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.to(torch.float32)
    return leaf.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2 and like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)


def save(directory: str, step: int, tree: Any) -> str:
    names, leaves = _names_and_leaves(tree)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **{f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)})
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"names": names, "step": step}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def restore(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure, dtypes and devices of ``like``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    names, _ = _names_and_leaves(like)
    if names != meta["names"]:
        raise ValueError("checkpoint tree mismatch:\n saved: %s\n expected: %s" % (meta["names"][:5], names[:5]))
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return map_with_index(lambda j, leaf: _to_tensor(data[f"a{j}"], leaf), like)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory) if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None
