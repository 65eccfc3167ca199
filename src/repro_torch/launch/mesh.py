"""Device meshes: the production ("data", "model") mesh of the LM path and
the sweep engine's ("cells", "replicas") mesh.

The port of `repro/launch/mesh.py`, over `torch.distributed`'s DeviceMesh.
A mesh spans the ranks of the default process group (one process per
device, started by torchrun or spawned).  Without an initialised process
group nothing here creates one: a one-process caller gets `HostMesh`, a
1 x 1 stand-in with the same axis names that the sweep and the sharding
rules treat as one device, so a run without a mesh costs nothing new and
computes the same bits as before.

Every function that reads a mesh takes a DeviceMesh, a `HostMesh`, or any
object with ``axis_names`` and a ``shape`` mapping of axis name to size
(a `jax.sharding.Mesh` has both), through `axis_names` and `axis_sizes`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A one-device mesh with named axes of size 1, used when no process
    group is initialised: no process group, no DTensor, no collective."""

    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {a: 1 for a in self.axis_names}


def is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def axis_names(mesh) -> Tuple[str, ...]:
    if is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: extent}, in the mesh's axis order."""
    if is_device_mesh(mesh):
        return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in axis_names(mesh)}


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh_device_type() -> str:
    """The DeviceMesh device type of the default group's backend: NCCL
    meshes hold CUDA tensors, gloo meshes CPU tensors."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


# (ranks, shape, names, device type, process group) -> DeviceMesh: a mesh
# builds its process groups once, and every sweep of a grid shape reuses it.
_MESHES: dict = {}


def _device_mesh(ranks: Sequence[int], shape: Tuple[int, ...], names: Tuple[str, ...]):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    key = (tuple(ranks), tuple(shape), tuple(names), _mesh_device_type(), id(dist.group.WORLD))
    if key not in _MESHES:
        grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(shape)
        _MESHES[key] = DeviceMesh(key[3], grid, mesh_dim_names=names)
    return _MESHES[key]


def sweep_mesh_shape(n_devices: int, n_cells: int, n_replicas: int) -> tuple[int, int]:
    """The (cells, replicas) mesh shape for a G-cell x R-replica sweep grid.

    Picks the largest divisor of ``n_devices`` that does not exceed
    ``n_cells`` for the cells axis and gives the rest to replicas — so a
    480-device slice dispatching the 15-cell x 32-replica baseline grid
    forms a (15, 32) mesh (every device busy), while a grid with more cells
    than devices degenerates to the historical all-cells 1-D layout
    (``(n_devices, 1)``).  Grids are padded up to mesh-shape multiples at
    dispatch (cells with inert empty rows, replicas by repeating a key);
    padded lanes are sliced off before results are returned, so any shape
    returned here is *correct* — the heuristic only decides utilization.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_cells < 1 or n_replicas < 1:
        raise ValueError(
            f"grid must be non-empty, got n_cells={n_cells} n_replicas={n_replicas}"
        )
    mc = max(d for d in range(1, n_devices + 1) if n_devices % d == 0 and d <= n_cells)
    return mc, n_devices // mc


def make_sweep_mesh(n_cells: int, n_replicas: int, *, devices: Optional[Sequence[int]] = None):
    """2-D ``("cells", "replicas")`` mesh over the ranks of the default
    process group (``devices``: a list of global ranks, default all of
    them), shaped by ``sweep_mesh_shape``.  Without a process group it is
    the 1 x 1 `HostMesh`."""
    n_world, _ = world()
    ranks = list(range(n_world)) if devices is None else [int(d) for d in devices]
    mc, mr = sweep_mesh_shape(len(ranks), n_cells, n_replicas)
    if n_world == 1 and not _initialised():
        if ranks != [0]:
            raise ValueError(f"no process group is initialised; a sweep mesh over ranks {ranks} needs one")
        return HostMesh(("cells", "replicas"))
    return _device_mesh(ranks, (mc, mr), ("cells", "replicas"))


def _initialised() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over the default process group, which
    must hold exactly 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    n_world, _ = world()
    if n_world != need or not _initialised():
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs a process group of {need} ranks; "
                         f"the world has {n_world}" + ("" if _initialised() else " (no process group is initialised)"))
    return _device_mesh(range(need), shape, axes)


def make_host_mesh():
    """Degenerate 1-device mesh with the production axis names — used by CPU
    integration tests so the same sharded code paths run unchanged.  It is
    a DeviceMesh in a world of one rank and the `HostMesh` stand-in without
    a process group."""
    n_world, _ = world()
    if not _initialised():
        return HostMesh(("data", "model"))
    if n_world != 1:
        raise ValueError(f"a host mesh is one device; the world has {n_world} ranks")
    return _device_mesh([0], (1, 1), ("data", "model"))


def data_axes(mesh) -> tuple:
    """The mesh axes that carry data parallelism (= the paper's n workers)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def n_workers(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def mesh_ranks(mesh) -> list:
    """The global ranks of the mesh's devices, row-major over its axes."""
    if not is_device_mesh(mesh):
        return [0]
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def flat_index(mesh) -> int:
    """This rank's row-major position on the mesh (the block of a lane axis
    sharded over all its axes, major axis first); 0 on a stand-in."""
    if not is_device_mesh(mesh):
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    idx = 0
    for c, s in zip(coord, mesh.shape):
        idx = idx * int(s) + int(c)
    return idx
