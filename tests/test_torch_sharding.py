"""The port's sharding rules, meshes and sharding context, with no process.

- Every parameter leaf of all ten archs' full configs (the port's tree,
  built abstractly under FakeTensorMode) gets the spec that the reference's
  `param_shardings` gives the reference's tree (`jax.eval_shape`), on
  meshes (1, 1), (2, 2), (4, 8), (16, 16) ("data", "model") and
  (2, 16, 16) ("pod", "data", "model") — JAX `AbstractMesh`es, so no
  device is needed.  Same for `batch_shardings` of every input shape's
  batch and decode cache (`launch/specs.py`), and for the activation
  resolver and `named`.
- `sweep_mesh_shape` on a grid of (devices, G, R), with its errors.
- `shardctx`'s contexts: install, restore and rejection (ref
  tests/test_podscale.py), and the mesh stand-ins that create no process
  group.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro import shardctx as jctx  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import shardctx  # noqa: E402
from repro_torch.checkpoint import convert  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.sharding import MeshAxes  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")), ((4, 8), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]

_TREES = {}


def _trees(arch):
    """(reference abstract params, port abstract params) of the full config."""
    if arch not in _TREES:
        jtree = jax.eval_shape(jax_build_model(jax_config(arch)).init, jax.random.PRNGKey(0))
        with FakeTensorMode():
            ttree = convert.init(get_config(arch), torch.Generator(), "cpu")
        _TREES[arch] = (jtree, ttree)
    return _TREES[arch]


def _flat(jtree, ttree):
    """[(path, reference leaf, port leaf)]: the same dict paths in both."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = torch.utils._pytree.tree_flatten_with_path(ttree)[0]
    jpaths = [tuple(p.key for p in path) for path, _ in jl]
    tpaths = [tuple(p.key for p in path) for path, _ in tl]
    assert sorted(jpaths) == sorted(tpaths)
    tby = dict(zip(tpaths, (x for _, x in tl)))
    return [(p, x, tby[p]) for p, (_, x) in zip(jpaths, jl)]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch, mesh):
    shape, names = mesh
    jtree, ttree = _trees(arch)
    want = jsh.param_shardings(jtree, AbstractMesh(shape, names))
    got = tsh.param_shardings(ttree, MeshAxes(names, shape))
    wflat = {tuple(p.key for p in path): s.spec for path, s in jax.tree_util.tree_flatten_with_path(want)[0]}
    gflat = {tuple(p.key for p in path): s.spec for path, s in torch.utils._pytree.tree_flatten_with_path(got)[0]}
    n_sharded = 0
    for path, jleaf, tleaf in _flat(jtree, ttree):
        assert tuple(tleaf.shape) == tuple(jleaf.shape), path
        assert gflat[path] == tuple(wflat[path]), (path, gflat[path], wflat[path])
        n_sharded += any(e is not None for e in gflat[path])
    if shape != (1, 1):
        assert n_sharded > 0


def _batches(arch, shape_name):
    jcfg, cfg = jax_config(arch), get_config(arch)
    return jspecs.input_specs(jcfg, JSHAPES[shape_name]), tspecs.input_specs(cfg, INPUT_SHAPES[shape_name])


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_match_the_reference(arch, mesh):
    shape, names = mesh
    for shape_name in INPUT_SHAPES:
        jb, tb = _batches(arch, shape_name)
        want = jsh.batch_shardings(jb, AbstractMesh(shape, names))
        got = tsh.batch_shardings(tb, MeshAxes(names, shape))
        wflat = {tuple(p.key for p in path): s.spec for path, s in jax.tree_util.tree_flatten_with_path(want)[0]}
        gflat = {tuple(p.key for p in path): s.spec for path, s in torch.utils._pytree.tree_flatten_with_path(got)[0]}
        assert sorted(wflat) == sorted(gflat), shape_name
        for path in wflat:
            assert gflat[path] == tuple(wflat[path]), (shape_name, path, gflat[path], wflat[path])


LOGICAL_CASES = [
    (("batch", "none", "tp", "none"), (4, 32, 24, 128)),
    (("batch", "none", "tp", "none"), (4, 32, 16, 64)),
    (("batch", "tp", "none", "none"), (4, 32, 24, 128)),
    (("experts", "batch", "none", "none"), (128, 8, 16, 64)),
    (("batch", "none", "tp"), (32, 512, 128256)),
    (("batch",), (6,)),
    (("batch", "none", "none"), (512, 7, 3)),
    (("fsdp", "tp"), (3072, 8192)),
    (("none",), (5,)),
    (("batch", "none"), (4, 4, 4)),
]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_activation_resolver_and_named_match_the_reference(mesh):
    shape, names = mesh
    jres, tres = jsh.activation_resolver(AbstractMesh(shape, names)), tsh.activation_resolver(MeshAxes(names, shape))
    for (logical, dims), strict in itertools.product(LOGICAL_CASES, (False, True)):
        want, got = jres(logical, dims, strict=strict), tres(logical, dims, strict=strict)
        assert (want is None) == (got is None), (logical, dims, strict)
        if want is not None:
            assert got.spec == tuple(want.spec), (logical, dims, strict)
    assert tsh.replicated(MeshAxes(names, shape)).spec == tuple(jsh.replicated(AbstractMesh(shape, names)).spec)
    for dims in (("batch", "none"), ("tp", "fsdp"), ("experts", "batch", "none", "none"), ("none",)):
        assert tsh.named(MeshAxes(names, shape), *dims).spec == tuple(jsh.named(AbstractMesh(shape, names),
                                                                                 *dims).spec)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_data_axes_and_worker_count_match_the_reference(mesh):
    shape, names = mesh
    am, duck = AbstractMesh(shape, names), MeshAxes(names, shape)
    assert tmesh.data_axes(tmesh.HostMesh(names)) == jmesh.data_axes(am)
    assert tmesh.n_workers(am) == jmesh.n_workers(am)
    assert tmesh.axis_sizes(am) == dict(zip(names, shape))
    assert tsh.MeshAxes.of(am) == duck


def test_to_placements_splits_a_two_axis_dim_pod_major():
    """A dim over ("pod", "data") is `Shard(d)` on both mesh dims, in mesh
    order (DTensor splits over the first mesh dim first, JAX's pod-major
    order; a gloo world checks it against a gathered tensor in
    tests/test_torch_distribution.py); the rest replicate."""
    from torch.distributed.tensor import Replicate, Shard

    duck = tmesh.HostMesh(("pod", "data", "model"))
    assert tsh.to_placements((("pod", "data"), None, "model"), duck) == (Shard(0), Shard(0), Shard(2))
    assert tsh.to_placements((None, "data"), duck) == (Replicate(), Shard(1), Replicate())
    assert tsh.to_placements((), duck) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        tsh.to_placements((("data", "pod"),), duck)
    with pytest.raises(ValueError, match="two tensor dims"):
        tsh.to_placements(("data", "data"), duck)


# ------------------------------------------------------------- meshes


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 12, 16, 480, 512])
def test_sweep_mesh_shape_matches_the_reference(n_devices):
    for g, r in itertools.product([1, 2, 3, 5, 7, 15, 32, 100], [1, 2, 3, 16, 32]):
        assert tmesh.sweep_mesh_shape(n_devices, g, r) == jmesh.sweep_mesh_shape(n_devices, g, r)


def test_sweep_mesh_shape_validates_as_the_reference():
    for args in ((0, 3, 3), (4, 0, 3), (4, 3, 0)):
        with pytest.raises(ValueError) as want:
            jmesh.sweep_mesh_shape(*args)
        with pytest.raises(ValueError) as got:
            tmesh.sweep_mesh_shape(*args)
        assert str(got.value) == str(want.value)


def test_meshes_without_a_process_group_create_none():
    """One process, no process group: the sweep and host meshes are 1 x 1
    stand-ins, and nothing initialises torch.distributed."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = tmesh.make_sweep_mesh(3, 5)
    assert tmesh.axis_names(mesh) == ("cells", "replicas") and tmesh.axis_sizes(mesh) == {"cells": 1, "replicas": 1}
    host = tmesh.make_host_mesh()
    assert tmesh.axis_names(host) == ("data", "model") and tmesh.n_workers(host) == 1
    assert tmesh.flat_index(mesh) == 0 and tmesh.mesh_ranks(mesh) == [0]
    with pytest.raises(ValueError, match="256 ranks; the world has 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks; the world has 1"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs one"):
        tmesh.make_sweep_mesh(2, 2, devices=[0, 1])
    x = torch.arange(6.0)
    assert tsh.place_spanning(x, tsh.Named(host, ("data",))) is x
    assert tsh.place_state({"wq": x}, host)["wq"] is x and tsh.place_batch({"tokens": x}, host)["tokens"] is x
    assert not dist.is_initialized()


# ------------------------------------------------------------ shardctx


def test_sweep_mesh_context_install_and_restore():
    assert shardctx.current_sweep_mesh() is None
    mesh = tmesh.make_sweep_mesh(2, 2)
    with shardctx.sweep_mesh(mesh) as m:
        assert m is mesh and shardctx.current_sweep_mesh() is mesh
        inner = tmesh.make_sweep_mesh(1, 1)
        with shardctx.sweep_mesh(inner):
            assert shardctx.current_sweep_mesh() is inner
        assert shardctx.current_sweep_mesh() is mesh
    assert shardctx.current_sweep_mesh() is None


def test_sweep_mesh_context_rejects_wrong_axes_as_the_reference():
    with pytest.raises(ValueError, match="cells") as want:
        with jctx.sweep_mesh(AbstractMesh((1, 1), ("data", "model"))):
            pass
    with pytest.raises(ValueError, match="cells") as got:
        with shardctx.sweep_mesh(tmesh.make_host_mesh()):
            pass
    assert str(got.value) == str(want.value)
    assert shardctx.current_sweep_mesh() is None


def test_activation_sharding_installs_restores_and_is_a_no_op_on_plain_tensors():
    x = torch.ones(4, 8, 6, 2)
    assert shardctx.constrain(x, "batch", "none", "tp", "none") is x
    seen = []

    def resolver(logical, shape, strict=False):
        seen.append((logical, shape, strict))
        return None

    with shardctx.activation_sharding(resolver):
        with shardctx.activation_sharding(tsh.activation_resolver(MeshAxes(("data", "model"), (2, 2)))):
            pass
        # a plain tensor is never constrained: no resolver call, x itself
        assert shardctx.constrain(x, "batch", "none", "tp", "none") is x
        assert shardctx.constrain_alt(x, ("batch", "none", "tp", "none")) is x
        assert shardctx.gather_dims(x, 0) is x
        assert shardctx._resolver() is resolver
    assert seen == [] and shardctx._resolver() is None
    np.testing.assert_array_equal(x.numpy(), np.ones((4, 8, 6, 2)))
