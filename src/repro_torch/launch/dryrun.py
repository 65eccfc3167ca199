"""Dry run: prove the distribution config is coherent without the hardware.

The port of `repro/launch/dryrun.py`.  For one (--arch, --shape) it opens a
fake process group of 256 ranks (512 with --multi-pod) at rank 0, builds the
production mesh on it (`launch/mesh.py::make_production_mesh`), builds the
train state (or the parameters) under `FakeTensorMode` and places it by the
sharding rules, then runs the real step once inside `roofline.count_step`:
`steps.make_train_step` in sync mode with the reference's Pflug controller
for train shapes, `make_prefill_step` / `make_decode_step` for serving
shapes.  No tensor holds data, so nothing is allocated at full width, and
the fake process group moves nothing: DTensor issues its collectives and
each rank's local ops as on a real world, and the counter records rank 0's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-3b --shape long_500k --device cpu

``--device cuda`` (the default) traces the card's program: fake CUDA
tensors, the kernels' custom ops (their fake implementations and FLOP
formulas) in place of their plain versions, no launch.  It needs a torch
built for CUDA: a CPU-only build cannot index a fake CUDA tensor, so on a
host without CUDA it raises.  ``--device cpu`` traces the CPU program, the
kernels' plain versions included.  The result is one JSON object: the
memory (argument bytes, the traced peak), the analytic memory model
(`roofline/memory.py`), the collective bytes by type and the roofline terms
(`roofline/analysis.py`).  An eager trace runs every layer, so there is no
`--unroll`: the counts are full depth.

The process group is global, so a process runs one dry run
(`launch/dryrun_all.py` runs the matrix, one process a job).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.core import prng
from repro_torch.core.aggregation import CommModel
from repro_torch.core.controller import PflugController, SketchedPflugController
from repro_torch.core.straggler import ShiftedExponential
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import memory as mem_model


def open_fake_world(n_ranks: int, device: str) -> None:
    """The default process group: ``n_ranks`` fake ranks, this process rank
    0, on the backend "<device>:fake" (so meshes hold ``device`` tensors,
    `mesh._mesh_device_type`).  Collectives return tensors of the right
    shapes and move nothing."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"the dry run needs torch's fake process group "
                           f"(torch.testing._internal.distributed.fake_pg), which torch {torch.__version__} "
                           "lacks") from e
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks or dist.get_backend() != f"{device}:fake":
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks on {dist.get_backend()!r} is "
                               f"open; the dry run needs {n_ranks} fake ranks on {device}: run it in a fresh process")
        return
    dist.init_process_group(f"{device}:fake", store=FakeStore(), rank=0, world_size=n_ranks)


def _fake_like(tree, device: str):
    """Fake tensors on ``device`` shaped like ``tree``'s (meta) leaves; call
    under a FakeTensorMode."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)
                    if isinstance(x, torch.Tensor) else x, tree)


def build_step(arch: str, shape_name: str, multi_pod: bool, *, overrides: Dict[str, Any] | None = None,
               device: str = "cuda"):
    """``(fn, args, ctx)``: the step for one (arch, shape, mesh) and its
    placed arguments.  Call under a `FakeTensorMode` on a fake world
    (`open_fake_world`)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    overrides = dict(overrides or {})
    controller_kind = overrides.pop("controller", "pflug")
    n_micro = int(overrides.pop("n_micro", 1))
    moments_dtype = overrides.pop("moments_dtype", "float32")
    cfg = get_config(arch).replace(**overrides)
    shape = INPUT_SHAPES[shape_name]
    with unset_fake_temporarily():  # the mesh's rank grid is real
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg, device)
    n_work = mesh_lib.n_workers(mesh)
    params = model.init(torch.Generator(device=device))
    params_sh = sharding.param_shardings(params, mesh)
    batch = _fake_like(specs_lib.input_specs(cfg, shape), device)
    ctx = dict(cfg=cfg, shape=shape, mesh=mesh, params=params, params_sh=params_sh, n_micro=n_micro)

    if shape.kind == "train":
        opt = adamw(lr=1e-4, weight_decay=0.01, moments_dtype=moments_dtype)
        ctrl_cls = SketchedPflugController if controller_kind == "sketched" else PflugController
        controller = ctrl_cls(n_workers=n_work, k0=max(n_work // 4, 1), step=max(n_work // 8, 1), thresh=10,
                              burnin=100)
        straggler = ShiftedExponential(shift=1.0, rate=1.0)
        step = steps_lib.make_train_step(model, opt, controller, straggler, n_work, CommModel(), n_micro=n_micro,
                                         mesh=mesh)
        state = steps_lib.init_train_state(opt, controller, params, mesh)
        ctx.update(state=state, state_sh=sharding.param_shardings(state, mesh))
        return step, (state, sharding.place_batch(batch, mesh), prng.PRNGKey(0, device=device)), ctx

    params = sharding.place_state(params, mesh)
    ctx.update(state=params, state_sh=params_sh)
    if shape.kind == "prefill":
        step = steps_lib.make_prefill_step(model, cfg, shape, mesh)
        return step, (params, sharding.place_batch(batch, mesh)), ctx

    # decode: one token against a seq_len-deep cache, at the last position
    # (a Python int: the step reads it on the host).  vlm's patches are in
    # the cache already; encdec's frames are the encoder's static memory.
    decode = steps_lib.make_decode_step(model, cfg, shape, mesh)
    extras = {k: v for k, v in batch.items() if k not in ("token", "cache", "pos")}
    cache = sharding.place_batch(batch["cache"], mesh)
    ctx.update(cache=cache, cache_sh=sharding.batch_shardings(cache, mesh))
    placed = sharding.place_batch({"token": batch["token"], **extras}, mesh)
    token = placed.pop("token")

    def step(params, token, cache, extras):
        return decode(params, token, cache, shape.seq_len - 1, **extras)

    return step, (params, token, cache, placed), ctx


def _local_bytes(tree) -> int:
    """Bytes this rank holds of ``tree``: a DTensor's local shard, a plain
    tensor whole, each storage once."""
    from torch.distributed.tensor import DTensor

    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = (t._local_tensor if isinstance(t, DTensor) else t).untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def run_one(arch: str, shape_name: str, multi_pod: bool, *, overrides=None, device: str = "cuda") -> Dict[str, Any]:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run traces the card's program (--device cuda), but torch.cuda.is_available() is "
                           "False: a CPU-only torch cannot index fake CUDA tensors; pass --device cpu to trace the "
                           "CPU program")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.wkv import ops as wkv_ops

    open_fake_world(512 if multi_pod else 256, device)
    launches_before = (attn_ops.launches, wkv_ops.launches)
    t0 = time.time()
    with FakeTensorMode(), roofline.dtensor_metadata_uncounted():
        fn, args, ctx = build_step(arch, shape_name, multi_pod, overrides=overrides, device=device)
        argument_bytes = _local_bytes(args)
        cost = roofline.count_step(fn, *args)
    trace_s = time.time() - t0
    cfg, shape, mesh = ctx["cfg"], ctx["shape"], ctx["mesh"]
    n_devices = mesh.size()
    coll = cost["collectives"]
    terms = roofline.roofline_terms(cost, coll["total"])
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mf = roofline.model_flops(cfg, ctx["params"], tokens, "train" if shape.kind == "train" else "fwd")
    terms["model_flops_global"] = mf
    terms["useful_flops_ratio"] = mf / max(terms["flops"] * n_devices, 1.0)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_devices,
        "device": device,
        "torch": torch.__version__,
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": argument_bytes,
            "peak_bytes": cost["peak_bytes"],
            "peak_source": "tally of live fake storage: the arguments' local storages and every op's outputs, "
                           "each from its first sight to its collection",
        },
        "analytic_memory": mem_model.analytic_memory(
            cfg, shape, mesh, ctx["state"], ctx["state_sh"], params=ctx["params"], params_shardings=ctx["params_sh"],
            cache=ctx.get("cache"), cache_shardings=ctx.get("cache_sh"), n_micro=ctx["n_micro"],
        ),
        "kernel_calls": cost["kernel_calls"],
        "kernel_launches": {"flash_attention": attn_ops.launches - launches_before[0],
                            "wkv6": wkv_ops.launches - launches_before[1]},
        "collectives": coll,
        "roofline": terms,
    }


def parse_overrides(pairs) -> Dict[str, Any]:
    """``["k=v", ...]`` -> {k: v}, each v read as JSON where it parses."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", required=True, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true", help="the (2, 16, 16) mesh on 512 fake ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="trace the card's program (default; needs torch built for CUDA) or the CPU's")
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (repeatable); also controller=sketched, n_micro, moments_dtype")
    args = ap.parse_args(argv)

    result = run_one(args.arch, args.shape, args.multi_pod, overrides=parse_overrides(args.override),
                     device=args.device)
    print(json.dumps(result, indent=2, default=str))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


if __name__ == "__main__":
    main()
