"""Worker side of tests/test_torch_distribution.py and test_torch_dryrun.py:
the port's sharded paths run in a world of CPU ranks joined by gloo, or on
rank 0 of a fake world (`start_fake_world`).

`start_world(world, jobs, tmp)` spawns ``world`` processes and returns at
once (`finish_world` waits for them).  Each joins the default process
group through a FileStore under ``tmp`` (no TCP port, so parallel test
processes never collide), holds torch to one thread, runs every job of
``jobs`` in order, and saves what they return to ``tmp/rank<r>.pt``.  A job is ``(name, kwargs)`` for a function of this
module.  Imports no JAX: the reference runs in the parent.
"""

from __future__ import annotations

import io
import os
import sys
import traceback
from contextlib import redirect_stdout

import torch
import torch.distributed as dist


def start_world(world: int, jobs: list, tmp: str):
    """Start ``jobs`` on ``world`` gloo ranks; `finish_world` collects them."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_main, args=(world, jobs, tmp), nprocs=world, join=False, start_method="spawn")
    return ctx, world, tmp


def finish_world(started) -> list:
    """Wait for a `start_world`; returns each rank's results (a list, one
    entry per job).  Raises if a rank failed."""
    ctx, world, tmp = started
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]



def start_fake_world(world: int, jobs: list, tmp: str):
    """Start ``jobs`` in one spawned process, rank 0 of a fake process group
    of ``world`` ranks (the dry run's world); `finish_world` collects it as
    a world of one."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_fake_main, args=(world, jobs, tmp), nprocs=1, join=False, start_method="spawn")
    return ctx, 1, tmp


def _fake_main(_: int, world: int, jobs: list, tmp: str) -> None:
    from repro_torch.launch.dryrun import open_fake_world

    torch.set_num_threads(1)
    open_fake_world(world, "cpu")
    try:
        torch.save([globals()[name](**kw) for name, kw in jobs], os.path.join(tmp, "rank0.pt"))
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()


def _main(rank: int, world: int, jobs: list, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                           world_size=world)
    try:
        out = [globals()[name](**kw) for name, kw in jobs]
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


# ------------------------------------------------------------------ jobs


def train_steps(arch: str, shape, mode: str, params_file: str, steps: int = 3, n_micro: int = 1):
    """tests/test_torch_train.py::run_both's port run (Pflug with thresh 0,
    SGD 0.3 with momentum 0.9, a comm model, 4 workers, batch 8 x 32,
    keys from PRNGKey(7)) on a ("data", "model") mesh of ``shape``, from the
    weights in ``params_file``.  Returns the metrics a step and the final
    parameters, whole."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import aggregation, controller, prng, straggler
    from repro_torch.data import TokenStream
    from repro_torch.launch import sharding, steps as steps_lib
    from repro_torch.models import build_model
    from repro_torch.optim import optimizers

    mesh = _mesh(shape)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = torch.load(params_file, weights_only=False)
    opt = optimizers.sgd(0.3, momentum=0.9)
    ctrl = controller.get_controller("pflug", 4, k0=1, step=1, thresh=0, burnin=0)
    state = steps_lib.init_train_state(opt, ctrl, params, mesh=mesh)
    step = steps_lib.make_train_step(model, opt, ctrl, straggler.Exponential(rate=1.0), 4,
                                     aggregation.CommModel(0.1, 0.05), n_micro=n_micro, mode=mode, mesh=mesh)
    stream = TokenStream(cfg.vocab_size, 32, 8, seed=0, device="cpu")
    key = prng.PRNGKey(7)
    rows = []
    for i in range(steps):
        tokens, targets = stream.batch_at(i)
        key, sub = prng.split(key).unbind(0)
        state, m = step(state, {"tokens": tokens, "targets": targets}, sub)
        rows.append({k: v.clone() for k, v in m.items()})
    placed = {str(k): tuple(str(p) for p in v.placements) for k, v in
              [("wq", state.params["layers"]["attn"]["wq"])]}
    return {"rows": rows, "params": sharding.gathered(state.params), "placements": placed,
            "ctrl": sharding.gathered(state.ctrl_state), "exec_async": sharding.gathered(state.exec_async)}


def count_train_step(arch: str, shape, fake: bool = False):
    """`roofline.count_step` of one sync train step of `train_steps`'
    recipe (from seed-0 weights) on a ("data", "model") mesh of ``shape``:
    this rank's FLOPs, bytes and collective bytes.  With ``fake`` every
    tensor is a fake one (the dry run's trace), on a fake world."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import aggregation, controller, prng, straggler
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import build_model
    from repro_torch.optim import optimizers
    from repro_torch.roofline import analysis

    mesh = _mesh(shape)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    opt = optimizers.sgd(0.3, momentum=0.9)
    ctrl = controller.get_controller("pflug", 4, k0=1, step=1, thresh=0, burnin=0)
    step = steps_lib.make_train_step(model, opt, ctrl, straggler.Exponential(rate=1.0), 4,
                                     aggregation.CommModel(0.1, 0.05), mesh=mesh)
    with FakeTensorMode() if fake else contextlib.nullcontext(), analysis.dtensor_metadata_uncounted():
        state = steps_lib.init_train_state(opt, ctrl, model.init(torch.Generator().manual_seed(0)), mesh=mesh)
        tokens, targets = TokenStream(cfg.vocab_size, 32, 8, seed=0, device="cpu").batch_at(0)
        cost = analysis.count_step(step, state, {"tokens": tokens, "targets": targets}, prng.PRNGKey(7))
    return {k: cost[k] for k in ("flops", "bytes accessed", "collectives")}


def count_dtensor_product():
    """`roofline.count_step` of a (4096 x 8192) @ (8192 x 8192) bf16 product
    of fake DTensors sharded (Shard(0), Replicate()) x (Replicate(),
    Shard(1)) on a (16, 16) mesh: this rank's count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.roofline import analysis

    mesh = _mesh((16, 16))
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(4096 // 16, 8192, dtype=torch.bfloat16), mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(torch.empty(8192, 8192 // 16, dtype=torch.bfloat16), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        cost = analysis.count_step(torch.matmul, a, b)
    return {k: cost[k] for k in ("flops", "collectives")}


def serve(arch: str, shape, params_file: str, prompt_len: int, new_tokens: int, window: int = 0):
    """`serve.generate` of ``arch``'s smoke config on a ("data", "model")
    mesh of ``shape`` (batch 4, prompts from seed 1), plus a prefill and two
    decode steps through `steps.make_prefill_step` and `make_decode_step`.
    Returns the tokens, the prefill logits, the decode logits and the
    kernel wrappers' launches."""
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.launch import serve as serve_lib, sharding, steps as steps_lib
    from repro_torch.models import build_model

    mesh = _mesh(shape)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = torch.load(params_file, weights_only=False)
    prompts = serve_lib.random_prompts(cfg, 4, prompt_len, 1, "cpu")
    attn_ops.launches, wkv_ops.launches = 0, 0
    res = serve_lib.generate(model, params, prompts, new_tokens, window=window, mesh=mesh)
    launches = {"flash": attn_ops.launches, "wkv": wkv_ops.launches}
    shape_in = InputShape("prefill", prompt_len, 4, "prefill")
    placed = sharding.place_state(params, mesh)
    prefill = steps_lib.make_prefill_step(model, cfg, shape_in, mesh=mesh)
    decode = steps_lib.make_decode_step(model, cfg, shape_in, mesh=mesh)
    lg, cache = prefill(placed, {"tokens": prompts})
    out = [sharding.gathered(lg)]
    kinds = {k: tuple(str(p) for p in v.placements) for k, v in cache.items()}
    if cfg.family != "ssm":  # room for the decode steps
        cache = serve_lib._grow_kv_cache(model, cache, 4, prompt_len + 2, 0, mesh)
    tok = torch.argmax(out[0], dim=-1)[:, None]
    for i in range(2):
        lg, cache = decode(placed, tok, cache, prompt_len + i)
        out.append(sharding.gathered(lg))
        tok = torch.argmax(out[-1], dim=-1)[:, None]
    return {"tokens": res.tokens, "prefill_logits": res.prefill_logits, "launches": launches,
            "step_logits": out, "cache_placements": kinds}


N_SLOTS = 8  # the podscale grid's worker slots


def podscale_cases(eta: float):
    """The port's twin of ref tests/test_podscale.py's mixed grid: sync
    Pflug, K-async, K-batch-async, a sign-flip Byzantine cell and a
    six-worker K-async hetero fleet with a rate drift."""
    from repro_torch.core.controller import FixedKController, PflugController
    from repro_torch.core.faults import byzantine_plan
    from repro_torch.core.straggler import Exponential, RateSchedule, WorkerFleet
    from repro_torch.core.sweep import SweepCase

    n = N_SLOTS
    fleet = WorkerFleet(models=(Exponential(rate=1.0),) * 4 + (Exponential(rate=0.25),) * 2,
                        schedule=RateSchedule(times=(5.0,), scales=(0.5,)))
    return [
        SweepCase(PflugController(n_workers=n, k0=2, step=2, thresh=5, burnin=10), Exponential(rate=1.0), eta,
                  label="sync_pflug"),
        SweepCase(FixedKController(n_workers=n, k=2), Exponential(rate=1.0), eta, label="kasync_k2", mode="kasync"),
        SweepCase(FixedKController(n_workers=n, k=3), Exponential(rate=1.0), eta, label="kbatch_k3", mode="kbatch"),
        SweepCase(FixedKController(n_workers=n, k=3), Exponential(rate=1.0), eta, label="flip",
                  fault=byzantine_plan(n, 0.25, "sign_flip")),
        SweepCase(FixedKController(n_workers=6, k=2), fleet, eta, label="kasync_hetero_n6", mode="kasync"),
    ]


def squared_error(w, X, y):
    """The grid's per-example loss: one function, so that every run of the
    grid shares a program-cache key."""
    return (X @ w - y) ** 2


def podscale_sweep(grid: dict, mesh=None, partition: str = "auto"):
    """`run_sweep` of the podscale grid (``grid``: X, y, keys as numpy, eta,
    iters, eval_every) on the CPU."""
    from repro_torch.core import prng
    from repro_torch.core.sweep import run_sweep

    X, y = torch.from_numpy(grid["X"].copy()), torch.from_numpy(grid["y"].copy())
    return run_sweep(squared_error, torch.zeros(X.shape[1]), X, y, n_workers=N_SLOTS,
                     cases=podscale_cases(grid["eta"]), num_iters=grid["iters"], keys=prng.as_key(grid["keys"]),
                     eval_every=grid["eval_every"], specialize=False, partition=partition, mesh=mesh, device="cpu")


def sweep(grid_file: str, shapes: list):
    """The podscale grid on each ("cells", "replicas") mesh of ``shapes``
    through the ``mesh=`` argument; on the first through the
    `shardctx.sweep_mesh` context (a repopulation of the same program:
    the traces it adds are returned) and through ``partition="shard_map"``;
    and through the default "auto" mesh over the world.  Returns
    {tag: (time, loss, k)}."""
    from repro_torch import shardctx
    from repro_torch.core import sweep as sw

    grid = torch.load(grid_file, weights_only=False)
    out = {}
    for shape in shapes:
        res = podscale_sweep(grid, mesh=_mesh(shape, ("cells", "replicas")))
        out[tuple(shape)] = (res.time, res.loss, res.k)
    first = _mesh(shapes[0], ("cells", "replicas"))
    before = sw.sweep_cache_stats()["traces"]
    with shardctx.sweep_mesh(first):
        res = podscale_sweep(grid)
    out["context"] = (res.time, res.loss, res.k)
    out["context_traces"] = sw.sweep_cache_stats()["traces"] - before
    res = podscale_sweep(grid, mesh=first, partition="shard_map")
    out["shard_map"] = (res.time, res.loss, res.k)
    res = podscale_sweep(grid)  # "auto": make_sweep_mesh over the world
    out["auto"] = (res.time, res.loss, res.k)
    return out


def simulate(argv: list):
    """`train.main(argv)` (a ``--simulate`` run) in this world; its stdout."""
    from repro_torch.launch import train

    buf = io.StringIO()
    with redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue()


def placement_order():
    """A dim split over ("pod", "data") on a (2, 2) mesh: each rank's shard
    and the gathered tensor, against JAX's pod-major block order."""
    from repro_torch.launch import mesh as mesh_lib, sharding

    mesh = _mesh((2, 2), ("pod", "data"))
    x = torch.arange(24.0).reshape(8, 3)
    d = sharding.place_spanning(x, sharding.Named(mesh, (("pod", "data"), None)))
    return {"flat_index": mesh_lib.flat_index(mesh), "local": d.to_local().clone(), "full": d.full_tensor()}
