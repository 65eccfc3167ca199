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

import contextlib
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


def train_steps(arch: str, shape, mode: str, params_file: str, steps: int = 3, n_micro: int = 1,
                overrides: dict | None = None):
    """tests/test_torch_train.py::run_both's port run (Pflug with thresh 0,
    SGD 0.3 with momentum 0.9, a comm model, 4 workers, batch 8 x 32,
    keys from PRNGKey(7)) on a ("data", "model") mesh of ``shape``, from the
    weights in ``params_file``, the smoke config with ``overrides``.
    Returns the metrics a step and the final parameters, whole."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import aggregation, controller, prng, straggler
    from repro_torch.data import TokenStream
    from repro_torch.launch import sharding, steps as steps_lib
    from repro_torch.models import build_model
    from repro_torch.optim import optimizers

    mesh = _mesh(shape)
    cfg = get_smoke_config(arch).replace(**(overrides or {}))
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
    attn = state.params["layers"].get("attn", {})  # wq (L, D, H, hd), where the family has it there
    placed = {k: tuple(str(p) for p in v.placements) for k, v in attn.items() if k == "wq"}
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
    from repro_torch.launch import serve as serve_lib, sharding, specs, steps as steps_lib
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
    if cfg.family != "ssm":  # room for the decode steps (a windowed cache is its ring already)
        cache = serve_lib._grow_kv_cache(model, cache, 4, prompt_len + 2, specs.window_for(cfg, shape_in), mesh)
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


def vocab_parallel_nll(shape, data_file: str):
    """`model._nll` and `_ce_per_row` of the (B, T, Vpad) f32 logits in
    ``data_file`` (numpy, with targets, vocab and a weight a position)
    placed batch on "data" and vocab on "model" of a ("data", "model") mesh
    of ``shape``: the nll, the per-row CE and the gradient of sum(w * nll),
    gathered, with the forward's collective bytes by type
    (`roofline.count_step`)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import model as model_lib
    from repro_torch.roofline import analysis

    mesh = _mesh(shape)
    data = torch.load(data_file, weights_only=False)
    logits = torch.from_numpy(data["logits"])
    targets = distribute_tensor(torch.from_numpy(data["targets"]), mesh, [Shard(0), Replicate()])
    lg = distribute_tensor(logits, mesh, [Shard(0), Shard(2)]).requires_grad_()
    nll = model_lib._nll(lg, targets, data["vocab"])
    (nll.full_tensor() * torch.from_numpy(data["w"])).sum().backward()
    ce = model_lib._ce_per_row(lg.detach(), targets, data["vocab"])
    cost = analysis.count_step(lambda x: model_lib._nll(x, targets, data["vocab"]), lg.detach())
    return {"nll": nll.full_tensor().detach(), "ce": ce.full_tensor(), "grad": lg.grad.full_tensor(),
            "placements": tuple(str(p) for p in nll.placements), "collectives": cost["collectives"]}


# ------------------------------------------------- the attention layouts


@contextlib.contextmanager
def attention_spy():
    """Record every call of `layers._sdpa`, `_sdpa_blocked`,
    `_sdpa_decode_partial` and the kernel's wrapper `flash_attention` on
    plain tensors (a rank's piece): the function, q's and k's shapes and
    the FLOPs that an active `roofline.StepCounter` counted in it.  Yields
    the list of records."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    from repro_torch.kernels.attention import ops
    from repro_torch.models import layers
    from repro_torch.roofline.analysis import StepCounter
    from repro_torch.shardctx import is_dtensor

    calls = []
    saved = {(mod, name): getattr(mod, name) for mod, name in (
        (layers, "_sdpa"), (layers, "_sdpa_blocked"), (layers, "_sdpa_decode_partial"), (ops, "flash_attention"))}

    def spy(name, fn):
        def run(*args, **kwargs):
            q, k = args[:2] if name in ("_sdpa_decode_partial", "flash_attention") else args[1:3]
            if is_dtensor(q):
                return fn(*args, **kwargs)
            counter = next((m for m in _get_current_dispatch_mode_stack() if isinstance(m, StepCounter)), None)
            before = counter.flops if counter is not None else 0
            out = fn(*args, **kwargs)
            calls.append({"fn": name, "q": tuple(q.shape), "k": tuple(k.shape),
                          "flops": counter.flops - before if counter is not None else None})
            return out

        return run

    for (mod, name), fn in saved.items():
        setattr(mod, name, spy(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def layout_train(arch: str, shape, params_file: str, overrides: dict | None = None):
    """`train_steps` in sync mode with the attention calls recorded
    (`attention_spy`)."""
    with attention_spy() as calls:
        out = train_steps(arch, shape, "sync", params_file, overrides=overrides)
    return {**out, "calls": calls}


def layout_serving(arch: str, shape, params_file: str, prompt_len: int, new_tokens: int, window: int = 0):
    """On a ("data", "model") mesh of ``shape``: `serve.generate` of
    ``arch``'s smoke config (batch 4, prompts from seed 1, ``window``), then
    `steps.make_prefill_step` and two `make_decode_step` steps on the cache
    grown to prompt_len + 4 positions, and `roofline.count_step` of a third
    decode step.  Returns the tokens, the logits, the caches' placements,
    the attention calls of each part (`attention_spy`), the decode step's
    collective bytes and those of one layer's decode attention
    (`layers._sdpa` on the cache's first layer)."""
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.launch import serve as serve_lib, sharding, steps as steps_lib
    from repro_torch.models import build_model, layers
    from repro_torch.roofline import analysis

    mesh = _mesh(shape)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = torch.load(params_file, weights_only=False)
    prompts = serve_lib.random_prompts(cfg, 4, prompt_len, 1, "cpu")
    with attention_spy() as gen_calls:
        res = serve_lib.generate(model, params, prompts, new_tokens, window=window, mesh=mesh)
    shape_in = InputShape("prefill", prompt_len, 4, "prefill")
    placed = sharding.place_state(params, mesh)
    prefill = steps_lib.make_prefill_step(model, cfg, shape_in, mesh=mesh)
    decode = steps_lib.make_decode_step(model, cfg, shape_in, mesh=mesh)
    with attention_spy() as prefill_calls:
        lg, cache = prefill(placed, {"tokens": prompts})
    cache = serve_lib._grow_kv_cache(model, cache, 4, prompt_len + 4, 0, mesh)
    out = [sharding.gathered(lg)]
    tok = torch.argmax(out[0], dim=-1)[:, None]
    with attention_spy() as decode_calls:
        for i in range(2):
            lg, cache = decode(placed, tok, cache, prompt_len + i)
            out.append(sharding.gathered(lg))
            tok = torch.argmax(out[-1], dim=-1)[:, None]
    kinds = {k: tuple(str(p) for p in v.placements) for k, v in cache.items()}
    with sharding.mesh_context(mesh):
        cost = analysis.count_step(decode, placed, tok, cache, prompt_len + 2)
        # one layer's attention of a query laid out as `layers._qkv` leaves it
        q = torch.randn(4, 1, cfg.n_heads, cfg.resolved_head_dim, generator=torch.Generator().manual_seed(3))
        q = sharding.place_spanning(q, sharding.activation_resolver(mesh)(("batch", "none", "tp", "none"), q.shape))
        mask = torch.ones(1, 1, 1, cache["k"].shape[2], dtype=torch.bool)
        attn = analysis.count_step(layers._sdpa, cfg, q, cache["k"][0], cache["v"][0], mask)
    return {"tokens": res.tokens, "prefill_logits": res.prefill_logits, "step_logits": out,
            "cache_placements": kinds, "cache_local": tuple(cache["k"].to_local().shape),
            "calls": {"generate": gen_calls, "prefill": prefill_calls, "decode": decode_calls},
            "decode_collectives": cost["collectives"], "attention_collectives": attn["collectives"]}


def straddled_heads(arch: str, shape, batch: int = 2, seq: int = 16):
    """``arch``'s smoke attention on a ("data", "model") mesh of ``shape``
    whose model extent splits the q heads mid-group (llama3.2-3b's 6 q over
    2 kv heads on 3 ranks: rank 1's heads 2 and 3 read kv heads 0 and 1):
    random q, k, v (seed 0, whole on every rank) laid out as `layers._qkv`
    leaves them, through `layers._sdpa` with a causal mask and
    `_sdpa_blocked` (block 8) forward and backward, and through the
    kernel's wrapper `ops.flash_attention` forward.  Returns the whole
    outputs, the whole gradients of q, k and v (of the sum of each output
    times a fixed cotangent), and the attention calls (`attention_spy`)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import sharding
    from repro_torch.models import layers

    mesh = _mesh(shape)
    cfg = get_smoke_config(arch).replace(attention_block=8)
    gen = torch.Generator().manual_seed(0)
    whole = [torch.randn(batch, seq, n, cfg.resolved_head_dim, generator=gen)
             for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    cot = torch.randn(batch, seq, cfg.n_heads, cfg.resolved_head_dim, generator=gen)
    mask = torch.tril(torch.ones(seq, seq, dtype=torch.bool))[None, None]
    resolve = sharding.activation_resolver(mesh)
    out = {}
    with attention_spy() as calls, sharding.mesh_context(mesh):
        for name, fn in (("sdpa", lambda *qkv: layers._sdpa(cfg, *qkv, mask)),
                         ("blocked", lambda *qkv: layers._sdpa_blocked(cfg, *qkv, causal=True, window=0)),
                         ("flash", lambda *qkv: ops.flash_attention(*qkv, causal=True))):
            qkv = [sharding.place_spanning(x, resolve(("batch", "none", "tp", "none"), tuple(x.shape)))
                   .detach().requires_grad_(name != "flash") for x in whole]
            y = fn(*qkv)
            res = {"out": y.full_tensor(), "out_placements": tuple(str(p) for p in y.placements)}
            if name != "flash":
                (y * cot).sum().backward()  # cot whole on every rank: implicitly replicated
                res["grads"] = [x.grad.full_tensor() for x in qkv]
            out[name] = res
    return {**out, "calls": calls}


def attention_flops(arch: str, shape):
    """`count_train_step(arch, shape, fake=True)` with the attention calls
    recorded (`attention_spy`): the step's counts and the calls, each with
    the FLOPs counted in it."""
    with attention_spy() as calls:
        cost = count_train_step(arch, shape, fake=True)
    return {**cost, "calls": calls}


def full_width_pieces(archs: list, train: str = "train_4k", decode: str = "decode_32k"):
    """Each arch's full-config attention on fake DTensors of a fake (16, 16)
    ("data", "model") world: q, k and v of ``train``'s batch and sequence
    laid out as `layers._qkv` leaves them, through `layers._sdpa`; then one
    query against ``decode``'s cache placed by `sharding.batch_shardings`,
    and the decode's collective bytes (`roofline.count_step`).  Returns
    {arch: {"train": calls, "decode": calls, "decode_collectives": ...,
    "cache_placements": ...}} (`attention_spy`'s records)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import sharding
    from repro_torch.launch.specs import window_for
    from repro_torch.models import layers
    from repro_torch.roofline import analysis

    mesh = _mesh((16, 16))
    resolve = sharding.activation_resolver(mesh)
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        h, kvh, hd, dt = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, getattr(torch, cfg.compute_dtype)
        res = {}
        with FakeTensorMode(), analysis.dtensor_metadata_uncounted(), sharding.mesh_context(mesh):
            tr = INPUT_SHAPES[train]
            q, k, v = (sharding.place_spanning(torch.empty(tr.global_batch, tr.seq_len, n, hd, dtype=dt),
                                               resolve(("batch", "none", "tp", "none"), (tr.global_batch,
                                                                                        tr.seq_len, n, hd)))
                       for n in (h, kvh, kvh))
            with attention_spy() as calls:
                layers._sdpa(cfg, q, k, v, None)
            res["train"] = calls
            dec = INPUT_SHAPES[decode]
            s = min(dec.seq_len, window_for(cfg, dec) or dec.seq_len)
            cache = sharding.place_batch({"k": torch.empty(1, dec.global_batch, s, kvh, hd, dtype=dt),
                                          "v": torch.empty(1, dec.global_batch, s, kvh, hd, dtype=dt)}, mesh)
            qd = sharding.place_spanning(torch.empty(dec.global_batch, 1, h, hd, dtype=dt),
                                         resolve(("batch", "none", "tp", "none"), (dec.global_batch, 1, h, hd)))
            mask = torch.ones(1, 1, 1, s, dtype=torch.bool)
            with attention_spy() as calls:
                cost = analysis.count_step(layers._sdpa, cfg, qd, cache["k"][0], cache["v"][0], mask)
            res["decode"] = calls
            res["decode_collectives"] = cost["collectives"]
            res["cache_placements"] = tuple(str(p) for p in cache["k"].placements)
        out[arch] = res
    return out
