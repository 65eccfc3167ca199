"""Train an LM with adaptive fastest-k SGD: the port of the LM loop of
`repro/launch/train.py`, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke --device cpu \\
        --steps 200 --batch 16 --seq 128 --controller pflug
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m --batch 8 --seq 512

Every registered arch trains: dense, moe (each row's loss carries the
router's load-balance term, as in the JAX package), ssm, hybrid, vlm and
encdec (fed zero patches or frames of the reference CLI's shapes,
`specs.stub_inputs`; the async modes refuse them, as the reference's do).

Each step is `launch.steps.make_train_step`: the same per-mode builders the
simulation engines run, around the model's loss, so ``--mode kasync`` and
``--mode kbatch`` run the async modes with no logic of their own.  It logs
one JSON line per ``--log-every`` steps (ce, k, simulated time), and
checkpoints to ``--ckpt-dir`` (resuming from its latest step) in the JAX
package's format.  Parameters are random, drawn on the device from
``--seed``; the token stream is `TokenStream` from ``--seed``, and the
straggler key splits once a step from `prng.PRNGKey(seed)`, so k and the
simulated clock follow the reference's CLI bit for bit.

``--simulate`` switches to the paper-scale simulation entry instead of LM
training: a controller x straggler (x n x mode x fault x aggregator) grid
of Monte-Carlo replicas on the synthetic linear regression, run as one
`core.sweep.run_sweep` program, one JSON line a cell and an optional CSV,
as the reference's CLI prints them:

    PYTHONPATH=src python -m repro_torch.launch.train --simulate --device cpu \\
        --sim-controllers pflug,fixed --sim-stragglers exponential,pareto \\
        --steps 300 --replicas 4 --n-workers 20

``--distributed`` joins the default process group from torchrun's
environment before anything builds a program (NCCL on CUDA, gloo on the
CPU); the sweep then dispatches over a ("cells", "replicas") mesh of every
rank, and the LM loop runs on the ("data", "model") mesh —
``--production-mesh``'s (16, 16) over 256 ranks, else the (1, 1) host
mesh — with its state placed by `launch.sharding` and its step under the
activation resolver.  Only rank 0 prints and writes checkpoints:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --distributed --simulate --device cpu \
        --steps 300 --replicas 4

Not ported yet: ``--cache-dir`` (ROADMAP item 12) raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import checkpoint, resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import execmode, prng, theory
from repro_torch.core.aggregation import AGG_KINDS, CommModel
from repro_torch.core.controller import get_controller
from repro_torch.core.faults import byzantine_plan
from repro_torch.core.straggler import Exponential, RateSchedule, WorkerFleet, get_straggler_model
from repro_torch.core.sweep import SweepCase, run_sweep, summarize_cells
from repro_torch.data import TokenStream, make_linreg_data
from repro_torch.launch import mesh as mesh_lib, sharding, steps as steps_lib
from repro_torch.launch.quickstart import squared_error, step_size
from repro_torch.launch.specs import stub_inputs
from repro_torch.models import build_model
from repro_torch.optim import get_optimizer

# Flags of the reference's CLI whose machinery is not ported, and where it waits.
NOT_PORTED = {
    "cache_dir": "the persistent compilation cache (ROADMAP Queue 1 item 12)",
}

# What torchrun sets for each process, and --distributed reads.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device) -> str:
    """``--distributed``: the default process group from torchrun's
    environment (NCCL for CUDA, with this process on ``cuda:LOCAL_RANK``;
    gloo for the CPU), unless one is initialised already.  Returns the
    device string this process runs on."""
    import os

    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_initialized():
        return str(dev)
    missing = [v for v in TORCHRUN_ENV if v not in os.environ]
    if missing:
        raise SystemExit(f"--distributed: no process group is initialised and the torchrun environment lacks "
                         f"{missing}; launch with torchrun --nproc-per-node N -m repro_torch.launch.train "
                         "--distributed ...")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return str(dev)


def _is_rank0() -> bool:
    return mesh_lib.world()[1] == 0


def _parse_pair(spec, flag, cast=float):
    try:
        a, b = spec.split(":")
        return cast(a), cast(b)
    except ValueError:
        raise SystemExit(f"{flag} expects 'A:B', got {spec!r}")


def _n_values(args) -> list:
    if args.sim_n_grid:
        return sorted({int(v) for v in args.sim_n_grid.split(",") if v})
    return [args.n_workers]


def simulation_cases(args, eta: float) -> list:
    """The ``--simulate`` grid as `SweepCase`s, in the reference's order
    (mode, n, straggler, controller, fault, aggregator) and with its labels
    ``ctrl|strag[|nN][|mode][|fault][|agg]``; every check of the reference
    raises `SystemExit` with its message.

    ``--sim-n-grid`` makes the worker count a grid axis (cells are padded to
    the largest n; smaller-n cells hold the extra slots inactive).
    ``--sim-hetero FRAC:FACTOR`` swaps the straggler axis for a two-speed
    exponential fleet (a FRAC fraction of each cell's workers FACTOR x
    slower), ``--sim-drift T:SCALE`` multiplies every rate by SCALE from
    simulated time T, ``--sim-fault FAMILY:FRAC:ONSET[:PARAM]`` gives a FRAC
    fraction of each cell's workers a fault from ONSET on, and ``--sim-mode``
    and ``--sim-agg`` pick the execution modes and aggregators; a comma list
    sweeps any of them as a grid axis.
    """
    n_values = _n_values(args)
    n_slots = max(n_values)
    ctrl_names = [c for c in args.sim_controllers.split(",") if c]

    drift = None
    if args.sim_drift:
        t_drift, scale = _parse_pair(args.sim_drift, "--sim-drift")
        drift = RateSchedule(times=(t_drift,), scales=(scale,))

    def stragglers_for(n):
        """{label: straggler spec} for an n-active-worker cell."""
        if args.sim_hetero:
            frac, factor = _parse_pair(args.sim_hetero, "--sim-hetero")
            if not 0.0 <= frac <= 1.0 or factor <= 0:
                raise SystemExit(f"--sim-hetero: bad FRAC:FACTOR {args.sim_hetero!r}")
            n_slow = int(round(frac * n))
            fleet = WorkerFleet(models=(Exponential(rate=1.0),) * (n - n_slow)
                                + (Exponential(rate=1.0 / factor),) * n_slow, schedule=drift)
            return {f"two_speed{args.sim_hetero}": fleet}
        out = {}
        for sname in (s for s in args.sim_stragglers.split(",") if s):
            model = get_straggler_model(sname)
            out[sname] = WorkerFleet(models=(model,) * n, schedule=drift) if drift is not None else model
        return out

    def make_sim_controller(name, straggler, n):
        if name == "pflug":
            return get_controller("pflug", n, k0=args.k0, step=args.k_step, thresh=args.thresh, burnin=args.burnin)
        if name == "sketched_pflug":
            return get_controller("sketched_pflug", n, k0=args.k0, step=args.k_step, thresh=args.thresh,
                                  burnin=args.burnin, sketch_dim=args.sketch_dim)
        if name == "fixed":
            if args.fixed_k > n:
                raise SystemExit(f"--fixed-k {args.fixed_k} > n={n}")
            return get_controller("fixed", n, k=args.fixed_k)
        if name == "variance_ratio":
            return get_controller("variance_ratio", n, k0=args.k0, step=args.k_step, burnin=args.burnin)
        if name == "schedule":
            sysm = theory.SGDSystem(
                eta=eta, L=args.schedule_smoothness, c=args.schedule_strong_convexity,
                sigma2=args.schedule_sigma2, s=args.sim_m // n_slots, F0_gap=args.schedule_f0_gap, n=n,
                straggler=straggler,
            )
            times = theory.switching_times(sysm, list(range(args.k0, n, args.k_step)), step=args.k_step)
            return get_controller("schedule", n, switch_times=times, k0=args.k0, step=args.k_step)
        raise SystemExit(f"--sim-controllers: unknown controller {name!r}")

    comm = CommModel(alpha=args.comm_alpha, beta=args.comm_beta)
    modes = [mm for mm in args.sim_mode.split(",") if mm]
    for mm in modes:
        if mm not in execmode.MODES:
            raise SystemExit(f"--sim-mode: unknown mode {mm!r}; options {sorted(execmode.MODES)}")
    if not modes:
        raise SystemExit("--sim-mode: need at least one mode")

    # each --sim-fault spec is FAMILY:FRAC:ONSET[:PARAM] or "none" (a
    # Byzantine sweep's fault-free arm)
    fault_specs = [s for s in args.sim_fault.split(",") if s] if args.sim_fault else ["none"]
    parsed_faults = []
    for spec in fault_specs:
        if spec == "none":
            parsed_faults.append((spec, None))
            continue
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise SystemExit(f"--sim-fault expects FAMILY:FRAC:ONSET[:PARAM] or 'none', got {spec!r}")
        try:
            cfg = (parts[0], float(parts[1]), float(parts[2]), float(parts[3]) if len(parts) == 4 else 1.0)
        except ValueError:
            raise SystemExit(f"--sim-fault: bad numbers in {spec!r}")
        parsed_faults.append((spec, cfg))

    def make_plan(cfg, n):
        if cfg is None:
            return None
        family, frac, onset, param = cfg
        try:
            return byzantine_plan(n, frac, family, onset=onset, param=param)
        except ValueError as e:
            raise SystemExit(f"--sim-fault: {e}")

    aggs = [a for a in args.sim_agg.split(",") if a]
    for a in aggs:
        if a not in AGG_KINDS:
            raise SystemExit(f"--sim-agg: unknown aggregator {a!r}; options {sorted(AGG_KINDS)}")
    if not aggs:
        raise SystemExit("--sim-agg: need at least one aggregator")
    if "kbatch" in modes and any(a != "mean" for a in aggs):
        raise SystemExit("--sim-agg: robust aggregation is not supported in kbatch mode (drop kbatch from "
                         "--sim-mode)")

    def tag(value, axis):
        return f"|{value}" if len(axis) > 1 else ""

    return [
        SweepCase(make_sim_controller(cname, strag, n), strag, eta=eta, comm=comm,
                  label=(f"{cname}|{sname}{tag(f'n{n}', n_values)}{tag(mm, modes)}"
                         f"{tag(ftag, parsed_faults)}{tag(agg, aggs)}"),
                  mode=mm, fault=make_plan(fcfg, n), agg=agg)
        for mm in modes
        for n in n_values
        for sname, strag in stragglers_for(n).items()
        for cname in ctrl_names
        for ftag, fcfg in parsed_faults
        for agg in aggs
    ]


def run_simulation(args, eta: float | None = None) -> dict:
    """The train CLI's simulation entry: the grid of `simulation_cases` as
    one `run_sweep` on ``args.device``, data from ``PRNGKey(seed)`` and the
    replicas' keys split from ``PRNGKey(seed + 1)``.  Prints the reference's
    header line and one JSON line a cell, and writes ``--sim-csv``.
    ``eta`` overrides 0.5 / L (the parity tests pass the reference's: the
    two packages' eigensolvers differ in the last ulps).  Returns {"header",
    "cells" (the printed lines), "f_star", "eta", "cases", "result" (the
    `SweepResult`), "stats" (`summarize_cells`)}."""
    m, d = args.sim_m, args.sim_d
    n_slots = max(_n_values(args))
    if m % n_slots:
        raise SystemExit(f"--sim-m {m} must be divisible by the largest n ({n_slots})")
    dev = resolve_device(args.device)
    data = make_linreg_data(prng.PRNGKey(args.seed, device=dev), m=m, d=d, device=dev)
    eta = step_size(data.X) if eta is None else eta
    cases = simulation_cases(args, eta)
    t0 = time.perf_counter()
    result = run_sweep(squared_error, torch.zeros(d, device=dev), data.X, data.y, n_workers=n_slots, cases=cases,
                       num_iters=args.steps, key=prng.PRNGKey(args.seed + 1, device=dev), n_replicas=args.replicas,
                       eval_every=args.sim_eval_every, device=dev)
    stats = summarize_cells(result)
    wall = time.perf_counter() - t0
    # the sweep ran over make_sweep_mesh: the world of the default process
    # group (one process per device), or one device without one
    n_world, _ = mesh_lib.world()
    one_process = n_world == 1 and not torch.distributed.is_initialized()
    header = {"grid_cells": len(cases), "replicas": args.replicas, "iters": args.steps, "dispatches": 1,
              "devices": (torch.cuda.device_count() if dev.type == "cuda" else 1) if one_process else n_world,
              "processes": n_world,
              "mesh_shape": list(mesh_lib.sweep_mesh_shape(n_world, len(cases), args.replicas)),
              "wall_s": round(wall, 2)}
    say = print if _is_rank0() else (lambda *a, **k: None)
    say(json.dumps(header))
    cells = []
    for label, s in stats.items():
        cells.append({
            "cell": label,
            "final_excess": float(s["loss_mean"][-1] - data.f_star),
            "final_excess_ci95": float(s["loss_ci95"][-1]),
            "sim_time": round(float(s["time_mean"][-1]), 2),
            "k_final": round(float(s["k_mean"][-1]), 2),
        })
        say(json.dumps(cells[-1]), flush=True)
    if args.sim_csv and _is_rank0():
        with open(args.sim_csv, "w") as f:
            f.write("cell,iteration,time_mean,time_ci95,loss_mean,loss_ci95,k_mean\n")
            for label, s in stats.items():
                for i in range(len(s["iteration"])):
                    f.write(f"{label},{s['iteration'][i]},{s['time_mean'][i]:.3f},{s['time_ci95'][i]:.4f},"
                            f"{s['loss_mean'][i]:.6g},{s['loss_ci95'][i]:.6g},{s['k_mean'][i]:.2f}\n")
        say(f"wrote {args.sim_csv}")
    return {"header": header, "cells": cells, "f_star": data.f_star, "eta": eta, "cases": cases,
            "result": result, "stats": stats}


def make_controller(args, n_workers: int, straggler):
    ckw = {}
    if args.controller == "pflug":
        ckw = dict(k0=args.k0, step=args.k_step, thresh=args.thresh, burnin=args.burnin)
    elif args.controller == "sketched_pflug":
        ckw = dict(k0=args.k0, step=args.k_step, thresh=args.thresh, burnin=args.burnin,
                   sketch_dim=args.sketch_dim)
    elif args.controller == "fixed":
        ckw = dict(k=args.fixed_k)
    elif args.controller == "schedule":
        # Theorem-1 bound-optimal switch times from the straggler model's
        # order statistics and the supplied SGD constants
        sysm = theory.SGDSystem(
            eta=args.lr, L=args.schedule_smoothness, c=args.schedule_strong_convexity,
            sigma2=args.schedule_sigma2, s=args.batch // n_workers, F0_gap=args.schedule_f0_gap,
            n=n_workers, straggler=straggler,
        )
        times = theory.switching_times(sysm, list(range(args.k0, n_workers, args.k_step)), step=args.k_step)
        print(f"schedule: Theorem-1 switch times {[round(t, 2) for t in times]}")
        ckw = dict(switch_times=times, k0=args.k0, step=args.k_step)
    elif args.controller == "variance_ratio":
        ckw = dict(k0=args.k0, step=args.k_step, burnin=args.burnin)
    return get_controller(args.controller, n_workers, **ckw)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference CLI's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--controller", default="pflug",
                    choices=["pflug", "sketched_pflug", "fixed", "schedule", "variance_ratio"])
    ap.add_argument("--k0", type=int, default=1)
    ap.add_argument("--k-step", type=int, default=1)
    ap.add_argument("--thresh", type=int, default=10)
    ap.add_argument("--burnin", type=int, default=20)
    ap.add_argument("--fixed-k", type=int, default=2)
    ap.add_argument("--sketch-dim", type=int, default=64, help="sketched_pflug: dimension of the gradient sketch")
    # --controller schedule: Theorem-1 switch times need the SGD system's
    # constants, which an LM run does not identify: estimates
    ap.add_argument("--schedule-smoothness", type=float, default=1.0, help="schedule: L (smoothness estimate)")
    ap.add_argument("--schedule-strong-convexity", type=float, default=0.1,
                    help="schedule: c (strong-convexity estimate)")
    ap.add_argument("--schedule-sigma2", type=float, default=1.0,
                    help="schedule: per-sample gradient variance estimate")
    ap.add_argument("--schedule-f0-gap", type=float, default=10.0, help="schedule: F(w0) - F* estimate")
    ap.add_argument("--mode", default="sync", choices=["sync", "kasync", "kbatch"],
                    help="execution mode (the per-mode step builders the simulation engines run)")
    ap.add_argument("--straggler", default="exponential",
                    choices=["exponential", "shifted_exponential", "pareto", "bimodal", "deterministic"])
    ap.add_argument("--comm-alpha", type=float, default=0.0)
    ap.add_argument("--comm-beta", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # --- simulation entry (the paper-scale linreg sweep instead of LM training)
    ap.add_argument("--simulate", action="store_true",
                    help="run a controller x straggler Monte-Carlo sweep on the paper's synthetic linreg task (one "
                         "core.sweep program) instead of LM training")
    ap.add_argument("--sim-controllers", default="pflug,fixed",
                    help="comma list from {pflug,sketched_pflug,fixed,schedule,variance_ratio}")
    ap.add_argument("--sim-stragglers", default="exponential,pareto",
                    help="comma list of registered straggler models")
    ap.add_argument("--sim-hetero", default=None, metavar="FRAC:FACTOR",
                    help="simulate: replace the straggler axis with a two-speed exponential fleet: FRAC of each "
                         "cell's workers run FACTOR x slower (e.g. 0.3:4)")
    ap.add_argument("--sim-drift", default=None, metavar="T:SCALE",
                    help="simulate: fleet-wide rate drift: multiply every worker's rate by SCALE at simulated "
                         "time T (e.g. 500:0.4)")
    ap.add_argument("--sim-mode", default="sync", metavar="MODE[,MODE..]",
                    help="simulate: execution mode(s) from {sync,kasync,kbatch}; a comma list sweeps mode as a "
                         "grid axis (async modes apply stale gradients, k = arrivals per master update)")
    ap.add_argument("--sim-fault", default=None, metavar="FAMILY:FRAC:ONSET[:PARAM]",
                    help="simulate: per-worker fault plan: FRAC of each cell's workers turns faulty (family from "
                         "{sign_flip,rescale,random_gauss,crash}) once sim time reaches ONSET; PARAM is the "
                         "rescale factor / gauss scale (e.g. sign_flip:0.3:0). A comma list (entries may be "
                         "'none') sweeps the fault plan as a grid axis")
    ap.add_argument("--sim-agg", default="mean", metavar="AGG[,AGG..]",
                    help="simulate: gradient aggregator from {mean,trimmed,median,geomedian}; a comma list sweeps "
                         "the aggregator as a grid axis (robust options aggregate per-worker gradient rows; not "
                         "available with kbatch mode)")
    ap.add_argument("--sim-n-grid", default=None, metavar="N1,N2,...",
                    help="simulate: sweep the worker count as a grid axis; cells are padded to the largest n "
                         "(overrides --n-workers)")
    ap.add_argument("--replicas", type=int, default=16, help="simulate: Monte-Carlo replicas per grid cell")
    ap.add_argument("--sim-m", type=int, default=400, help="simulate: number of examples")
    ap.add_argument("--sim-d", type=int, default=20, help="simulate: problem dimension")
    ap.add_argument("--sim-eval-every", type=int, default=500)
    ap.add_argument("--sim-csv", default=None, help="simulate: write per-cell trajectories to this CSV")
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the (16, 16) ('data', 'model') mesh: needs a world of 256 ranks")
    ap.add_argument("--distributed", action="store_true",
                    help="initialise torch.distributed from torchrun's environment (NCCL on CUDA, gloo on the "
                         "CPU): meshes — the LM mesh and the sweep engine's (cells, replicas) mesh alike — then "
                         "span every process")
    ap.add_argument("--cache-dir", default=None, metavar="DIR", help="not ported: raises")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not ported yet")
    # before anything builds a program: the process group defines the world
    # every mesh spans
    if args.distributed:
        args.device = init_distributed(args.device)
    if args.simulate:
        return run_simulation(args)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, dev)
    try:
        mesh = mesh_lib.make_production_mesh() if args.production_mesh else mesh_lib.make_host_mesh()
    except ValueError as e:
        raise SystemExit(f"--production-mesh: {e}" if args.production_mesh else str(e))
    say = print if _is_rank0() else (lambda *a, **k: None)
    n_workers = args.n_workers
    if args.batch % n_workers:
        raise SystemExit(f"--batch {args.batch} must be divisible by --n-workers {n_workers}")

    opt = get_optimizer(args.optimizer, args.lr)
    straggler = get_straggler_model(args.straggler)
    controller = make_controller(args, n_workers, straggler)
    comm = CommModel(alpha=args.comm_alpha, beta=args.comm_beta)
    train_step = steps_lib.make_train_step(model, opt, controller, straggler, n_workers, comm, mode=args.mode,
                                           mesh=mesh)
    data = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
                       device=args.device)

    key = prng.PRNGKey(args.seed, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = steps_lib.init_train_state(opt, controller, params)
    start = 0
    if args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            like = state
            if args.mode != "sync":
                # an async checkpoint holds the renewal state (the reference's
                # restore, into the initial state, refuses one)
                c = execmode.init_exec_carry(state.params, n_workers, state.ctrl_state, key)
                like = state._replace(exec_async=(c.worker_params, c.remaining, c.staleness, c.pending))
            state = checkpoint.restore(args.ckpt_dir, latest, like)
            start = latest
            say(f"restored step {latest} from {args.ckpt_dir}")
    # the mesh's layout (a no-op on the one-device stand-in), as the
    # reference's loop runs inside its mesh and activation resolver
    state = steps_lib.place_train_state(state, mesh)

    stubs = stub_inputs(cfg, args.batch, dev)
    t0 = time.time()
    for step in range(start, args.steps):
        tokens, targets = data.batch_at(step)
        key, sub = prng.split(key).unbind(0)
        state, metrics = train_step(state, {"tokens": tokens, "targets": targets, **stubs}, sub)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(json.dumps({
                "step": step,
                "ce": round(float(metrics["ce"]), 4),
                "k": int(metrics["k"]),
                "sim_time": round(float(metrics["sim_time"]), 2),
                "iter_time": round(float(metrics["iter_time"]), 3),
                "wall_s": round(time.time() - t0, 1),
            }), flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, step + 1, state)
    if args.ckpt_dir:
        _save(args.ckpt_dir, args.steps, state)
        say(f"saved final checkpoint at step {args.steps}")


def _save(ckpt_dir: str, step: int, state) -> None:
    """Every rank gathers the state whole (DTensor leaves), rank 0 writes it."""
    state = sharding.gathered(state)
    if _is_rank0():
        checkpoint.save(ckpt_dir, step, state)


if __name__ == "__main__":
    main()
