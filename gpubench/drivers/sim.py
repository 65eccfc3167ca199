"""The simulation engine's traffic: the paper's figure run as repeated calls
of a fixed chunk of iterations.

Set-up makes the linear regression from the seed on the device, the step
size 0.5 / L, and the program that the traffic's ``engine`` names (one
`run_sweep` grid of every case selected, or, for ``looped``, one
`run_monte_carlo` program of its single case), then calls it twice
so that its graphs are captured and replayed once.  The window calls it
again with fresh replica keys until ``--seconds`` have passed, ending with
the chunk that crosses them.  Once the window has closed, one chunk drawn
from the seed is run again by the plain reference (`reference.linreg_sim`)
from the same keys, and every lane's clock, k and loss at the eval points
are compared.
"""

from __future__ import annotations

import random

import torch

from gpubench.bench import BenchError, Check, Outcome, Record, window
from gpubench.reference import linreg_sim, precision


def make_data(cfg: dict, gen: torch.Generator, dev):
    """The paper's synthetic regression (§VI): X with integer entries 1..10,
    w_bar with entries 1..100, y = X w_bar + N(0, 1) noise, all float32."""
    m, d = cfg["m"], cfg["d"]
    X = torch.randint(1, 11, (m, d), generator=gen, device=dev).to(torch.float32)
    w_bar = torch.randint(1, 101, (d,), generator=gen, device=dev).to(torch.float32)
    y = X @ w_bar + torch.randn(m, generator=gen, device=dev)
    return X, y


def step_size(X: torch.Tensor, edge_fraction: float) -> float:
    """``edge_fraction`` of the stability edge 2 / L, L = 2 lambda_max(X^T X / m),
    from a float64 eigensolve."""
    lam = torch.linalg.eigvalsh((X.T.double() @ X.double()) / X.shape[0]).max()
    return float(edge_fraction * 2.0 / (2.0 * float(lam)))


def _squared_error(w, X, y):
    r = X @ w - y
    return r * r


ENGINES = ("grid", "looped")


def _program(engine: str, cfg: dict, cases: list, eta: float, X, y, dev, chunk: int, rate: float):
    """``call(keys) -> (time, loss, k)`` each (lanes, n_evals), lanes cell-major,
    and the program's capture counter."""
    from repro_torch.core import montecarlo, sweep
    from repro_torch.core.controller import FixedKController, PflugController
    from repro_torch.core.straggler import Exponential

    n = cfg["n_workers"]
    straggler = Exponential(rate=rate)

    def controller(c):
        if c["controller"] == "pflug":
            return PflugController(n_workers=n, k0=c["k0"], step=c["step"], thresh=c["thresh"], burnin=c["burnin"],
                                   k_max=c["k_max"])
        return FixedKController(n_workers=n, k=c["k"])

    w0 = torch.zeros(cfg["d"], device=dev)
    if engine == "looped":
        ctrl = controller(cases[0])

        def call(keys):
            r = montecarlo.run_monte_carlo(_squared_error, w0, X, y, n_workers=n, controller=ctrl, straggler=straggler,
                                           eta=eta, num_iters=chunk, keys=keys, eval_every=cfg["eval_every"],
                                           device=dev)
            return r.time, r.loss, r.k

        return call, lambda: montecarlo.program_cache_stats()["traces"]
    grid = [sweep.SweepCase(controller(c), straggler, eta=eta, label=c["label"]) for c in cases]

    def call(keys):
        r = sweep.run_sweep(_squared_error, w0, X, y, n_workers=n, cases=grid, num_iters=chunk, keys=keys,
                            eval_every=cfg["eval_every"], device=dev)
        flat = lambda a: a.reshape(-1, a.shape[-1])  # noqa: E731
        return flat(r.time), flat(r.loss), flat(r.k)

    return call, lambda: sweep.sweep_cache_stats()["traces"]


def _faulty(call, fault: str, X, y):
    """The timed path broken underneath, for the calibration and the tests."""
    if fault == "unchanged":
        # a step that leaves the parameters where they were: every eval reads w = 0
        def broken(keys):
            t, loss, k = call(keys)
            return t, torch.full_like(loss, float((y * y).mean())), k
        return broken
    if fault == "answer":
        def broken(keys):
            t, loss, k = call(keys)
            loss = loss.clone()
            loss[0, -1] *= 1.01
            return t, loss, k
        return broken
    raise BenchError(f"unknown fault {fault!r}")


def compare(prog, ref, lanes) -> dict:
    """The compared numbers: the largest relative clock gap of the fixed-k
    lanes (exact arithmetic on both sides), the adaptive lanes whose k or
    clock departs at any eval point, and the largest relative loss gap over
    the lanes that do not depart."""
    (pt, pl, pk), (rt, rl, rk) = prog, ref
    pk = pk.to(torch.int64)
    fixed = torch.tensor([l.kind == linreg_sim.FIXED for l in lanes], device=pt.device)
    departs = ((pk != rk) | (pt != rt)).any(dim=1) & ~fixed
    time_gap = ((pt - rt).abs() / rt.abs())[fixed].max() if bool(fixed.any()) else torch.zeros(())
    keep = ~departs
    loss_gap = ((pl - rl).abs() / rl.abs())[keep].max()
    finite = bool(torch.isfinite(pt).all() and torch.isfinite(pl).all())
    return {"time_gap_fixed": float(time_gap) if finite else float("inf"),
            "adaptive_lanes_departed": float(departs.sum()),
            "loss_gap": float(loss_gap) if finite else float("inf")}


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    precision.no_tf32()
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    X, y = make_data(cfg, gen, dev)
    eta = step_size(X, cfg["edge_fraction"])
    cases = [c for c in cfg["cases"] if tr["cases"] == "all" or c["label"] in tr["cases"]]
    if tr["engine"] not in ENGINES or (tr["engine"] == "looped" and len(cases) != 1):
        raise BenchError(f"engine {tr['engine']!r} with {len(cases)} cases: the grid takes any, looped one")
    replicas, chunk = cfg["replicas"], tr["chunk_iters"]
    lanes = linreg_sim.lanes_of(cases, replicas)
    if cfg["straggler"]["family"] != "exponential":
        raise BenchError(f"straggler family {cfg['straggler']['family']!r}: this driver draws Exponential times")
    rate = cfg["straggler"]["rate"]

    def new_keys():
        return torch.randint(0, 2**32, (replicas, 2), generator=gen, device=dev, dtype=torch.int64)

    if ctx.control is None:
        # the half-batch fault hands the program half of the rows: each
        # gradient and loss is the mean over the rest; the draw fault moves its
        # straggler's rate by one part in a million
        half = cfg["m"] // 2 if ctx.fault == "half_batch" else cfg["m"]
        drawn = rate * (1 + 1e-6) if ctx.fault == "draw" else rate
        call, captures = _program(tr["engine"], cfg, cases, eta, X[:half], y[:half], dev, chunk, drawn)
        if ctx.fault not in (None, "half_batch", "draw"):
            call = _faulty(call, ctx.fault, X, y)
    else:
        def call(keys):
            return linreg_sim.simulate(X, y, lanes, keys.repeat(len(cases), 1), cfg["n_workers"], eta, rate, chunk,
                                       cfg["eval_every"], precision=ctx.control)
        captures = lambda: 0  # noqa: E731
    for _ in range(2):  # capture, then one replay
        out = call(new_keys())
        out[0].cpu()
    captures0 = captures()

    def one():
        keys = new_keys()
        with ctx.span("call"):
            out = call(keys)
        with ctx.span("readback"):
            out[0].cpu()
        return keys, out

    chunks, walls, elapsed = window(ctx, one, tr["trace_calls"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = len(chunks) - len(walls)
    counters = {"captures": captures() - captures0, "iterations_traced": traced * chunk, "chunks": len(walls)}

    j = random.Random(ctx.seed).randrange(len(chunks))
    keys, prog = chunks[j]
    ref = linreg_sim.simulate(X, y, lanes, keys.repeat(len(cases), 1), cfg["n_workers"], eta, rate, chunk,
                              cfg["eval_every"])
    got = compare(prog, ref, lanes)
    checks = [Check(name, value, ctx.limit(name)) for name, value in got.items()]
    lane_iters = len(walls) * len(lanes) * chunk
    return Outcome(metrics={"sim_lane_iters_per_s": lane_iters / elapsed}, attempted=len(chunks) * len(lanes),
                   failed=0, checks=checks, record=Record(ctx.tracer.trace if ctx.tracer else None, counters),
                   memory_peak_bytes=int(peak))
