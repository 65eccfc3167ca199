"""The paper's figures on the port: the twins of the figure rows of
`benchmarks/run.py` (fig1, fig2, fig3, fig_hetero, fig_async, the ablation,
fig_lm, fig_byzantine), on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.figures [--only fig1,fig3,...] [--smoke] [--device cpu]

prints ``name,us_per_call,derived`` CSV as `benchmarks/run.py` does, one
row a figure as it finishes, and writes each figure's CSV (the reference's
columns and number formats) under ``--out-dir`` (default
``results/torch/``, so the reference's ``results/`` files are never
overwritten).  fig_lm and fig_byzantine merge their ``lm`` and
``byzantine`` sections into ``BENCH_sweep_torch.json`` there.  A figure
that fails raises, and the run exits non-zero.

Each ``run_*`` returns the reference's ``{"name", "us_per_call",
"derived"}`` with its name and its ``derived`` keys; a time to target that
is never reached prints ``never`` (fig2's reference would fail to format
it).  fig2, the ablation, fig_async, fig_byzantine and fig_lm run the
grids of `launch.quickstart` (one `run_sweep` each); fig_hetero and fig3's
adaptive arm are grids of their own.  fig3's fully asynchronous baseline
is `core.async_sim`'s event-driven host loop, one device round trip an
event (about 50 events a unit of simulated time at n = 50); ``async_seeds``
and ``async_horizon`` cut it, and its events a second are returned beside
the row.  fig_async measures the K = 1 K-async engine against that host
loop (``engine_vs_host``; the reference's `benchmarks/run.py` leaves it to
its sweep bench, which the port does not have).

``--smoke`` runs the reference scripts' smoke sizes: 200 iterations, R = 8,
the loss every 50 iterations (fig_lm: 60, R = 2, every 15), no
engine-vs-host bench.  Every ``run_*`` takes ``eta`` (and fig_hetero
``t1_times``) to override what it derives from the data: the parity tests
pass the reference's, since the two packages' eigensolvers and
least-squares solvers differ in the last ulps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.async_sim import simulate_async_sgd
from repro_torch.core.controller import FixedKController, PflugController, ScheduleController
from repro_torch.core.montecarlo import run_monte_carlo
from repro_torch.core.straggler import Exponential, Pareto, RateSchedule, WorkerFleet
from repro_torch.core.sweep import SweepCase, run_sweep, summarize_cells
from repro_torch.core.theory import (
    SGDSystem,
    adaptive_bound_curve,
    error_bound,
    example1_system,
    switching_times,
)
from repro_torch.data import least_squares, make_linreg_data
from repro_torch.launch import quickstart
from repro_torch.launch.quickstart import squared_error, step_size, time_to_target

OUT_DIR = os.path.join("results", "torch")
BENCH_JSON = "BENCH_sweep_torch.json"
SMOKE = dict(iters=200, n_replicas=8, eval_every=50)
LM_SMOKE = dict(iters=60, n_replicas=2, eval_every=15)
# benchmarks/fig3.py: §V-C, adaptive from k = 1 in steps of 5 up to 36 at
# eta 0.4/L; the async baseline at eta/10 (the sync-stable step diverges
# under async staleness), over a few seeds of the host loop.
FIG3 = dict(m=2000, d=100, n=50, iters=40_000, replicas=32, eval_every=500, async_seeds=4, async_eval_every=200,
            adaptive=dict(k0=1, step=5, thresh=10, burnin=200, k_max=36))
# benchmarks/fig_hetero.py: 14 Exp(1) and 6 Exp(0.25) workers, every rate
# times 0.4 from t = 800; 12 000 iterations, since the two-speed fleet's
# transient outlasts 4000.
HETERO = dict(m=400, d=20, n=20, iters=12_000, replicas=32, eval_every=100, n_fast=14, n_slow=6, slow_factor=4.0,
              slowdown_t=800.0, slowdown_scale=0.4, k0=4, k_step=4, k_cap=16)
TRAJECTORY_HEADER = "run,iteration,time_mean,time_ci95,excess_mean,excess_ci95,k_mean\n"


def _fmt(t):
    return f"{t:.0f}" if t is not None else "never"


def _excess(out: dict) -> dict:
    return {name: s["loss_mean"] - out["f_star"] for name, s in out["cases"].items()}


def _write_trajectories(csv_path: str, out: dict) -> None:
    """fig2's and fig_hetero's CSV: each cell's replica-mean trajectory."""
    excess = _excess(out)
    with open(csv_path, "w") as f:
        f.write(TRAJECTORY_HEADER)
        for name, s in out["cases"].items():
            for i in range(len(s["iteration"])):
                f.write(f"{name},{s['iteration'][i]},{s['time_mean'][i]:.2f},{s['time_ci95'][i]:.3f},"
                        f"{excess[name][i]:.6g},{s['loss_ci95'][i]:.6g},{s['k_mean'][i]:.2f}\n")


def _merge_bench(bench_json: str, section: str, record: dict) -> None:
    rec = {}
    if os.path.exists(bench_json):
        with open(bench_json) as f:
            rec = json.load(f)
    rec[section] = record
    with open(bench_json, "w") as f:
        json.dump(rec, f, indent=2)


# ----------------------------------------------------------------- fig1


def run_fig1(csv_path: str | None = None) -> dict:
    """Fig. 1 / Example 1: the Lemma-1 bound for fixed k = 1..5 and the
    Theorem-1 adaptive envelope (numpy only), with the reference's four
    checks of the paper's observations."""
    sys_ = example1_system()
    t0 = time.perf_counter()
    switches = switching_times(sys_)
    grid = np.linspace(0, 6e4, 4000)
    curves = {f"fixed_k{k}": error_bound(sys_, k, grid) for k in range(1, 6)}
    curves["adaptive"] = adaptive_bound_curve(sys_, grid)
    dt_us = (time.perf_counter() - t0) * 1e6

    assert all(b >= a for a, b in zip(switches, switches[1:])), "t_k must increase"
    for k in range(1, 6):
        assert np.all(curves["adaptive"] <= curves[f"fixed_k{k}"] + 1e-9)
    # early on k = 1 is best; at the end the adaptive curve reaches the k = 5 floor
    assert curves["fixed_k1"][10] == min(curves[f"fixed_k{k}"][10] for k in range(1, 6))
    assert abs(curves["adaptive"][-1] - sys_.error_floor(5)) / sys_.error_floor(5) < 0.05

    if csv_path:
        cols = ["t"] + sorted(curves)
        arr = np.column_stack([grid] + [curves[c] for c in sorted(curves)])
        np.savetxt(csv_path, arr, delimiter=",", header=",".join(cols), comments="")
    return {"name": "fig1_theory_bounds", "us_per_call": dt_us,
            "derived": ";".join(f"t_{i + 1}={t:.0f}" for i, t in enumerate(switches))}


# ----------------------------------------------------------------- fig2


def run_fig2(csv_path: str | None = None, iters: int | None = None, n_replicas: int | None = None,
             eval_every: int | None = None, device="cuda", eta: float | None = None) -> dict:
    """Fig. 2 (§V-B): adaptive against fixed k = 10, 20, 30, 40 as one grid;
    the time to 1.1x fixed k = 40's final excess."""
    out = quickstart.run("fig2", iters=iters, replicas=n_replicas, device=device, eta=eta, eval_every=eval_every)
    runs = out["cases"]
    target = _excess(out)["fixed_k40"][-1] * 1.10
    ttt = time_to_target(out, target=target)
    t_adapt, t_k40 = ttt["adaptive"], ttt["fixed_k40"]
    speedup = (t_k40 / t_adapt) if (t_adapt and t_k40) else float("nan")
    if csv_path:
        _write_trajectories(csv_path, out)
    r = runs["adaptive"]["n_replicas"]
    return {"name": "fig2_adaptive_vs_fixed", "us_per_call": out["wall_s"] * 1e6,
            "derived": f"replicas={r};cells={len(runs)};dispatches=1;time_to_target_adaptive={_fmt(t_adapt)};"
                       f"fixed_k40={_fmt(t_k40)};speedup={speedup:.2f}x;k_final={runs['adaptive']['k_mean'][-1]:.1f}"}


# ----------------------------------------------------------------- fig3


def async_host_loop(data, n: int, eta: float, straggler, total_time: float, key, eval_every: int):
    """`core.async_sim`'s event-driven fully asynchronous SGD on ``data``
    (a `LinRegData`) over ``n`` workers, on its device: worker i's gradient
    is the mean loss's over its shard of m / n rows, the loss the mean over
    all rows, as fig3's and the reference's bench's closures are."""
    X, y = data.X, data.y
    s = X.shape[0] // n

    def grad_fn(w, i):
        Xi, yi = X[i * s:(i + 1) * s], y[i * s:(i + 1) * s]
        return torch.func.grad(lambda p: squared_error(p, Xi, yi).mean())(w)

    return simulate_async_sgd(grad_fn, lambda w: squared_error(w, X, y).mean(),
                              torch.zeros(X.shape[1], device=X.device), n_workers=n, eta=eta, straggler=straggler,
                              total_time=total_time, key=key, eval_every=eval_every, device=X.device)


def fig3_adaptive(iters: int | None = None, n_replicas: int | None = None, eval_every: int | None = None,
                  device="cuda", eta: float | None = None) -> dict:
    """fig3's adaptive arm as a 1-cell grid: {"data", "eta", "stats",
    "result", "wall_s"}."""
    dev = resolve_device(device)
    data = make_linreg_data(prng.PRNGKey(0, device=dev), m=FIG3["m"], d=FIG3["d"], device=dev)
    eta = step_size(data.X, 0.2) if eta is None else eta  # 0.4 / L
    case = SweepCase(PflugController(n_workers=FIG3["n"], **FIG3["adaptive"]), Exponential(rate=1.0), eta=eta,
                     label="adaptive")
    t0 = time.perf_counter()
    result = run_sweep(squared_error, torch.zeros(FIG3["d"], device=dev), data.X, data.y, n_workers=FIG3["n"],
                       cases=[case], num_iters=iters or FIG3["iters"], key=prng.PRNGKey(1, device=dev),
                       n_replicas=n_replicas or FIG3["replicas"], eval_every=eval_every or FIG3["eval_every"],
                       device=dev)
    stats = summarize_cells(result)["adaptive"]
    return {"data": data, "eta": eta, "stats": stats, "result": result, "wall_s": time.perf_counter() - t0}


def run_fig3(csv_path: str | None = None, iters: int | None = None, n_replicas: int | None = None,
             eval_every: int | None = None, device="cuda", eta: float | None = None,
             async_seeds: int | None = None, async_horizon: float | None = None) -> dict:
    """Fig. 3 (§V-C): adaptive fastest-k against fully asynchronous SGD.
    The async arm runs ``async_seeds`` host-loop seeds (keys 2, 3, ...) up
    to the adaptive arm's final mean simulated time, or ``async_horizon``
    when that is sooner (then ``derived`` ends with ``async_horizon=``).
    The row also carries ``async_rate``: the host loop's events, seconds
    and events a second over all seeds, its device, the horizon and the
    adaptive arm's eta (the host loop's is a tenth of it)."""
    adaptive = fig3_adaptive(iters, n_replicas, eval_every, device, eta)
    data, stats = adaptive["data"], adaptive["stats"]
    t0 = time.perf_counter()
    total_time = float(stats["time_mean"][-1])
    horizon = total_time if async_horizon is None else min(total_time, async_horizon)
    async_finals, async_hist, events = [], None, 0
    for seed in range(FIG3["async_seeds"] if async_seeds is None else async_seeds):
        h = async_host_loop(data, FIG3["n"], adaptive["eta"] / 10.0, Exponential(rate=1.0), horizon,
                            prng.PRNGKey(2 + seed, device=data.X.device), FIG3["async_eval_every"])
        async_finals.append(h["loss"][-1])
        events += h["updates"][-1] if h["updates"] else 0
        if async_hist is None:
            async_hist = h  # the CSV's trajectory
    async_s = time.perf_counter() - t0
    dt_us = (adaptive["wall_s"] + async_s) * 1e6

    f_star = data.f_star
    final_adapt = float(stats["loss_mean"][-1] - f_star)
    final_async = float(np.mean(async_finals) - f_star)
    if csv_path:
        with open(csv_path, "w") as f:
            f.write("run,time,excess_loss,excess_ci95\n")
            for t, lo, ci in zip(stats["time_mean"], stats["loss_mean"], stats["loss_ci95"]):
                f.write(f"adaptive,{t:.2f},{lo - f_star:.6g},{ci:.6g}\n")
            for t, lo in zip(async_hist["time"], async_hist["loss"]):
                f.write(f"async,{t:.2f},{lo - f_star:.6g},0\n")
    return {"name": "fig3_adaptive_vs_async", "us_per_call": dt_us,
            "derived": f"replicas={stats['n_replicas']};"
                       f"final_excess_adaptive={final_adapt:.4g}+-{float(stats['loss_ci95'][-1]):.2g};"
                       f"final_excess_async={final_async:.4g};"
                       f"async_updates={async_hist['updates'][-1] if async_hist['updates'] else 0}"
                       + (f";async_horizon={horizon:.2f}" if horizon < total_time else ""),
            "async_rate": {"events": events, "seconds": async_s, "events_per_s": events / async_s,
                           "device": str(data.X.device), "horizon": horizon, "eta": adaptive["eta"]}}


# ----------------------------------------------------------------- fig_hetero


def hetero_fleets():
    """(the two-speed fleet, the mixed Exp/Pareto(1, 2.5) fleet), both under
    the mid-run slowdown."""
    c = HETERO
    fast, slow = Exponential(rate=1.0), Exponential(rate=1.0 / c["slow_factor"])
    drift = RateSchedule(times=(c["slowdown_t"],), scales=(c["slowdown_scale"],))
    two_speed = WorkerFleet(models=(fast,) * c["n_fast"] + (slow,) * c["n_slow"], schedule=drift)
    mixed = WorkerFleet(models=(fast,) * c["n_fast"] + (Pareto(x_m=1.0, alpha=2.5),) * c["n_slow"], schedule=drift)
    return two_speed, mixed


def hetero_t1_times(data, eta: float, straggler) -> list:
    """Theorem-1 switch times from the fleet's exact order statistics at
    nominal rates (blind to the drift), with the SGD constants measured on
    the data: L and c the extreme Hessian eigenvalues, sigma^2 the
    per-example gradient's second moment at the least-squares optimum
    (solved on the data's device), F0_gap the initial excess."""
    c = HETERO
    X, y = data.X, data.y
    eigs = torch.linalg.eigvalsh(2 * X.T @ X / c["m"])
    w_ls = least_squares(X, y)
    g_i = 2.0 * X * (X @ w_ls - y)[:, None]
    sigma2 = float((g_i * g_i).sum(dim=1).mean())
    f0_gap = float((y * y).mean()) - data.f_star  # the loss at w0 = 0
    sysm = SGDSystem(eta=eta, L=float(eigs[-1]), c=float(eigs[0]), sigma2=sigma2, s=c["m"] // c["n"],
                     F0_gap=f0_gap, n=c["n"], straggler=straggler)
    return switching_times(sysm, list(range(c["k0"], c["k_cap"], c["k_step"])), step=c["k_step"])


def hetero_cases(eta: float, t1_times) -> list:
    c = HETERO
    n, k0, k_step, k_cap = c["n"], c["k0"], c["k_step"], c["k_cap"]
    two_speed, mixed = hetero_fleets()
    adaptive = PflugController(n_workers=n, k0=k0, step=k_step, thresh=10, burnin=40, k_max=k_cap)
    return [
        SweepCase(adaptive, two_speed, eta=eta, label="adaptive"),
        SweepCase(FixedKController(n_workers=n, k=k0), two_speed, eta=eta, label=f"fixed_k{k0}"),
        SweepCase(FixedKController(n_workers=n, k=k_cap), two_speed, eta=eta, label=f"fixed_k{k_cap}"),
        SweepCase(ScheduleController(n_workers=n, switch_times=t1_times, k0=k0, step=k_step), two_speed, eta=eta,
                  label="schedule_t1"),
        SweepCase(adaptive, mixed, eta=eta, label="adaptive_mixed"),
    ]


def hetero_grid(iters: int | None = None, n_replicas: int | None = None, eval_every: int | None = None,
                device="cuda", eta: float | None = None, t1_times=None) -> dict:
    """fig_hetero's five cells as one grid, as `quickstart.run` returns a
    setup's: {"f_star", "f0_excess", "eta", "t1_times", "wall_s", "cases":
    {label: summary}, "results": {label: result}}.  ``eta`` overrides 0.5
    / L, ``t1_times`` the Theorem-1 switch times."""
    c = HETERO
    dev = resolve_device(device)
    data = make_linreg_data(prng.PRNGKey(0, device=dev), m=c["m"], d=c["d"], device=dev)
    keys = prng.split(prng.PRNGKey(1, device=dev), n_replicas or c["replicas"])
    if eta is None:
        eta = 0.5 / float(torch.linalg.eigvalsh(2 * data.X.T @ data.X / c["m"])[-1])
    if t1_times is None:
        t1_times = hetero_t1_times(data, eta, hetero_fleets()[0])
    grid = hetero_cases(eta, t1_times)
    t0 = time.perf_counter()
    res = run_sweep(squared_error, torch.zeros(c["d"], device=dev), data.X, data.y, n_workers=c["n"], cases=grid,
                    num_iters=iters or c["iters"], keys=keys, eval_every=eval_every or c["eval_every"], device=dev)
    results = {label: res.cell(g) for g, label in enumerate(res.labels)}
    cases = summarize_cells(res)
    f0 = float((data.y * data.y).mean())
    return {"f_star": data.f_star, "f0_excess": f0 - data.f_star, "eta": eta, "t1_times": list(t1_times),
            "wall_s": time.perf_counter() - t0, "cases": cases, "results": results}


def run_fig_hetero(csv_path: str | None = None, iters: int | None = None, n_replicas: int | None = None,
                   eval_every: int | None = None, device="cuda", eta: float | None = None, t1_times=None) -> dict:
    """The heterogeneity figure: fixed k against adaptive k on the two-speed
    fleet with a mid-run slowdown, the Theorem-1 schedule and the mixed
    fleet; the time to 1.1x fixed k = 16's final excess."""
    out = hetero_grid(iters, n_replicas, eval_every, device, eta, t1_times)
    runs, k_cap = out["cases"], HETERO["k_cap"]
    target = _excess(out)[f"fixed_k{k_cap}"][-1] * 1.10
    ttt = time_to_target(out, target=target)
    t_adapt, t_kcap = ttt["adaptive"], ttt[f"fixed_k{k_cap}"]
    speedup = (t_kcap / t_adapt) if (t_adapt and t_kcap) else float("nan")
    if csv_path:
        _write_trajectories(csv_path, out)
    return {"name": "fig_hetero_two_speed_drift", "us_per_call": out["wall_s"] * 1e6,
            "derived": f"replicas={runs['adaptive']['n_replicas']};cells={len(runs)};dispatches=1;"
                       f"t1_switches={[round(t, 1) for t in out['t1_times']]};"
                       f"time_to_target_adaptive={_fmt(t_adapt)};fixed_k{k_cap}={_fmt(t_kcap)};"
                       f"speedup={speedup:.2f}x;k_final={runs['adaptive']['k_mean'][-1]:.1f}"}


# ----------------------------------------------------------------- fig_async


def async_engine_vs_host(iters: int, replicas: int, seed: int = 0, device="cuda") -> dict:
    """Warm per-update throughput of the K = 1 K-async engine
    (`run_monte_carlo(mode="kasync")`, ``iters`` updates x ``replicas``)
    against the event-driven host loop over the same simulated horizon, on
    fig_async's data at the async-stable eta 0.05 / L: the port of
    `benchmarks/sweep_bench.py::async_engine_vs_host`."""
    cfg = quickstart.SETUPS["async"]
    n, m, d = cfg["n"], cfg["m"], cfg["d"]
    dev = resolve_device(device)
    data = make_linreg_data(prng.PRNGKey(seed, device=dev), m=m, d=d, device=dev)
    eta = step_size(data.X, 0.025)
    w0 = torch.zeros(d, device=dev)
    keys = prng.split(prng.PRNGKey(seed + 1, device=dev), replicas)
    strag, ctrl = Exponential(rate=1.0), FixedKController(n_workers=n, k=1)
    eval_every = max(1, iters // 8)

    def engine():
        r = run_monte_carlo(squared_error, w0, data.X, data.y, n_workers=n, controller=ctrl, straggler=strag,
                            eta=eta, num_iters=iters, keys=keys, eval_every=eval_every, mode="kasync", device=dev)
        r.loss.cpu()
        return r

    res = engine()  # cold: the capture is charged here, not to the warm number
    t0 = time.perf_counter()
    res = engine()
    engine_warm = time.perf_counter() - t0
    total_time = float(res.time[:, -1].double().mean())

    def host(total, key):
        return async_host_loop(data, n, eta, strag, total, prng.PRNGKey(key, device=dev), eval_every)

    host(total_time / 10.0, seed + 3)  # untimed warm-up, as the reference's
    t0 = time.perf_counter()
    h = host(total_time, seed + 2)
    host_s = time.perf_counter() - t0
    host_updates = int(h["updates"][-1]) if h["updates"] else 1
    speedup = (host_s / host_updates) / (engine_warm / (iters * replicas))
    return {"engine_warm_s": round(engine_warm, 3), "host_s": round(host_s, 3), "updates": iters,
            "replicas": replicas, "host_updates": host_updates, "speedup_per_update": round(speedup, 1)}


def run_fig_async(csv_path: str | None = None, iters: int | None = None, n_replicas: int | None = None,
                  eval_every: int | None = None, bench_iters: int | None = 2000, device="cuda",
                  eta: float | None = None) -> dict:
    """The execution-mode figure: adaptive against K-async and
    K-batch-async on the two-speed fleet as one grid; the time to 1e-3 of
    the initial excess; ``bench_iters`` None skips `async_engine_vs_host`."""
    out = quickstart.run("async", iters=iters, replicas=n_replicas, device=device, eta=eta, eval_every=eval_every)
    runs, excess = out["cases"], _excess(out)
    t_to = time_to_target(out)
    speed = None
    if bench_iters is not None:
        speed = async_engine_vs_host(iters=bench_iters, replicas=runs["adaptive"]["n_replicas"], device=device)
    if csv_path:
        mode_of = {c.label: c.mode for c in quickstart.cases("async")}
        with open(csv_path, "w") as f:
            f.write("run,mode,iteration,time_mean,time_ci95,excess_mean,excess_ci95,k_mean\n")
            for name, s in runs.items():
                for i in range(len(s["iteration"])):
                    f.write(f"{name},{mode_of[name]},{s['iteration'][i]},{s['time_mean'][i]:.2f},"
                            f"{s['time_ci95'][i]:.3f},{excess[name][i]:.6g},{s['loss_ci95'][i]:.6g},"
                            f"{s['k_mean'][i]:.2f}\n")
    return {"name": "fig_async_adaptive_vs_stale", "us_per_call": out["wall_s"] * 1e6,
            "derived": f"replicas={runs['adaptive']['n_replicas']};cells={len(runs)};dispatches=1;"
                       + ";".join(f"t_target_{n}={_fmt(t_to[n])}" for n in t_to)
                       + f";k_final_kasync_adaptive={runs['kasync_adaptive']['k_mean'][-1]:.1f}"
                       + (f";engine_vs_host={speed['speedup_per_update']:.0f}x" if speed is not None else "")}


# ----------------------------------------------------------------- ablation


def ablation_rows(out: dict) -> list:
    """Per (straggler, controller): the time to 1.1x that straggler's fixed
    k = 40 final excess, the final excess with its CI, and the final k."""
    rows = []
    for sname in quickstart.ABLATION_STRAGGLERS:
        stats = {label.split("|")[1]: s for label, s in out["cases"].items() if label.split("|")[0] == sname}
        target = (stats["fixed_k40"]["loss_mean"][-1] - out["f_star"]) * 1.10
        ttt = time_to_target({"f_star": out["f_star"], "cases": stats}, target=target)
        rows += [{"straggler": sname, "controller": cname, "time_to_target": ttt[cname],
                  "final_excess": float(s["loss_mean"][-1] - out["f_star"]),
                  "final_excess_ci95": float(s["loss_ci95"][-1]), "k_final": float(s["k_mean"][-1])}
                 for cname, s in stats.items()]
    return rows


def run_ablation(csv_path: str | None = None, iters: int | None = None, n_replicas: int | None = None,
                 eval_every: int | None = None, device="cuda", eta: float | None = None) -> dict:
    """The ablation: every controller x straggler family as one grid, each
    cell's time to target and the best adaptive controller's speedup over
    fixed k = 40 per family."""
    out = quickstart.run("ablation", iters=iters, replicas=n_replicas, device=device, eta=eta,
                         eval_every=eval_every)
    rows = ablation_rows(out)
    if csv_path:
        with open(csv_path, "w") as f:
            f.write("straggler,controller,time_to_target,final_excess,final_excess_ci95,k_final\n")
            for r in rows:
                f.write(f"{r['straggler']},{r['controller']},{r['time_to_target']},{r['final_excess']:.6g},"
                        f"{r['final_excess_ci95']:.6g},{r['k_final']:.2f}\n")
    parts = []
    for sname in quickstart.ABLATION_STRAGGLERS:
        sub = {r["controller"]: r for r in rows if r["straggler"] == sname}
        t40 = sub["fixed_k40"]["time_to_target"]
        best = min((c for c in ("pflug", "theory_schedule", "variance_ratio") if sub[c]["time_to_target"]),
                   key=lambda c: sub[c]["time_to_target"], default=None)
        parts.append(f"{sname}:best={best}:{t40 / sub[best]['time_to_target']:.2f}x" if best and t40
                     else f"{sname}:no_target")
    r = next(iter(out["cases"].values()))["n_replicas"]
    return {"name": "ablation_controllers_x_stragglers", "us_per_call": out["wall_s"] * 1e6,
            "derived": f"replicas={r};cells={len(rows)};dispatches=1;" + ";".join(parts)}


# ----------------------------------------------------------------- fig_lm


def run_fig_lm(csv_path: str | None = None, iters: int | None = None, n_replicas: int | None = None,
               eval_every: int | None = None, bench_json: str | None = None, smoke: bool = False,
               device="cuda", params0=None) -> dict:
    """The LM figure: adaptive against fixed k and the Theorem-1 schedule
    on a shrunk qwen1.5-0.5b's CE, as one grid (``params0``: see
    `quickstart.run_lm`)."""
    out = quickstart.run_lm(iters=iters, replicas=n_replicas, device=device, eval_every=eval_every,
                            params0=params0)
    runs = out["cases"]
    if csv_path:
        with open(csv_path, "w") as f:
            f.write("run,iteration,time_mean,time_ci95,loss_mean,loss_ci95,k_mean\n")
            for name, s in runs.items():
                for i in range(len(s["iteration"])):
                    f.write(f"{name},{s['iteration'][i]},{s['time_mean'][i]:.2f},{s['time_ci95'][i]:.3f},"
                            f"{s['loss_mean'][i]:.6g},{s['loss_ci95'][i]:.6g},{s['k_mean'][i]:.2f}\n")
    final_ce = float(runs["adaptive"]["loss_mean"][-1])
    r, n_iters = runs["adaptive"]["n_replicas"], int(runs["adaptive"]["iteration"][-1])
    if bench_json:
        _merge_bench(bench_json, "lm", {"cells": len(runs), "replicas": r, "iters": n_iters, "smoke": smoke,
                                        "dispatch_s": out["wall_s"], "final_ce": final_ce})
    k0, k_cap = quickstart.LM["k0"], quickstart.LM["k_cap"]
    return {"name": "fig_lm_adaptive_k", "us_per_call": out["wall_s"] * 1e6,
            "derived": f"replicas={r};cells={len(runs)};dispatches=1;iters={n_iters};"
                       f"t1_switches={[round(t, 1) for t in out['t1_times']]};final_ce_adaptive={final_ce:.4f};"
                       f"final_ce_k{k0}={runs[f'fixed_k{k0}']['loss_mean'][-1]:.4f};"
                       f"final_ce_k{k_cap}={runs[f'fixed_k{k_cap}']['loss_mean'][-1]:.4f};"
                       f"k_final={runs['adaptive']['k_mean'][-1]:.1f}"}


# ----------------------------------------------------------------- fig_byzantine


def run_fig_byzantine(csv_path: str | None = None, iters: int | None = None, n_replicas: int | None = None,
                      eval_every: int | None = None, bench_json: str | None = None, smoke: bool = False,
                      device="cuda", eta: float | None = None) -> dict:
    """The robustness figure: adaptive and fixed k under 0, 10 and 30%
    rushing sign-flip workers x the weighted mean and the geometric median,
    as one grid; the reference's headline flags at k = 16 and 30%."""
    out = quickstart.run("byzantine", iters=iters, replicas=n_replicas, device=device, eta=eta,
                         eval_every=eval_every)
    runs, excess = out["cases"], _excess(out)
    t_to = time_to_target(out)
    flags = quickstart.headline(out)
    r = runs["adaptive|mean|byz0"]["n_replicas"]
    if csv_path:
        frac_of = {f"byz{int(round(f * 100))}": f for f in quickstart.SETUPS["byzantine"]["byz_fracs"]}
        with open(csv_path, "w") as f:
            f.write("run,arm,agg,byz_frac,iteration,time_mean,time_ci95,excess_mean,excess_ci95,k_mean\n")
            for name, s in runs.items():
                arm, atag, tag = name.split("|")
                for i in range(len(s["iteration"])):
                    f.write(f"{name},{arm},{atag},{frac_of[tag]},{s['iteration'][i]},{s['time_mean'][i]:.2f},"
                            f"{s['time_ci95'][i]:.3f},{excess[name][i]:.6g},{s['loss_ci95'][i]:.6g},"
                            f"{s['k_mean'][i]:.2f}\n")
    if bench_json:
        _merge_bench(bench_json, "byzantine", {
            "cells": len(runs), "replicas": r, "iters": int(runs["adaptive|mean|byz0"]["iteration"][-1]),
            "smoke": smoke, "dispatch_s": out["wall_s"], "final_excess_gm_b30": flags["excess_gm_k16_b30"],
            "mean_diverged_b30": bool(flags["mean_diverged_b30"]), "gm_recovered_b30": bool(flags["gm_recovered_b30"])})
    exc_mean, exc_gm = flags["excess_mean_k16_b30"], flags["excess_gm_k16_b30"]
    return {"name": "fig_byzantine_robust_agg", "us_per_call": out["wall_s"] * 1e6,
            "derived": f"replicas={r};cells={len(runs)};dispatches=1;excess_mean_k16_b30={exc_mean:.3g};"
                       f"excess_gm_k16_b30={exc_gm:.3g};mean_diverged_b30={flags['mean_diverged_b30']};"
                       f"gm_recovered_b30={flags['gm_recovered_b30']};"
                       f"t_target_adaptive_b0={_fmt(t_to['adaptive|mean|byz0'])};"
                       f"t_target_k16_b0={_fmt(t_to['k16|mean|byz0'])};"
                       f"t_target_gm_k16_b30={_fmt(t_to['k16|gm|byz30'])}"}


# ----------------------------------------------------------------- main

FIGURES = ("fig1", "fig2", "fig3", "fig_hetero", "fig_async", "ablation", "fig_lm", "fig_byzantine")


def _jobs(out_dir: str, smoke: bool, device, async_seeds, async_horizon) -> dict:
    size = SMOKE if smoke else {}
    bench = os.path.join(out_dir, BENCH_JSON)
    csv = {name: os.path.join(out_dir, f"{name}.csv") for name in FIGURES}
    return {
        "fig1": lambda: run_fig1(csv["fig1"]),
        "fig2": lambda: run_fig2(csv["fig2"], device=device, **size),
        "fig3": lambda: run_fig3(csv["fig3"], device=device, async_seeds=async_seeds, async_horizon=async_horizon,
                                 **size),
        "fig_hetero": lambda: run_fig_hetero(csv["fig_hetero"], device=device, **size),
        "fig_async": lambda: run_fig_async(csv["fig_async"], device=device, bench_iters=None if smoke else 2000,
                                           **size),
        "ablation": lambda: run_ablation(csv["ablation"], device=device, **size),
        "fig_lm": lambda: run_fig_lm(csv["fig_lm"], bench_json=bench, smoke=smoke, device=device,
                                     **(LM_SMOKE if smoke else {})),
        "fig_byzantine": lambda: run_fig_byzantine(csv["fig_byzantine"], bench_json=bench, smoke=smoke,
                                                   device=device, **size),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(FIGURES), help=f"comma list from {','.join(FIGURES)}")
    ap.add_argument("--smoke", action="store_true", help="the reference scripts' smoke sizes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=OUT_DIR, help="where the CSVs and BENCH_sweep_torch.json go")
    ap.add_argument("--async-seeds", type=int, default=None, help="fig3: host-loop seeds (default 4)")
    ap.add_argument("--async-horizon", type=float, default=None,
                    help="fig3: cut the host loop at this simulated time (default: the adaptive arm's)")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n]
    unknown = sorted(set(names) - set(FIGURES))
    if unknown:
        raise SystemExit(f"--only: unknown figures {unknown}; options {list(FIGURES)}")
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    jobs = _jobs(args.out_dir, args.smoke, device, args.async_seeds, args.async_horizon)
    print("name,us_per_call,derived", flush=True)
    rows = []
    for name in names:
        t0 = time.perf_counter()
        row = jobs[name]()
        rows.append(row)
        print(f"{row['name']},{row['us_per_call']:.1f},{row['derived']}", flush=True)
        extra = f"; async host loop {row['async_rate']}" if "async_rate" in row else ""
        print(f"{name}: {time.perf_counter() - t0:.2f} s on {device}{extra}", file=sys.stderr, flush=True)
    return rows


if __name__ == "__main__":
    main()
