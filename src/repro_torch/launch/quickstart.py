"""Adaptive against fixed-k fastest-k SGD on the paper's linear regression,
as replica means with 95% CIs: the port of `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup fig2 --iters 40000 --replicas 32
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup ablation [--looped]
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup async [--looped]
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup byzantine [--looped]
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup lm [--looped]

``quickstart`` (the default): n = 20 workers, m = 400, d = 20, R = 16,
Algorithm 1's Pflug test (k0 = 2, step 4, thresh 10, burn-in 40) against
fixed k = 2, 8000 iterations.  ``fig2``: §V-B of the paper, n = 50,
m = 2000, d = 100, exp(1) response times, adaptive (k0 = 10, step 10,
thresh 10, burn-in 200, k_max 40) against fixed k = 10, 20, 30, 40,
eta = 0.5/L, the loss evaluated every 500 iterations.  ``ablation``
(`benchmarks/ablation.py`): Pflug, the Theorem-1 schedule (its switch
times estimated from the data), variance ratio, fixed k = 10 and 40, each
under Exponential(1), Pareto(0.5, 1.5) and Bimodal(0.5, 10, 0.1), at
fig2's m, d and n, R = 8, 30 000 iterations.  ``async``
(`benchmarks/fig_async.py`): a two-speed fleet of n = 20 workers (14
Exponential(1), 6 Exponential(0.25)), m = 400, d = 20, R = 32, eta =
0.5/L, 6000 iterations, five arms: adaptive (Pflug sync, k0 = 4, step 4,
thresh 10, burn-in 40, k_max 16), fixed k = 16 sync, K-async and
K-batch-async at K = 4, and Pflug under K-async; the loss evaluated every
100 iterations.  ``byzantine`` (`benchmarks/fig_byzantine.py`): a rushing
Byzantine fleet of n = 20 (the last round(frac n) workers Exponential(2),
the rest Exponential(1)), m = 400, d = 20, R = 32, eta = 0.75 * 2/L, 6000
iterations, the loss every 100: sign-flip fractions 0, 0.1, 0.3 x the
weighted mean and the geometric median x adaptive (Pflug 4 -> 16, step 4,
thresh 10, burn-in 40), fixed k = 4 and k = 16, 18 cells; it also prints
the reference's two headline flags (the mean at k = 16 and 30% diverged,
the geometric median there recovered).  Every setup prints each case's
simulated time to reach 1e-3 of the initial excess loss (fig_async's
target), its own f* subtracted.

A setup runs as one `run_sweep` call, every case a cell of one grid, as
the reference's example does; ``--looped`` runs each case as a
`run_monte_carlo` call of its own instead.  Data from key 0, replica keys
split from key 1; on the card by default.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.controller import (
    FixedKController,
    PflugController,
    ScheduleController,
    VarianceRatioController,
)
from repro_torch.core.faults import byzantine_plan
from repro_torch.core.montecarlo import run_monte_carlo, run_monte_carlo_source, summarize
from repro_torch.core.straggler import Bimodal, Exponential, Pareto, WorkerFleet
from repro_torch.core.sweep import SweepCase, run_sweep, run_sweep_source
from repro_torch.core.tree import tree_leaves
from repro_torch.core.theory import SGDSystem, switching_times
from repro_torch.data import make_linreg_data
from repro_torch.launch.lm_source import LMSource

SETUPS = {
    "quickstart": dict(m=400, d=20, n=20, replicas=16, iters=8000, eval_every=1000,
                       adaptive=dict(k0=2, step=4, thresh=10, burnin=40), fixed=(2,)),
    "fig2": dict(m=2000, d=100, n=50, replicas=32, iters=40_000, eval_every=500,
                 adaptive=dict(k0=10, step=10, thresh=10, burnin=200, k_max=40), fixed=(10, 20, 30, 40)),
    "ablation": dict(m=2000, d=100, n=50, replicas=8, iters=30_000, eval_every=500),
    "async": dict(m=400, d=20, n=20, replicas=32, iters=6000, eval_every=100, n_fast=14, n_slow=6, slow_factor=4.0,
                  adaptive=dict(k0=4, step=4, thresh=10, burnin=40, k_max=16), k_async=4),
    "byzantine": dict(m=400, d=20, n=20, replicas=32, iters=6000, eval_every=100, byz_fracs=(0.0, 0.1, 0.3),
                      byz_rate=2.0, edge_fraction=0.75, adaptive=dict(k0=4, step=4, thresh=10, burnin=40, k_max=16),
                      fixed=(4, 16)),
}
# benchmarks/fig_lm.py: a real registered architecture, shrunk so the grid
# stays minutes.
LM = dict(arch="qwen1.5-0.5b", overrides=(("n_layers", 2), ("d_model", 64), ("n_heads", 4), ("n_kv_heads", 4),
                                          ("d_ff", 128), ("vocab_size", 256)),
          n=16, rows=32, seq=32, replicas=8, iters=600, eval_every=30, eta=0.1, k0=4, k_step=4, k_cap=16,
          adaptive=dict(thresh=5, burnin=10))
# fig_byzantine's headline bars on the final excess loss at k = 16 and 30%
# sign-flip workers: the weighted mean has diverged above the first (or is
# not finite), the geometric median has recovered below the second.
DIVERGED_ABOVE, RECOVERED_BELOW = 1e4, 10.0
ABLATION_STRAGGLERS = {
    "exp": Exponential(rate=1.0),
    "pareto": Pareto(x_m=0.5, alpha=1.5),
    "bimodal": Bimodal(fast_mean=0.5, slow_mean=10.0, p_slow=0.1),
}


def squared_error(w, X, y):
    r = X @ w - y
    return r * r


def step_size(X: torch.Tensor, edge_fraction: float = 0.25) -> float:
    """``edge_fraction`` of the stability edge 2 / L (0.5 / L by default),
    with L = 2 * the largest eigenvalue of X^T X / m (float32)."""
    lam = torch.linalg.eigvalsh(X.T @ X / X.shape[0]).max()
    return edge_fraction * 2.0 / (2 * float(lam))


def estimate_system(data, eta: float, straggler, n: int) -> SGDSystem:
    """Theorem 1's inputs estimated from the data, as `benchmarks/ablation.py`
    estimates them: L and c from X^T X / m, the gradient variance at the
    optimum as sigma^2."""
    X, y = data.X, data.y
    m, d = X.shape
    evals = torch.linalg.eigvalsh(X.T @ X / m)
    big_l, c = 2 * float(evals.max()), 2 * float(max(float(evals.min()), 1e-3))
    f0_gap = float(squared_error(torch.zeros(d, device=X.device), X, y).mean()) - data.f_star
    g_star = 2 * (X * (X @ data.w_star - y)[:, None])
    sigma2 = float((g_star ** 2).sum(dim=1).mean())
    return SGDSystem(eta=eta, L=big_l, c=c, sigma2=sigma2, s=m // n, F0_gap=f0_gap, n=n, straggler=straggler)


def cases(setup: str, data=None, eta: float = 0.0) -> list:
    """The cells of ``setup`` as `SweepCase`s; the ablation's Theorem-1
    schedules are estimated from ``data`` (a `LinRegData`)."""
    cfg = SETUPS[setup]
    n = cfg["n"]
    if setup == "byzantine":
        return byzantine_cases(eta)
    if setup == "async":
        fleet = WorkerFleet([Exponential(rate=1.0)] * cfg["n_fast"]
                            + [Exponential(rate=1.0 / cfg["slow_factor"])] * cfg["n_slow"])
        k_cap, k_async = cfg["adaptive"]["k_max"], cfg["k_async"]
        return [
            SweepCase(PflugController(n_workers=n, **cfg["adaptive"]), fleet, eta=eta, label="adaptive"),
            SweepCase(FixedKController(n_workers=n, k=k_cap), fleet, eta=eta, label=f"sync_k{k_cap}"),
            SweepCase(FixedKController(n_workers=n, k=k_async), fleet, eta=eta, label=f"kasync_k{k_async}",
                      mode="kasync"),
            SweepCase(FixedKController(n_workers=n, k=k_async), fleet, eta=eta, label=f"kbatch_k{k_async}",
                      mode="kbatch"),
            SweepCase(PflugController(n_workers=n, **cfg["adaptive"]), fleet, eta=eta, label="kasync_adaptive",
                      mode="kasync"),
        ]
    if setup != "ablation":
        straggler = Exponential(rate=1.0)
        return [SweepCase(PflugController(n_workers=n, **cfg["adaptive"]), straggler, eta=eta, label="adaptive")] + [
            SweepCase(FixedKController(n_workers=n, k=k), straggler, eta=eta, label=f"fixed_k{k}")
            for k in cfg["fixed"]]
    out = []
    for sname, strag in ABLATION_STRAGGLERS.items():
        sched = switching_times(estimate_system(data, eta, strag, n), list(range(10, 40, 10)), step=10)
        controllers = {
            "pflug": PflugController(n_workers=n, k0=10, step=10, thresh=10, burnin=int(0.1 * cfg["m"]), k_max=40),
            "theory_schedule": ScheduleController(n_workers=n, switch_times=sched, k0=10, step=10),
            "variance_ratio": VarianceRatioController(n_workers=n, k0=10, step=10, burnin=200, k_max=40),
            "fixed_k10": FixedKController(n_workers=n, k=10),
            "fixed_k40": FixedKController(n_workers=n, k=40),
        }
        out += [SweepCase(ctrl, strag, eta=eta, label=f"{sname}|{cname}") for cname, ctrl in controllers.items()]
    return out


def byzantine_cases(eta: float) -> list:
    """fig_byzantine's 18 cells, labeled ``"<arm>|<mean|gm>|byz<percent>"``:
    the last round(frac n) workers are the rushing sign-flippers, the same
    slots in the fleet and in the plan."""
    cfg = SETUPS["byzantine"]
    n = cfg["n"]
    out = []
    for frac in cfg["byz_fracs"]:
        b = int(round(frac * n))
        fleet = WorkerFleet([Exponential(rate=1.0)] * (n - b) + [Exponential(rate=cfg["byz_rate"])] * b)
        plan = byzantine_plan(n, frac, "sign_flip") if frac > 0 else None
        tag = f"byz{int(round(frac * 100))}"
        for agg, atag in (("mean", "mean"), ("geomedian", "gm")):
            arms = [("adaptive", PflugController(n_workers=n, **cfg["adaptive"]))] + [
                (f"k{k}", FixedKController(n_workers=n, k=k)) for k in cfg["fixed"]]
            out += [SweepCase(ctrl, fleet, eta=eta, fault=plan, agg=agg, label=f"{arm}|{atag}|{tag}")
                    for arm, ctrl in arms]
    return out


def headline(out: dict) -> dict:
    """fig_byzantine's two flags from the final excess losses at k = 16 and
    30% sign-flip workers (None when the setup has no such cells)."""
    def final_excess(label):
        s = out["cases"].get(label)
        return None if s is None else float(s["loss_mean"][-1] - out["f_star"])

    mean_b30, gm_b30 = final_excess("k16|mean|byz30"), final_excess("k16|gm|byz30")
    if mean_b30 is None or gm_b30 is None:
        return {}
    return {"excess_mean_k16_b30": mean_b30, "excess_gm_k16_b30": gm_b30,
            "mean_diverged_b30": not math.isfinite(mean_b30) or mean_b30 > DIVERGED_ABOVE,
            "gm_recovered_b30": math.isfinite(gm_b30) and gm_b30 < RECOVERED_BELOW}


def run_case(setup: str, case: SweepCase, data, keys, iters: int | None = None, capture: bool = True,
             eval_every: int | None = None):
    """One cell of ``setup`` as a looped `run_monte_carlo` call on ``data``
    (a `LinRegData`) and replica keys."""
    cfg = SETUPS[setup]
    dev = data.X.device
    return run_monte_carlo(squared_error, torch.zeros(cfg["d"], device=dev), data.X, data.y, n_workers=cfg["n"],
                           controller=case.controller, straggler=case.straggler, eta=case.eta,
                           num_iters=iters or cfg["iters"], keys=keys, eval_every=eval_every or cfg["eval_every"],
                           device=dev, capture=capture, mode=case.mode, fault=case.fault, agg=case.agg,
                           agg_param=case.agg_param)


def run_grid(setup: str, grid: list, data, keys, iters: int | None = None, capture: bool = True,
             eval_every: int | None = None):
    """The cells ``grid`` of ``setup`` as one `run_sweep` call."""
    cfg = SETUPS[setup]
    dev = data.X.device
    return run_sweep(squared_error, torch.zeros(cfg["d"], device=dev), data.X, data.y, n_workers=cfg["n"],
                     cases=grid, num_iters=iters or cfg["iters"], keys=keys,
                     eval_every=eval_every or cfg["eval_every"], device=dev, capture=capture)


def inputs(setup: str, replicas: int | None = None, device="cuda"):
    """(data from key 0, replica keys split from key 1) of ``setup``."""
    cfg = SETUPS[setup]
    dev = resolve_device(device)
    data = make_linreg_data(prng.PRNGKey(0), m=cfg["m"], d=cfg["d"], device=dev)
    return data, prng.split(prng.PRNGKey(1, device=dev), replicas or cfg["replicas"])


def run(setup: str = "quickstart", iters: int | None = None, replicas: int | None = None, device="cuda",
        capture: bool = True, eta: float | None = None, looped: bool = False, eval_every: int | None = None) -> dict:
    """Run every case of ``setup``, as one grid or (``looped``) case by case;
    returns {"f_star", "f0_excess" (the loss at w = 0 less f*), "eta",
    "wall_s", "cases": {label: summarize(result)}, "results": {label:
    result}}.  ``eta`` overrides the setup's step (the parity tests pass
    one float to both packages, whose eigensolvers differ in the last
    ulps); ``eval_every`` the setup's."""
    data, keys = inputs(setup, replicas, device)
    eta = step_size(data.X, SETUPS[setup].get("edge_fraction", 0.25)) if eta is None else eta
    grid = cases(setup, data, eta)
    f0 = float(squared_error(torch.zeros(data.X.shape[1], device=data.X.device), data.X, data.y).mean())
    out = {"f_star": data.f_star, "f0_excess": f0 - data.f_star, "eta": eta, "cases": {}, "results": {}}
    t0 = time.perf_counter()
    if looped:
        results = {c.label: run_case(setup, c, data, keys, iters, capture, eval_every) for c in grid}
    else:
        res = run_grid(setup, grid, data, keys, iters, capture, eval_every)
        results = {label: res.cell(g) for g, label in enumerate(res.labels)}
    for label, r in results.items():
        out["results"][label] = r
        out["cases"][label] = summarize(r)  # reads the result back, so the time includes the run
    out["wall_s"] = time.perf_counter() - t0
    return out


def time_to_target(out: dict, factor: float = 1e-3, target: float | None = None) -> dict:
    """{label: the first replica-mean simulated time at which the mean excess
    loss is at most ``target`` (default ``factor`` times the initial excess:
    the target of `benchmarks/fig_async.py`), or None}."""
    target = factor * out["f0_excess"] if target is None else target
    return {label: next((float(t) for t, loss in zip(s["time_mean"], s["loss_mean"])
                         if loss - out["f_star"] <= target), None)
            for label, s in out["cases"].items()}


def report(out: dict) -> None:
    f_star = out["f_star"]
    for label, s in out["cases"].items():
        print(f"== {label}: replica mean +- 95% CI over R={s['n_replicas']} (excess loss over f* = {f_star:.6g}) ==")
        for i in range(len(s["iteration"])):
            print(f"  iter={s['iteration'][i]:6d}  sim_time={s['time_mean'][i]:10.1f}  "
                  f"excess={s['loss_mean'][i] - f_star:11.5g} +-{s['loss_ci95'][i]:9.2g}  k={s['k_mean'][i]:5.2f}")
    reached = ", ".join(f"{label} {'not reached' if t is None else f'{t:.1f}'}"
                        for label, t in time_to_target(out).items())
    print(f"simulated time to 1e-3 of the initial excess {out['f0_excess']:.6g}: {reached}")
    flags = headline(out)
    if flags:
        print(f"k = 16 at 30% sign-flip workers: the weighted mean's final excess {flags['excess_mean_k16_b30']:.6g} "
              f"(diverged, above {DIVERGED_ABOVE:g} or not finite: {flags['mean_diverged_b30']}); the geometric "
              f"median's {flags['excess_gm_k16_b30']:.6g} (recovered, below {RECOVERED_BELOW:g}: "
              f"{flags['gm_recovered_b30']})")


def lm_inputs(replicas: int | None = None, device="cuda"):
    """fig_lm's source, parameters (from key 0: the same on every device),
    token batch (seed 0) and replica keys split from key 1."""
    dev = resolve_device(device)
    source = LMSource(arch=LM["arch"], smoke=True, overrides=LM["overrides"])
    params0 = source.init_params(prng.PRNGKey(0), device=dev)
    data = source.make_data(n_rows=LM["rows"], seq_len=LM["seq"], seed=0, device=dev)
    return source, params0, data, prng.split(prng.PRNGKey(1, device=dev), replicas or LM["replicas"])


def theorem1_times(source: LMSource, params0, data, straggler) -> list:
    """fig_lm's Theorem-1 switch times from heuristic SGD constants: an LM
    loss exposes no Hessian, so L ~ 1/eta (eta tuned to ~1/L), c = L/100,
    sigma^2 the squared norm of the initial full-batch gradient, F0_gap 90%
    of the initial CE."""
    n, eta = LM["n"], LM["eta"]
    fns = source.build(data, n)
    dev = data[0].device
    g0 = fns.grad(params0, torch.ones(n, device=dev), torch.tensor(n, dtype=torch.int32, device=dev))
    sigma2 = float(sum(torch.dot(g.reshape(-1), g.reshape(-1)) for g in tree_leaves(g0)))
    f0 = float(fns.eval_loss(params0))
    big_l = 1.0 / eta
    sysm = SGDSystem(eta=eta, L=big_l, c=big_l / 100.0, sigma2=sigma2, s=LM["rows"] // n, F0_gap=0.9 * f0, n=n,
                     straggler=straggler)
    return switching_times(sysm, list(range(LM["k0"], LM["k_cap"], LM["k_step"])), step=LM["k_step"])


def lm_cases(t1_times: list) -> list:
    n, eta, k0, k_step, k_cap = LM["n"], LM["eta"], LM["k0"], LM["k_step"], LM["k_cap"]
    straggler = Exponential(rate=1.0)
    return [
        SweepCase(PflugController(n_workers=n, k0=k0, step=k_step, k_max=k_cap, **LM["adaptive"]), straggler,
                  eta=eta, label="adaptive"),
        SweepCase(FixedKController(n_workers=n, k=k0), straggler, eta=eta, label=f"fixed_k{k0}"),
        SweepCase(FixedKController(n_workers=n, k=k_cap), straggler, eta=eta, label=f"fixed_k{k_cap}"),
        SweepCase(ScheduleController(n_workers=n, switch_times=t1_times, k0=k0, step=k_step), straggler, eta=eta,
                  label="schedule_t1"),
    ]


def run_lm(iters: int | None = None, replicas: int | None = None, device="cuda", capture: bool = True,
           looped: bool = False, eval_every: int | None = None, params0=None) -> dict:
    """fig_lm's four arms as one `run_sweep_source` grid, or (``looped``)
    one `run_monte_carlo_source` call each.  Returns {"t1_times",
    "wall_s", "cases": {label: summarize(result)}, "results": {label:
    result}}; the loss is the CE over the token batch.  ``params0``
    overrides the weights drawn from key 0 (the parity tests pass the JAX
    package's, `LMSource.params_from_jax`)."""
    source, own_params, data, keys = lm_inputs(replicas, device)
    params0 = own_params if params0 is None else params0
    t1_times = theorem1_times(source, params0, data, Exponential(rate=1.0))
    grid = lm_cases(t1_times)
    num_iters, dev, eval_every = iters or LM["iters"], data[0].device, eval_every or LM["eval_every"]
    t0 = time.perf_counter()
    if looped:
        results = {c.label: run_monte_carlo_source(
            source, params0, data, n_workers=LM["n"], controller=c.controller, straggler=c.straggler, eta=c.eta,
            num_iters=num_iters, keys=keys, eval_every=eval_every, device=dev, capture=capture)
            for c in grid}
    else:
        res = run_sweep_source(source, params0, data, n_workers=LM["n"], cases=grid, num_iters=num_iters, keys=keys,
                               eval_every=eval_every, device=dev, capture=capture)
        results = {label: res.cell(g) for g, label in enumerate(res.labels)}
    out = {"t1_times": t1_times, "cases": {}, "results": results}
    for label, r in results.items():
        out["cases"][label] = summarize(r)  # reads the result back, so the time includes the run
    out["wall_s"] = time.perf_counter() - t0
    return out


def report_lm(out: dict) -> None:
    """Each arm's trajectory, then fig_lm's ``derived`` line."""
    for label, s in out["cases"].items():
        print(f"== {label}: replica mean +- 95% CI over R={s['n_replicas']} (CE) ==")
        for i in range(len(s["iteration"])):
            print(f"  iter={s['iteration'][i]:6d}  sim_time={s['time_mean'][i]:10.2f}  "
                  f"ce={s['loss_mean'][i]:9.5f} +-{s['loss_ci95'][i]:9.2g}  k={s['k_mean'][i]:5.2f}")
    final = {label: s["loss_mean"][-1] for label, s in out["cases"].items()}
    s0 = next(iter(out["cases"].values()))
    print(f"replicas={s0['n_replicas']};cells={len(final)};iters={s0['iteration'][-1]};"
          f"t1_switches={[round(t, 1) for t in out['t1_times']]};"
          + ";".join(f"final_ce_{label}={ce:.4f}" for label, ce in final.items())
          + f";k_final={out['cases']['adaptive']['k_mean'][-1]:.1f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--setup", default="quickstart", choices=sorted(SETUPS) + ["lm"])
    ap.add_argument("--iters", type=int, default=None, help="iterations per case (default: the setup's)")
    ap.add_argument("--replicas", type=int, default=None, help="Monte-Carlo replicas (default: the setup's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--looped", action="store_true", help="one run_monte_carlo call per case instead of one grid")
    args = ap.parse_args(argv)
    how = "looped, a program each" if args.looped else "as one grid"
    if args.setup == "lm":
        out = run_lm(iters=args.iters, replicas=args.replicas, device=args.device, looped=args.looped)
        report_lm(out)
        print(f"{len(out['cases'])} cases ({how}) in {out['wall_s']:.2f} s on {args.device}")
        return
    out = run(args.setup, iters=args.iters, replicas=args.replicas, device=args.device, looped=args.looped)
    report(out)
    print(f"eta {out['eta']:.6g}; {len(out['cases'])} cases ({how}) in {out['wall_s']:.2f} s on {args.device}")


if __name__ == "__main__":
    main()
