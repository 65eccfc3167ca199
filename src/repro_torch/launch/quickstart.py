"""Adaptive against fixed-k fastest-k SGD on the paper's linear regression,
as replica means with 95% CIs: the port of `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup fig2 --iters 40000 --replicas 32
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup ablation [--looped]

``quickstart`` (the default): n = 20 workers, m = 400, d = 20, R = 16,
Algorithm 1's Pflug test (k0 = 2, step 4, thresh 10, burn-in 40) against
fixed k = 2, 8000 iterations.  ``fig2``: §V-B of the paper, n = 50,
m = 2000, d = 100, exp(1) response times, adaptive (k0 = 10, step 10,
thresh 10, burn-in 200, k_max 40) against fixed k = 10, 20, 30, 40,
eta = 0.5/L, the loss evaluated every 500 iterations.  ``ablation``
(`benchmarks/ablation.py`): Pflug, the Theorem-1 schedule (its switch
times estimated from the data), variance ratio, fixed k = 10 and 40, each
under Exponential(1), Pareto(0.5, 1.5) and Bimodal(0.5, 10, 0.1), at
fig2's m, d and n, R = 8, 30 000 iterations.

A setup runs as one `run_sweep` call, every case a cell of one grid, as
the reference's example does; ``--looped`` runs each case as a
`run_monte_carlo` call of its own instead.  Data from key 0, replica keys
split from key 1; on the card by default.
"""

from __future__ import annotations

import argparse
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
from repro_torch.core.montecarlo import run_monte_carlo, summarize
from repro_torch.core.straggler import Bimodal, Exponential, Pareto
from repro_torch.core.sweep import SweepCase, run_sweep
from repro_torch.core.theory import SGDSystem, switching_times
from repro_torch.data import make_linreg_data

SETUPS = {
    "quickstart": dict(m=400, d=20, n=20, replicas=16, iters=8000, eval_every=1000,
                       adaptive=dict(k0=2, step=4, thresh=10, burnin=40), fixed=(2,)),
    "fig2": dict(m=2000, d=100, n=50, replicas=32, iters=40_000, eval_every=500,
                 adaptive=dict(k0=10, step=10, thresh=10, burnin=200, k_max=40), fixed=(10, 20, 30, 40)),
    "ablation": dict(m=2000, d=100, n=50, replicas=8, iters=30_000, eval_every=500),
}
ABLATION_STRAGGLERS = {
    "exp": Exponential(rate=1.0),
    "pareto": Pareto(x_m=0.5, alpha=1.5),
    "bimodal": Bimodal(fast_mean=0.5, slow_mean=10.0, p_slow=0.1),
}


def squared_error(w, X, y):
    r = X @ w - y
    return r * r


def step_size(X: torch.Tensor) -> float:
    """0.5 / L with L = 2 * the largest eigenvalue of X^T X / m (float32)."""
    lam = torch.linalg.eigvalsh(X.T @ X / X.shape[0]).max()
    return 0.5 / (2 * float(lam))


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


def run_case(setup: str, case: SweepCase, data, keys, iters: int | None = None, capture: bool = True):
    """One cell of ``setup`` as a looped `run_monte_carlo` call on ``data``
    (a `LinRegData`) and replica keys."""
    cfg = SETUPS[setup]
    dev = data.X.device
    return run_monte_carlo(squared_error, torch.zeros(cfg["d"], device=dev), data.X, data.y, n_workers=cfg["n"],
                           controller=case.controller, straggler=case.straggler, eta=case.eta,
                           num_iters=iters or cfg["iters"], keys=keys, eval_every=cfg["eval_every"], device=dev,
                           capture=capture)


def run_grid(setup: str, grid: list, data, keys, iters: int | None = None, capture: bool = True):
    """The cells ``grid`` of ``setup`` as one `run_sweep` call."""
    cfg = SETUPS[setup]
    dev = data.X.device
    return run_sweep(squared_error, torch.zeros(cfg["d"], device=dev), data.X, data.y, n_workers=cfg["n"],
                     cases=grid, num_iters=iters or cfg["iters"], keys=keys, eval_every=cfg["eval_every"],
                     device=dev, capture=capture)


def inputs(setup: str, replicas: int | None = None, device="cuda"):
    """(data from key 0, replica keys split from key 1) of ``setup``."""
    cfg = SETUPS[setup]
    dev = resolve_device(device)
    data = make_linreg_data(prng.PRNGKey(0), m=cfg["m"], d=cfg["d"], device=dev)
    return data, prng.split(prng.PRNGKey(1, device=dev), replicas or cfg["replicas"])


def run(setup: str = "quickstart", iters: int | None = None, replicas: int | None = None, device="cuda",
        capture: bool = True, eta: float | None = None, looped: bool = False) -> dict:
    """Run every case of ``setup``, as one grid or (``looped``) case by case;
    returns {"f_star", "eta", "wall_s", "cases": {label: summarize(result)},
    "results": {label: result}}.  ``eta`` overrides 0.5/L (the parity tests
    pass one float to both packages, whose eigensolvers differ in the last
    ulps)."""
    data, keys = inputs(setup, replicas, device)
    eta = step_size(data.X) if eta is None else eta
    grid = cases(setup, data, eta)
    out = {"f_star": data.f_star, "eta": eta, "cases": {}, "results": {}}
    t0 = time.perf_counter()
    if looped:
        results = {c.label: run_case(setup, c, data, keys, iters, capture) for c in grid}
    else:
        res = run_grid(setup, grid, data, keys, iters, capture)
        results = {label: res.cell(g) for g, label in enumerate(res.labels)}
    for label, r in results.items():
        out["results"][label] = r
        out["cases"][label] = summarize(r)  # reads the result back, so the time includes the run
    out["wall_s"] = time.perf_counter() - t0
    return out


def report(out: dict) -> None:
    f_star = out["f_star"]
    for label, s in out["cases"].items():
        print(f"== {label}: replica mean +- 95% CI over R={s['n_replicas']} (excess loss over f* = {f_star:.6g}) ==")
        for i in range(len(s["iteration"])):
            print(f"  iter={s['iteration'][i]:6d}  sim_time={s['time_mean'][i]:10.1f}  "
                  f"excess={s['loss_mean'][i] - f_star:11.5g} +-{s['loss_ci95'][i]:9.2g}  k={s['k_mean'][i]:5.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--setup", default="quickstart", choices=sorted(SETUPS))
    ap.add_argument("--iters", type=int, default=None, help="iterations per case (default: the setup's)")
    ap.add_argument("--replicas", type=int, default=None, help="Monte-Carlo replicas (default: the setup's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--looped", action="store_true", help="one run_monte_carlo call per case instead of one grid")
    args = ap.parse_args(argv)
    out = run(args.setup, iters=args.iters, replicas=args.replicas, device=args.device, looped=args.looped)
    report(out)
    how = "looped, a program each" if args.looped else "as one grid"
    print(f"eta {out['eta']:.6g}; {len(out['cases'])} cases ({how}) in {out['wall_s']:.2f} s on {args.device}")


if __name__ == "__main__":
    main()
