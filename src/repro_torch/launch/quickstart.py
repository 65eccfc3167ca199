"""Adaptive against fixed-k fastest-k SGD on the paper's linear regression,
as replica means with 95% CIs: the port of `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.quickstart --setup fig2 --iters 40000 --replicas 32

``quickstart`` (the default): n = 20 workers, m = 400, d = 20, R = 16,
Algorithm 1's Pflug test (k0 = 2, step 4, thresh 10, burn-in 40) against
fixed k = 2, 8000 iterations.  ``fig2``: §V-B of the paper, n = 50,
m = 2000, d = 100, exp(1) response times, adaptive (k0 = 10, step 10,
thresh 10, burn-in 200, k_max 40) against fixed k = 10, 20, 30, 40,
eta = 0.5/L, the loss evaluated every 500 iterations.  Each case is one
`run_monte_carlo` call (the reference's sweep is pinned to that loop).
Data from key 0, replica keys split from key 1; on the card by default.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.controller import FixedKController, PflugController
from repro_torch.core.montecarlo import run_monte_carlo, summarize
from repro_torch.core.straggler import Exponential
from repro_torch.data import make_linreg_data

SETUPS = {
    "quickstart": dict(m=400, d=20, n=20, replicas=16, iters=8000, eval_every=1000,
                       adaptive=dict(k0=2, step=4, thresh=10, burnin=40), fixed=(2,)),
    "fig2": dict(m=2000, d=100, n=50, replicas=32, iters=40_000, eval_every=500,
                 adaptive=dict(k0=10, step=10, thresh=10, burnin=200, k_max=40), fixed=(10, 20, 30, 40)),
}


def squared_error(w, X, y):
    r = X @ w - y
    return r * r


def step_size(X: torch.Tensor) -> float:
    """0.5 / L with L = 2 * the largest eigenvalue of X^T X / m (float32)."""
    lam = torch.linalg.eigvalsh(X.T @ X / X.shape[0]).max()
    return 0.5 / (2 * float(lam))


def cases(setup: str):
    """[(label, controller)] of a setup."""
    cfg = SETUPS[setup]
    n = cfg["n"]
    return [("adaptive", PflugController(n_workers=n, **cfg["adaptive"]))] + [
        (f"fixed_k{k}", FixedKController(n_workers=n, k=k)) for k in cfg["fixed"]]


def run_case(setup: str, label: str, data, keys, eta: float, iters: int | None = None, capture: bool = True):
    """One case of ``setup`` on ``data`` (a `LinRegData`) and replica keys."""
    cfg = SETUPS[setup]
    dev = data.X.device
    return run_monte_carlo(squared_error, torch.zeros(cfg["d"], device=dev), data.X, data.y, n_workers=cfg["n"],
                           controller=dict(cases(setup))[label], straggler=Exponential(rate=1.0), eta=eta,
                           num_iters=iters or cfg["iters"], keys=keys, eval_every=cfg["eval_every"], device=dev,
                           capture=capture)


def inputs(setup: str, replicas: int | None = None, device="cuda"):
    """(data from key 0, replica keys split from key 1) of ``setup``."""
    cfg = SETUPS[setup]
    dev = resolve_device(device)
    data = make_linreg_data(prng.PRNGKey(0), m=cfg["m"], d=cfg["d"], device=dev)
    return data, prng.split(prng.PRNGKey(1, device=dev), replicas or cfg["replicas"])


def run(setup: str = "quickstart", iters: int | None = None, replicas: int | None = None, device="cuda",
        capture: bool = True, eta: float | None = None) -> dict:
    """Run every case of ``setup``; returns {"f_star", "eta", "wall_s",
    "cases": {label: summarize(result)}, "results": {label: result}}.
    ``eta`` overrides 0.5/L (the parity tests pass one float to both
    packages, whose eigensolvers differ in the last ulps)."""
    data, keys = inputs(setup, replicas, device)
    eta = step_size(data.X) if eta is None else eta
    out = {"f_star": data.f_star, "eta": eta, "cases": {}, "results": {}}
    t0 = time.perf_counter()
    for label, _ in cases(setup):
        res = run_case(setup, label, data, keys, eta, iters, capture)
        out["results"][label] = res
        out["cases"][label] = summarize(res)  # reads the result back, so the time includes the run
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
    args = ap.parse_args(argv)
    out = run(args.setup, iters=args.iters, replicas=args.replicas, device=args.device)
    report(out)
    print(f"eta {out['eta']:.6g}; {len(out['cases'])} cases in {out['wall_s']:.2f} s on {args.device}")


if __name__ == "__main__":
    main()
