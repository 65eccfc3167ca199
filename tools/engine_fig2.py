"""The paper's Fig. 2 on the card: adaptive fastest-k SGD against fixed
k = 10, 20, 30, 40 (§V-B: n = 50 workers, m = 2000, d = 100, exp(1)
response times, R = 32 replicas, 40 000 iterations, the loss every 500),
through the port's engine, graph-replayed: the five cells as one grid (one
`run_sweep` program), or with ``--looped`` as five `run_monte_carlo`
programs.  Prints each cell's curve (replica means with 95% CIs), the
paper's time-to-target comparison, the wall time, the peak memory and the
card, and writes the curves as JSON to results/engine_fig2[_looped].json.

    PYTHONPATH=src python tools/engine_fig2.py [--iters 40000] [--replicas 32] [--looped]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def first_time_below(times, excess, target):
    for t, e in zip(times, excess):
        if e <= target:
            return float(t)
    return None


def main(argv=None) -> int:
    import torch

    from repro_torch.launch import quickstart

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=40_000)
    ap.add_argument("--replicas", type=int, default=32)
    ap.add_argument("--looped", action="store_true", help="a run_monte_carlo program per cell instead of one grid")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.cuda.reset_peak_memory_stats()
    out = quickstart.run("fig2", iters=args.iters, replicas=args.replicas, device="cuda", looped=args.looped)
    quickstart.report(out)
    excess = {k: s["loss_mean"] - out["f_star"] for k, s in out["cases"].items()}
    target = excess["fixed_k40"][-1] * 1.10
    t_adapt = first_time_below(out["cases"]["adaptive"]["time_mean"], excess["adaptive"], target)
    t_k40 = first_time_below(out["cases"]["fixed_k40"]["time_mean"], excess["fixed_k40"], target)
    summary = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "iters": args.iters,
        "replicas": args.replicas, "cells": len(out["cases"]), "looped": args.looped, "wall_s": out["wall_s"],
        "eta": out["eta"],
        "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
        "time_to_target_adaptive": t_adapt, "time_to_target_fixed_k40": t_k40,
        "k_final_adaptive": float(out["cases"]["adaptive"]["k_mean"][-1]),
    }
    (ROOT / "results").mkdir(exist_ok=True)
    curves = {k: {f: v.tolist() for f, v in s.items() if hasattr(v, "tolist")} for k, s in out["cases"].items()}
    name = "engine_fig2_looped.json" if args.looped else "engine_fig2.json"
    (ROOT / "results" / name).write_text(json.dumps({"summary": summary, "curves": curves}))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
