#!/usr/bin/env python3
"""Time the plain wkv6 scan, rwkv6-3b's train step and its dry-run trace on
one GPU, for one or more source trees in turns.

    python tools/rwkv_scan_compare.py [--trees DIR ...] [--dryrun-layers 2] [--out FILE]

Each tree is a directory holding `src/repro_torch` (default: this checkout);
give a tree twice to measure it twice, as in ``--trees old new new old``.
Each tree runs in a process of its own, which measures on the card:

- the plain scan `linear_scan.wkv6_chunked` at the rwkv6-3b prefill shape
  of `chip_smoke.WKV_SLICE` (B=4, T=1024, H=40, K=V=64, chunk 32; bf16
  r/k/v, f32 w): the forward, and the forward and backward (the gradient
  of y's sum with respect to r, k, v, w and u), CUDA events;
- rwkv6-3b's sync train step at the width `chip_smoke.py` phase 11 runs it
  (the smoke config, f32, batch 8 x 128, SGD, Pflug): the mean of five
  steps after a first, host clock to a synchronise;
- the dry run (`launch/dryrun.py`) of rwkv6-3b train_4k on (16, 16) and on
  (2, 16, 16) at ``--dryrun-layers`` layers (0: skip), in a subprocess of
  the tree: its ``trace_s``.

It prints a line a tree, the card's name and power limit, and writes every
number to ``--out`` as JSON.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCAN_ITERS = 5
TRAIN_STEPS = 6


def measure(tree: Path, dryrun_layers: int) -> dict:
    """Every number of one tree, in this process (its repro_torch first on the path)."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.models import linear_scan

    if Path(repro_torch.__file__).resolve().parents[2] != tree.resolve():
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": str(tree)}
    case = cs.WKV_SLICE
    chunk = case[5]
    xs = cs.wkv_inputs(case, seed=7)
    out["plain_fwd_ms"] = cs.cuda_ms(lambda: linear_scan.wkv6_chunked(*xs, chunk=chunk), iters=SCAN_ITERS, warmup=1)
    leaves = [x.float().requires_grad_(True) for x in xs[:5]]

    def fwd_bwd():
        y, _ = linear_scan.wkv6_chunked(*leaves, chunk=chunk)
        torch.autograd.grad(y.sum(), leaves)

    out["plain_fwd_bwd_ms"] = cs.cuda_ms(fwd_bwd, iters=SCAN_ITERS, warmup=1)
    del leaves
    out["train_step_ms"] = train_step_ms()
    for mesh, flag in (("16x16", []), ("2x16x16", ["--multi-pod"])):
        if dryrun_layers:
            out[f"dryrun_{mesh}_trace_s"] = dryrun_trace_s(tree, dryrun_layers, flag)
    return out


def train_step_ms() -> float:
    """rwkv6-3b's sync step at smoke width, as `chip_smoke.train_smoke_run`
    builds it: the mean ms of the steps after the first."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.aggregation import CommModel
    from repro_torch.core.controller import PflugController
    from repro_torch.core.straggler import Exponential
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    cfg = get_smoke_config("rwkv6-3b")
    params = tree_map(lambda a: a.to("cuda"), build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))
    opt, ctrl = sgd(0.3, momentum=0.9), PflugController(n_workers=4, k0=1, step=1, thresh=0, burnin=0)
    step = steps.make_train_step(build_model(cfg, "cuda"), opt, ctrl, Exponential(1.0), 4, CommModel(0.1, 0.05))
    state = steps.init_train_state(opt, ctrl, params)
    data = TokenStream(cfg.vocab_size, 128, 8, seed=0, device="cuda")
    key = prng.PRNGKey(7, device="cuda")
    times = []
    for i in range(TRAIN_STEPS):
        tok, tgt = data.batch_at(i)
        key, sub = prng.split(key).unbind(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tok, "targets": tgt}, sub)
        float(m["ce"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.mean(times[1:])


def dryrun_trace_s(tree: Path, layers: int, flag: list) -> float:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.json")
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-3b", "--shape",
                        "train_4k", "--override", f"n_layers={layers}", "--out", path, *flag],
                       env=env, cwd=tree, check=True, stdout=subprocess.DEVNULL)
        with open(path) as f:
            return json.load(f)["trace_s"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)])
    ap.add_argument("--dryrun-layers", type=int, default=2)
    ap.add_argument("--out", default="results/torch/rwkv_scan_compare.json")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rwkv_scan_compare: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(measure(Path(args.one), args.dryrun_layers)))
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = cs.nvidia_smi()
    rows = []
    for tree in args.trees:
        res = subprocess.run([sys.executable, __file__, "--one", str(Path(tree).resolve()), "--dryrun-layers",
                              str(args.dryrun_layers)], check=True, stdout=subprocess.PIPE, text=True)
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "wkv_shape": list(cs.WKV_SLICE), "rows": rows}, f, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
