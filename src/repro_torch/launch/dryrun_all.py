"""Runs the full dry-run matrix.

The port of `repro/launch/dryrun_all.py`.  Runs one subprocess per
(arch x shape x mode) — each opens its own fake world, since the process
group is global — and writes results/torch/dryrun/<arch>__<shape>__<mode>.json.

Modes:
  base   single-pod 16x16: the coherence proof, memory, collectives and the
         roofline terms at full depth (the table row)
  pod2   multi-pod 2x16x16: proves the "pod" axis shards

The reference's cost4 and cost8 modes (unrolled at 4 and 8 layers) exist to
extrapolate full-depth costs: XLA's HloCostAnalysis counts a scanned loop
body once.  The port's trace is eager and runs every layer, so `base`
counts full depth and those modes are left out.

Resumable: existing JSONs are skipped.  Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_all --jobs 3 [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ARCHS = [
    "rwkv6-3b", "qwen3-moe-30b-a3b", "qwen1.5-110b", "qwen1.5-0.5b",
    "granite-moe-1b-a400m", "seamless-m4t-medium", "hymba-1.5b",
    "paligemma-3b", "nemotron-4-340b", "llama3.2-3b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MODES = ["base", "pod2"]
ROOT = Path(__file__).resolve().parents[3]


def job_cmd(arch: str, shape: str, mode: str, out: str, device: str):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out, "--device", device]
    if mode == "pod2":
        cmd.append("--multi-pod")
    return cmd


def run_job(arch: str, shape: str, mode: str, outdir: str, timeout: int, device: str):
    out = os.path.join(outdir, f"{arch}__{shape}__{mode}.json")
    if os.path.exists(out):
        return (arch, shape, mode, "cached", 0.0)
    t0 = time.time()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.setdefault("OMP_NUM_THREADS", "1")  # a trace is Python-bound; jobs run side by side
    try:
        proc = subprocess.run(job_cmd(arch, shape, mode, out, device), capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=ROOT)
        status = "ok" if proc.returncode == 0 and os.path.exists(out) else "FAIL"
        if status == "FAIL":
            with open(out + ".err", "w") as f:
                f.write(proc.stdout[-4000:] + "\n---\n" + proc.stderr[-8000:])
    except subprocess.TimeoutExpired:
        status = "TIMEOUT"
    return (arch, shape, mode, status, time.time() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--outdir", default="results/torch/dryrun")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--modes", nargs="*", default=MODES)
    ap.add_argument("--archs", nargs="*", default=ARCHS)
    ap.add_argument("--shapes", nargs="*", default=SHAPES)
    args = ap.parse_args(argv)

    outdir = os.path.abspath(args.outdir)
    os.makedirs(outdir, exist_ok=True)
    combos = list(itertools.product(args.archs, args.shapes, args.modes))
    print(f"{len(combos)} jobs, {args.jobs} parallel")
    n_fail = 0
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futures = [ex.submit(run_job, a, s, m, outdir, args.timeout, args.device) for a, s, m in combos]
        for fut in futures:
            arch, shape, mode, status, dt = fut.result()
            print(f"  {arch:22s} {shape:12s} {mode:6s} {status:8s} {dt:6.0f}s", flush=True)
            n_fail += status not in ("ok", "cached")
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
