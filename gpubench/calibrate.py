"""Readings that the limits of `limits/<workload>.json` are set from.

    python3 gpubench/calibrate.py --workload sim-fig2-grid --seeds 11,12,13 \\
        --modes program,control:tf32,fault:unchanged --seconds 3 [--out FILE]

Runs the cell in one process for every seed and mode and prints one JSON
line each: ``program`` is a sound run of the port, ``control:<precision>``
the plain reference at a lower precision put in the program's place, and
``fault:<name>`` the port with its timed path broken underneath (the
drivers name the faults they can plant).  Each line gives the compared
numbers of that run; the limits are not applied.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma list")
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpubench import bench

    bench.use_checkout_caches()
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            kind, _, arg = mode.partition(":")
            t0 = time.perf_counter()
            line = bench.run_cell(args.workload, seed, args.seconds, False,
                                  fault=arg if kind == "fault" else None,
                                  control=arg if kind == "control" else None, detail=True)
            rec = {"workload": args.workload, "seed": seed, "mode": mode, "wall_s": time.perf_counter() - t0,
                   "correct": line["correct"], "metrics": line["metrics"],
                   "info": line.get("info", {}), "checks": {k: v["value"] for k, v in line["checks"].items()}}
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
