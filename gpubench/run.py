"""Run one cell of the port's benchmark and print its result line.

    python3 gpubench/run.py --workload sim-fig2-grid --seed 7 --seconds 30 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line on standard output is the result (JSON); the numbers
compared with the plain reference, each beside its limit, are the last
lines on standard error.  Without a card, or without the port's package
beside the benchmark, it prints no result and exits with 1.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpubench import bench

    try:
        bench.use_checkout_caches()
        line = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except (bench.BenchError, ImportError) as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 1
    bench.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
