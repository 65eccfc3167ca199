"""Compare two directories of dry-run JSONs (`launch/dryrun_all.py`): the
jobs whose per-rank counts are equal, and a markdown row, parent -> change,
for each job that moved.

Each row gives a rank's FLOPs, bytes, collective bytes in all and by type,
the three roofline terms in seconds, the dominant term and the useful-FLOP
ratio.  "Equal" compares FLOPs, bytes and every collective type exactly.

    python tools/dryrun_compare.py PARENT_DIR CHANGE_DIR
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def counts(r: dict) -> tuple:
    rl, c = r["roofline"], r["collectives"]
    return (rl["flops"], rl["bytes_accessed"]) + tuple(c[k] for k in KINDS)


def row(name: str, p: dict, c: dict) -> str:
    def pair(f, fmt="{:.4g}"):
        return f"{fmt.format(f(p))} -> {fmt.format(f(c))}"

    cells = [name, pair(lambda r: r["roofline"]["flops"]), pair(lambda r: r["roofline"]["bytes_accessed"]),
             pair(lambda r: r["collectives"]["total"])]
    cells += [pair(lambda r, k=k: r["collectives"][k]) for k in ("all-gather", "all-reduce", "reduce-scatter")]
    cells += [pair(lambda r, k=k: r["roofline"][k]) for k in ("compute_s", "memory_s", "collective_s")]
    cells += [f"{p['roofline']['dominant']} -> {c['roofline']['dominant']}",
              pair(lambda r: r["roofline"]["useful_flops_ratio"], "{:.4f}")]
    return "| " + " | ".join(cells) + " |"


def main(argv=None) -> int:
    parent, change = (Path(a) for a in (argv or sys.argv[1:]))
    names = sorted({f.stem for f in parent.glob("*.json")} & {f.stem for f in change.glob("*.json")})
    only = sorted({f.stem for f in parent.glob("*.json")} ^ {f.stem for f in change.glob("*.json")})
    equal, moved = [], []
    for name in names:
        p, c = (json.loads((d / f"{name}.json").read_text()) for d in (parent, change))
        (equal if counts(p) == counts(c) else moved).append((name, p, c))
    print(f"{len(names)} jobs in both, {len(equal)} equal, {len(moved)} moved; in one directory only: {only}")
    print("equal: " + ", ".join(name for name, _, _ in equal))
    print("| job, a rank | FLOPs | bytes | collective bytes | all-gather | all-reduce | reduce-scatter | compute s | "
          "memory s | collective s | dominant | ratio |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for name, p, c in moved:
        print(row(name, p, c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
