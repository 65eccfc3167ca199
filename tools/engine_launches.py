"""Kernels an iteration of the engine's fault-free programs on the card, for
one or more checkouts of the port: fig_async's five-arm grid (160 lanes)
and its sync, K-async and Pflug K-async arms looped (R = 32), each counted
as `chip_smoke.py` phase 9 counts them (torch.profiler over graph-replayed
runs of 2 and of 1 iterations, the difference).  Each checkout runs in a
process of its own, in the order given, so that two versions are compared
in one call to the card (parent, change, change, parent).

    python tools/engine_launches.py [CHECKOUT ...]    # default: this checkout
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_COUNT = """
import json, sys, torch
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import chip_smoke
from repro_torch.launch import quickstart
torch.backends.cuda.matmul.allow_tf32 = False
data, keys = quickstart.inputs("async", device="cuda")
arms = quickstart.cases("async", data, quickstart.step_size(data.X))

def launches(run):
    run(1), run(2)  # capture both programs before they are counted
    return chip_smoke.count_kernels(lambda: run(2)) - chip_smoke.count_kernels(lambda: run(1))

out = {"grid": launches(lambda it: quickstart.run_grid("async", arms, data, keys, it))}
for arm in arms:
    if arm.label in ("sync_k16", "kasync_k4", "kasync_adaptive"):
        out[arm.label] = launches(lambda it, arm=arm: quickstart.run_case("async", arm, data, keys, it))
print(json.dumps(out))
"""


def main(argv=None) -> int:
    trees = (argv if argv is not None else sys.argv[1:]) or [str(ROOT)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _COUNT, str(Path(tree).resolve())], capture_output=True,
                              text=True, timeout=900, check=True)
        print(tree, json.loads(proc.stdout.strip().splitlines()[-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
