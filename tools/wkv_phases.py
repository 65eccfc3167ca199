#!/usr/bin/env python3
"""Where one sub-chunk of the tensor-core wkv6 kernel spends its cycles.

    python tools/wkv_phases.py [--chunk 32] [--sub-chunk 5]

Builds a copy of `wkv6_sm90.cu` with clock64() stamps at the phase
boundaries of one sub-chunk (after the loads landed; the levels; the score
sum; y; the state update), for two blocks: block 0 and the last block, which
the hardware places as a second block on an SM that already runs one.  Runs
it once at the rwkv6-3b prefill scan (B=4, T=1024, H=40, K=V=64, bf16) and
prints, per block, each warp's cycles in each phase and the sub-chunk's
total, with the card's name and power limit.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/wkv/csrc/wkv6_sm90.cu"
PHASES = ["levels", "score sum", "y", "state"]
# (anchor, where the stamp goes) in the loop over sub-chunks; stamp i is
# event i: loads landed, levels done, score sum done, y done, state done
STAMP = "if (lane == 0 && blockIdx.x == PROBE_BLOCK && ci == PROBE_CI) g_stamps[warp * 8 + {i}] = clock64();"
ANCHORS = [
    ("    __syncthreads();  // sub-chunk ci has landed; the last one's readers are done\n", "after", 0),
    ("    __syncthreads();\n\n    //    the scores", "before", 1),
    ("    __syncthreads();\n\n    // 3. y", "before", 2),
    ("    //    S^T = S^T diag", "before", 3),
    ("    fence_regs(S);\n  }\n", "inside", 4),
]


def instrument(text: str, block: int, sub_chunk: int) -> str:
    for anchor, where, i in ANCHORS:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor not found once in {SOURCE.name}: {anchor!r}")
        stamp = "    " + STAMP.format(i=i) + "\n"
        if where == "after":
            new = anchor + stamp
        elif where == "before":
            new = stamp + anchor
        else:  # before the closing brace of the loop
            new = anchor[:-len("  }\n")] + stamp + "  }\n"
        text = text.replace(anchor, new)
    text = text.replace("namespace {\n", "__device__ long long g_stamps[64];\nnamespace {\n", 1)
    text = text.replace("PROBE_BLOCK", str(block)).replace("PROBE_CI", str(sub_chunk))
    return text + ('\nextern "C" int wkv6_stamps(long long* out) {\n'
                   "  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n")


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--sub-chunk", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv_phases: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {cs.nvidia_smi()}")
    case = cs.WKV_SLICE[:5] + (args.chunk,) + cs.WKV_SLICE[6:]
    blocks = (0, case[0] * case[2] - 1)
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for block in blocks:
        src = out / f"wkv6_sm90_stamps_{block}.cu"
        src.write_text(instrument(text, block, args.sub_chunk))
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)]
        procs[block] = (src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    xs = cs.wkv_inputs(case, seed=7)
    launch_args = kernel._entry("wkv6_sm90")[0].argtypes
    for block, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        lib.wkv6_sm90_fwd.argtypes, lib.wkv6_sm90_fwd.restype = launch_args, ctypes.c_int
        lib.wkv6_sm90_error_string.argtypes, lib.wkv6_sm90_error_string.restype = [ctypes.c_int], ctypes.c_char_p
        kernel._entries["wkv6_sm90"] = (lib.wkv6_sm90_fwd, lib.wkv6_sm90_error_string)
        for _ in range(3):
            kernel.wkv6_bthk(*xs, chunk=args.chunk, kernel="wkv6_sm90")
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 64)()
        if lib.wkv6_stamps(buf) != 0:
            raise RuntimeError("could not read the stamps")
        stamps = [[buf[w * 8 + i] for i in range(5)] for w in range(8)]
        t0 = min(s[0] for s in stamps)
        print(f"block {block}, sub-chunk {args.sub_chunk} of {case}: cycles per phase, per warp")
        for w, s in enumerate(stamps):
            cycles = [b - a for a, b in zip(s, s[1:])]
            print(f"  warp {w}: " + ", ".join(f"{p} {n}" for p, n in zip(PHASES, cycles))
                  + f"; from the first warp's start to its end {s[-1] - t0}")
    kernel._entries.pop("wkv6_sm90")
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
