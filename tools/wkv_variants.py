#!/usr/bin/env python3
"""Time the wkv6 kernels beside each other on one GPU.

    python tools/wkv_variants.py [--chunks 32 16 64] [--rounds 4]

At the rwkv6-3b prefill scan (B=4, T=1024, H=40, K=V=64, bf16 r/k/v, f32 w),
and with H = 33 (132 blocks, one per SM of an H100) beside it, at each chunk
given, it holds the tensor-core kernel (`wkv6_sm90.cu`) and the scalar
kernel (`wkv6.cu`) to the plain version, then times them in alternating
rounds (CUDA events, 20 launches a sample) and prints each sample, the min
and median, the bounds of `chip_smoke.py`, and the card's name and power
limit.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels.wkv import kernel, ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[32, 16, 64])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {cs.nvidia_smi()}")
    for heads, chunk in [(h, c) for c in args.chunks for h in (cs.WKV_SLICE[2], 33)]:
        case = cs.WKV_SLICE[:2] + (heads,) + cs.WKV_SLICE[3:5] + (chunk,) + cs.WKV_SLICE[6:]
        xs = cs.wkv_inputs(case, seed=7)
        plain = ref.wkv6_ref(*xs, chunk=chunk)
        variants = {"tensor-core": dict(kernel="wkv6_sm90"), "scalar": dict(kernel="wkv6")}
        atol, rtol = cs.WKV_TOL["bfloat16"]
        for name, kw in variants.items():
            out = kernel.wkv6_bthk(*xs, chunk=chunk, **kw)
            err = max((o - p).abs().max().item() for o, p in zip(out, plain))
            ok = all(bool(((o - p).abs() <= atol + rtol * p.abs()).all()) for o, p in zip(out, plain))
            print(f"  H={heads} chunk {chunk} {name}: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with the plain version at {case}")
        times = {name: [] for name in variants}
        for _ in range(args.rounds):
            for name, kw in variants.items():
                times[name].append(cs.cuda_ms(lambda: kernel.wkv6_bthk(*xs, chunk=chunk, **kw)))
        bound = cs.wkv_bounds(case)
        print(f"  H={heads} chunk {chunk}: bounds {bound}")
        for name, ts in times.items():
            print(f"    {name:18s} " + " ".join(f"{t:.4f}" for t in ts)
                  + f"  min {min(ts):.4f} median {statistics.median(ts):.4f} ms")
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
