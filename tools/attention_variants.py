#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernel against SDPA on one GPU.

    python tools/attention_variants.py [--variant STAGES=2,QBUF=2 ...]

Each variant is the source `flash_attn_sm90.cu` with some of its top-level
`constexpr int NAME = value;` constants replaced; the source as it stands is
always the first, "base".  Every variant is built with the port's nvcc flags
into the ignored build directory, held to the plain version at the
llama3.2-3b prefill shapes and chip_smoke.py's ragged shapes, then timed at
the prefill shapes (causal, window 256) and at two shapes where each query
block sees more keys (non-causal; causal at T = 4096), in four alternating
rounds beside one SDPA call on the same inputs.  It prints each time, the
min and median, and the card's name and power limit.  Needs CUDA; imports
no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/attention/csrc/flash_attn_sm90.cu"
# (B, T, S, H, KV, hd, causal, window): the prefill shapes, and llama3.2-3b's
# heads with every key visible or with a 4x longer prompt
TIMED_SHAPES = [cs.SLICE_SHAPE, cs.SLICE_WINDOW_SHAPE, (4, 1024, 1024, 24, 8, 128, False, 0),
                (1, 4096, 4096, 24, 8, 128, True, 0)]


def variant_source(text: str, consts: dict) -> str:
    for name, value in consts.items():
        pattern = rf"^constexpr int {name} = \d+;"
        if not re.search(pattern, text, flags=re.M):
            raise ValueError(f"no top-level constexpr int {name} in {SOURCE.name}")
        text = re.sub(pattern, f"constexpr int {name} = {value};", text, flags=re.M)
    return text


def build(variants: dict, build_dir: Path) -> dict:
    """{name: (launch, error_string)} for every variant, nvcc in parallel."""
    from repro_torch.kernels import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = build_dir / f"flash_attn_sm90_{name}.cu"
        src.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)]
        procs[name] = (src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"{name}: {regs}")
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        fn, err = lib.flash_attn_sm90_fwd, lib.flash_attn_sm90_error_string
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        entries[name] = (fn, err)
    return entries


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="comma-separated NAME=value constants, e.g. STAGES=2,QBUF=2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.attention import kernel, ops, ref

    text = SOURCE.read_text()
    variants = {"base": text}
    for spec in args.variant:
        consts = dict(kv.split("=") for kv in spec.split(","))
        variants[spec.replace("=", "").replace(",", "_")] = variant_source(text, consts)
    entries = build(variants, ROOT / "src/repro_torch/kernels/build/variants")

    for name, entry in entries.items():
        kernel._entries["flash_attn_sm90"] = entry
        for i, shape in enumerate([cs.SLICE_SHAPE, cs.SLICE_WINDOW_SHAPE, *cs.RAGGED_SHAPES]):
            cs.check_attention(shape, "bfloat16", seed=i)

    for shape in TIMED_SHAPES:
        q, k, v = cs.attention_inputs(shape, torch.bfloat16, seed=7)
        t, s, causal, window = shape[1], shape[2], shape[6], shape[7]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = ref.visible_mask(t, s, causal=causal, window=window, device=q.device) if window else None
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
        runs = {name: None for name in entries} | {"sdpa": None}
        times = {name: [] for name in runs}
        for rnd in range(4):
            for name in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
                if name == "sdpa":
                    fn = sdpa
                else:
                    kernel._entries["flash_attn_sm90"] = entries[name]
                    fn = lambda: ops.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
                times[name].append(cs.cuda_ms(fn, iters=100, warmup=10))
        _, _, flops = cs.attention_bound(shape, "bfloat16")
        print(f"times at {shape}, ms:")
        for name, ts in times.items():
            st = sorted(ts)
            print(f"  {name:24s} {' '.join(f'{x:.4f}' for x in ts)}; min {st[0]:.4f}, median "
                  f"{(st[1] + st[2]) / 2:.4f} ({flops / st[0] / 1e9:.1f} TFLOP/s at the min)")
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
