#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py
    python3 chip_smoke.py --only 15   # phases 1, 2 and 15 alone: no kernels line, no last line
    python3 chip_smoke.py --only 16   # phases 1, 2 and 16 alone: no kernels line, no last line

1. Print the device, and its name and power limit from nvidia-smi.
2. Build every CUDA kernel of the port from the sources in this checkout,
   print the build time and ptxas's register lines, and count in the SASS of
   the bf16 attention kernel its tensor-core (HGMMA) and TMA (UTMALDG)
   instructions, and in that of the tensor-core wkv6 kernel its mma.sync
   (HMMA), wgmma (HGMMA) and cp.async (LDGSTS) instructions.
3. Hold the flash-attention kernel against its plain PyTorch version on the
   card: the five shapes of tests/test_kernels.py in f32 (the scalar route)
   and bf16 (the wgmma + TMA route), ragged bf16 shapes at every head dim,
   and the llama3.2-3b prefill shape (B=4, T=S=1024, H=24, KV=8, hd=128,
   bf16, causal, and window 256).  At the prefill shapes: the bf16 route's
   time, TFLOP/s and roofline share beside SDPA's time taken in turns
   (kernel, SDPA, kernel), the plain version's time, and the f32 route's
   time at the causal shape in f32 beside its bound and SDPA's f32 time,
   in turns as well.
4. Serve llama3.2-3b at full width in bf16 with random weights from a seed:
   batch 4, prompt length 1024, 32 greedy tokens through the port's serving
   entry point, counting kernel launches; then the same prefill with the plain
   attention, each layer fed the same input on both paths, and the smoke
   config in f32 against its plain path.
5. Hold both wkv6 kernels against their plain PyTorch version on the card:
   the scalar route at the four wkv shapes of tests/test_kernels.py, chunk
   16/32/64, bf16 r/k/v, strong decay and a ragged prompt; the tensor-core
   route at K = V = 64 with chunk 16/32/48/64, bf16 and strong decay; both
   at the rwkv6-3b prefill scan (B=4, T=1024, H=40, K=V=64, bf16 r/k/v,
   f32 w, chunk 32), with both kernels' times, the plain time, and the
   bound of each route's pipe there.
6. Serve rwkv6-3b at full width in bf16 with random weights from a seed:
   batch 4, prompt length 1024, 32 greedy tokens through the same entry
   point, counting kernel launches (one wkv6 launch per prefill layer, all
   on the tensor-core route);
   then the same prefill with the plain wkv scan, and the smoke config in
   f32 against its plain path.
7. Run the simulation engine (no kernel of the port lies on its path): the
   five controllers' sync trajectories against tests/goldens/quadratic_mc.npz
   in the legacy threefry mode; then fig2's five cells (adaptive and fixed
   k = 10, 20, 30, 40) at full width, R=32, n=50, m=2000, d=100, 1000
   iterations each, graph-replayed, against the same cells run eagerly on
   the card (bitwise, over the first eval block of 500 iterations, as
   phase 8 holds its grid) and run on the CPU (500 iterations); print the
   launches and ms of an iteration both ways, the device's idle share and
   top operations, and the peak memory.
8. Run the sweep engine (no kernel of the port on its path either): fig2's
   five cells as one grid of 160 lanes (1000 iterations) and the
   ablation's 15 cells (5 controllers x Exponential, Pareto, Bimodal, R=8)
   as one grid of 120 (500 iterations), each one program; hold each grid
   graph-replayed against eager on the card (bitwise), each cell against
   the looped engine on the card (fig2: phase 7's runs) and against the
   grid on the CPU (500 iterations); repopulate the fig2 grid with other
   eta and k and require no new capture; print the fig2 grid's ms an
   iteration both ways, its launches, idle share, top operations and the
   peak memory of its program.
9. Run the async modes (no kernel of the port on their path either):
   fig_async's grid at its published size (a two-speed fleet of n = 20:
   14 exp(1) and 6 exp(0.25) workers, m = 400, d = 20, R = 32, five arms
   over sync, K-async and K-batch-async, 160 lanes) as one program, 200
   iterations graph-replayed; hold it against eager on the card (bitwise,
   10 iterations), each arm looped on the card, and the grid on the CPU
   (100 iterations); repopulate it and require no new capture; print its
   ms an iteration, capture seconds, memory, launches, idle share and top
   operations, and a looped cell's ms and launches for each mode.  Then a K = 1 K-async cell on a Deterministic
   fleet (every clock tied), graph-replayed against eager and against the
   port's event-driven host loop, and the K = 1 engine's rate of updates
   beside the host loop's.
10. Run faults and robust aggregation (no kernel of the port on their path
   either): the reference test's forced grid (seven cells over every fault
   family, every robust aggregator and the three modes) graph-replayed
   against eager (bitwise) and each cell against the looped engine on the
   card; then fig_byzantine's grid at its published size (18 cells: 0, 10
   and 30% rushing sign-flip workers x the weighted mean and the geometric
   median x adaptive, k = 4 and k = 16; n = 20, m = 400, d = 20, R = 32,
   576 lanes) as one program, 200 iterations graph-replayed, against eager
   (bitwise, 10 iterations), each cell looped on the card and the grid on
   the CPU (100 iterations); repopulate it and require no new capture (and
   a random_gauss variant, one capture and none on its repopulation);
   print its ms an iteration, capture seconds, memory, launches, idle share
   and top operations, a looped cell's ms and launches for each
   aggregator; then the whole figure (6000 iterations) with its wall time,
   the reference's two headline flags and the times to target.
11. Train (the LM training path, `launch/steps.py`): llama3.2-3b at full
   width and depth in bf16 with random weights from seed 0 and remat on,
   sync fastest-k with AdamW (lr 3e-4), Pflug at the train CLI's defaults,
   Exponential(1) stragglers, 4 workers, batch 8 x seq 512, 6 steps: every
   CE finite, k in [1, 4], sim_time rising, the eval forward's 28
   flash-attention launches a step, its CE against the plain path's, ms a
   step, tokens/s, train_mfu, peak memory and the device's time by kernel;
   qwen1.5-0.5b at full width in kasync and kbatch (3 steps each: finite
   values, ms a step, peak memory); the train step on the card against the
   CPU at smoke width (f32, llama3.2-3b and rwkv6-3b, sync, kasync, kbatch
   and sync with 2 microbatches); and `quickstart --setup lm` (fig_lm's
   grid) at 60 iterations, graph-replayed against eager (bitwise), each
   cell against its looped run and the grid against the CPU, with its ms an
   iteration and launches, then the whole 600-iteration figure.
12. The MoE and hybrid families (`models/moe.py`, `models/hybrid.py`): the
   flash-attention kernel at their prefill shapes (qwen3-moe-30b-a3b B=4,
   T=1024, H=32, KV=4, hd=64; granite-moe-1b-a400m H=16, KV=8; hymba-1.5b
   T=2048, H=25, KV=5, window 1024; bf16, causal) against its plain version,
   timed in turns with SDPA; qwen3-moe-30b-a3b (~60 GB of bf16 weights, in a
   process of its own), granite-moe-1b-a400m and hymba-1.5b (prompt 2048,
   window 1024) served at full width and depth, batch 4, 32 greedy tokens,
   with one flash-attention launch a prefill layer, prefill ms, decode
   tokens/s, peak memory, the device's idle share and top operations, each
   layer's attention sub-block held to the plain path and, for MoE, the
   share of tokens whose expert set differs between the paths; the smoke
   configs in f32 against their plain path; granite-moe-1b-a400m and
   hymba-1.5b trained at full width (sync, AdamW, Pflug, batch 8 x 512, 3
   steps: finite ce and moe_aux, k in [1, 4], rising sim_time, one flash
   launch a layer a step); the train step of all three on the card against
   the CPU at smoke width.
13. The vlm and encdec families and the large dense archs: the
   flash-attention kernel at head dims 192 and 256 in both routes
   (tests/test_kernels.py's shapes and ragged T) and the f32 route at hd 48
   against the plain version; at the prefill shapes of seamless-m4t-medium's
   decoder (B=4, T=1024, H=KV=16, hd=64), paligemma-3b (256 patches + 1024
   tokens, H=8, KV=1, hd=256), qwen1.5-110b (H=64, KV=8, hd=128) and
   nemotron-4-340b (H=96, KV=8, hd=192) and the two train steps' eval
   shapes, timed in turns with SDPA; the four archs served at full width
   (qwen1.5-110b at 8 layers, nemotron-4-340b at 2), batch 4, prompt 1024,
   32 greedy tokens, seeded random frames and patches, in a process of
   their own, with one flash launch a decoder layer, prefill ms, decode
   tokens/s, peak memory, idle share, each layer's attention sub-block held
   to the plain path; seamless-m4t-medium and paligemma-3b trained at full
   width (phase 12's recipe), the eval forward at the trained parameters
   held to the plain path; the four smoke configs in f32 on the card
   against the CPU (serving and the train step).
14. The paper's experiment entry points (no kernel of the port on their
   path): `train --simulate` at fig2's widths (m = 2000, d = 100, n = 50,
   R = 32, 2000 iterations, every controller x exp(1) and Pareto, 10
   cells) and a mixed grid (sync and kasync x n 10, 20 x no fault and 10%
   sign flips x the weighted mean and the geometric median x Pflug and
   fixed k x exp(1) and Pareto, 64 cells, m = 400, d = 20), through
   `train.main`, every cell line checked; each grid at R = 4, 300
   iterations on the card against the CPU; then the figure functions
   (`launch/figures.py`): fig1, fig_hetero at its size (5 cells x R = 32
   x 12 000 iterations) and fig3 at 500 iterations with one seed of its
   host loop, each one's wall time and `derived` line, the host loop's
   events a second on the card and on the CPU over the same horizon, and
   fig_hetero's cells at 300 iterations card against CPU.
15. Distribution and blocked attention.  Blocked attention
   (`attention_impl="blocked"`, plain PyTorch) at one llama3.2-3b layer
   (B=4, T=1024) in f32 and bf16, blocks 1024 and 256, against the naive
   path at the kernels' tolerances, timed beside the naive path and the
   flash kernel.  A world of one NCCL rank in a spawned process, on a
   (1, 1) ("data", "model") mesh: llama3.2-3b's prefill at full width and
   depth with DTensor parameters (its 28 flash launches through the
   wrapper's local-shard path) against the mesh-free prefill, then three
   sync train steps at phase 11's recipe.
   Four gloo ranks sharing the card (NCCL takes one rank a GPU), each
   running its lane block on the card and gathering the small results
   over gloo: fig2's grid (160 lanes, 1000 iterations) on ("cells",
   "replicas") meshes (1, 4) and (2, 2), then repopulated on (1, 4) with
   no new capture, and five cells of phase 14's mixed grid on (2, 2) (cells pad
   5 -> 6), each against the one-device grid (time and k bitwise; the
   loss within 1e-6 for fig2's grid and within the engine's 1e-4 for the
   mixed grid, whose moded step rounds differently for another lane count
   on the card (up to 4.9e-5 measured), below the loss at w = 0, a
   diverging lane's gap reported), each rank's ms an iteration and the
   wall time, and the
   `train --simulate` header in that world; then one sync train step of
   qwen1.5-0.5b smoke on a ("data", "model") (2, 2) mesh of the host's
   DTensors, the vocab on "model" (the vocab-parallel CE; gloo cannot move
   CUDA DTensors on the card's torch), against the mesh-free step: k
   exact, ce within 1e-6.  The world-1 train steps run mesh-free and then
   on the mesh in the same process: k and sim_time equal, ce within 1e-5,
   the CE vocab-parallel on CUDA DTensors, ms a step and peak memory of
   both.  The reference's attention layouts: the flash kernel on each of
   the 16 ranks' head pieces of a 16-way model axis at qwen3-moe-30b-a3b's
   and granite-moe-1b-a400m's full-width prefill heads (2 q heads over 1 kv
   head, 1 over 1), all run in turn on the one card and joined along the
   heads, against the kernel on the whole tensor (bitwise, or within the
   kernel's own tolerance), in f32 and bf16; and in the four-rank world, on
   a (1, 4) mesh of the host's DTensors, llama3.2-3b smoke (the query
   sequence split, its decode on a sequence-sharded cache) and
   qwen3-moe-30b-a3b smoke (heads, the kv heads sliced) generating and
   taking a sync train step against the mesh-free run (logits within 1e-5,
   tokens equal, k exact, ce within 1e-6), each rank's attention pieces
   printed.
16. The dry run, the roofline and the kernel cache (`launch/dryrun.py`,
   `roofline/`, `core/cache.py`; started before phase 14, the trio's traces
   run on the host's cores beside phases 14 and 15).  The reference dry-run
   test's trio at full depth, each in a process of its own on a fake world,
   tracing the card's program (fake CUDA tensors through the kernels'
   custom ops): qwen1.5-0.5b train_4k on (16, 16) (256 ranks), llama3.2-3b
   decode_32k on (2, 16, 16) (512 ranks), rwkv6-3b long_500k; each one's
   trace seconds, per-rank FLOPs, bytes and collective bytes by type,
   analytic and traced memory and dominant term, no launch, qwen fitting
   80 GB and rwkv's analytic total below 1 GB, qwen's all-gather at least
   70 GB below the 163.6 GB of the vocab-gathered CE.  Beside them, one job
   per site of the sharded path that DTensor on the card's torch refused
   until the port ran it on local shards: qwen3-moe-30b-a3b train_4k,
   hymba-1.5b train_4k, rwkv6-3b prefill_32k on (2, 16, 16), hymba-1.5b
   decode_32k on (2, 16, 16), each traced with counts > 0, no launch and
   the kernels' custom ops called where the step reaches them; and
   llama3.2-3b decode_32k and train_4k on (16, 16), whose attention takes
   the reference's layouts, the decode's collective bytes at least the
   gathered cache's part below the 6.03e10 of the gathering decode (JSONs
   and logs under results/torch/dryrun_trio/).  `roofline.count_step` on llama3.2-3b's bf16
   prefill (batch 4 x 1024, 28 launches) and on its fake twin: FLOPs, bytes
   and kernel calls equal; the prefill's ms against its roofline bound; the
   analytic state bytes equal to the weights allocated, the analytic total
   beside `max_memory_allocated` and the card's total.  Two fresh processes
   sharing a new REPRO_COMPILATION_CACHE_DIR: the first builds all four
   libraries, the second adds 0 entries; the seconds of each from start to
   its first launch.  One full-width train step pair of qwen1.5-0.5b
   (sync, batch 8 x 512, 2 steps) with remat_policy "dots" against "full":
   ms, peak GB, ce within 1e-5.
17. Print one `kernels` JSON line, the card again, and, as the last line,
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line.  It does the same when there is no CUDA device or no port beside it.
No kernel has a CPU path and nothing falls back to a plain version; the
engine and training phases run the CPU only as the reference they are held
to.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 without them
# The tensor-core wkv6 kernel's pipe: TF32 tensor cores (495 TFLOP/s) with
# every f32 product split into three TF32 passes.
PEAK_FLOPS["tf32x3"] = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12

# (B, T, S, H, KV, hd, causal, window): tests/test_kernels.py ATTN_SHAPES
ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 64, True, 64),
    (2, 128, 256, 8, 2, 32, False, 0),
    (1, 128, 128, 8, 1, 64, True, 0),
    (1, 512, 512, 2, 2, 128, True, 128),
]
# Edges of the bf16 route's 128 x 128 tiles: ragged T = S at every head dim,
# non-causal T != S with S ragged, a window that crosses tile boundaries.
RAGGED_SHAPES = [(1, t, t, 4, 2, hd, True, 0) for hd in (32, 64, 128) for t in (65, 100, 129, 200)] + [
    (2, 128, 200, 4, 2, 64, False, 0),
    (1, 100, 65, 4, 1, 128, False, 0),
    (1, 512, 512, 4, 2, 128, True, 96),
]
# The attention of every llama3.2-3b prefill layer at batch 4, prompt 1024.
SLICE_SHAPE = (4, 1024, 1024, 24, 8, 128, True, 0)
SLICE_WINDOW_SHAPE = (4, 1024, 1024, 24, 8, 128, True, 256)
# Kernel vs plain, as tests/test_kernels.py holds the Pallas kernel to its oracle:
# f32 differs only in summation order; bf16 also in where the plain version
# rounds its scores and probabilities to bf16 (2^-8 relative).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Full model, kernel vs plain attention, max |dlogits| / max |logits|: the plain
# path rounds scores and probabilities to bf16 in each of the 28 layers, and
# those ~2^-8 relative differences carry through the residual stream; 0.1 is
# about ten times the difference that alone predicts.  Layer by layer, each
# layer fed the same input on both paths: below 2e-2 of the layer's max
# output, a few bf16 roundings (the bound of the rwkv check below).
MODEL_REL_TOL = 0.1
LLAMA_LAYER_TOL = 2e-2

# (B, T, H, K, V, chunk, decay_scale, r/k/v dtype): tests/test_kernels.py's
# four wkv shapes, its chunk sizes, bf16 inputs and strong decay; then K = V
# = 64 at every chunk the tensor-core route takes, bf16, strong decay at
# chunks 32 and 64, and a ragged 64-wide prompt (scalar route).
WKV_CASES = [
    (2, 128, 3, 16, 16, 32, 0.5, "float32"),
    (1, 64, 2, 32, 32, 32, 0.5, "float32"),
    (1, 256, 1, 64, 64, 32, 0.5, "float32"),
    (4, 32, 2, 8, 8, 32, 0.5, "float32"),
    (2, 128, 2, 16, 16, 16, 0.5, "float32"),
    (2, 128, 2, 16, 16, 32, 0.5, "float32"),
    (2, 128, 2, 16, 16, 64, 0.5, "float32"),
    (1, 64, 2, 16, 16, 32, 0.5, "bfloat16"),
    (1, 128, 1, 8, 8, 64, 1.0, "float32"),
    (2, 128, 2, 64, 64, 16, 0.5, "float32"),
    (2, 192, 2, 64, 64, 48, 0.5, "float32"),
    (2, 128, 2, 64, 64, 64, 0.5, "bfloat16"),
    (1, 128, 2, 64, 64, 32, 1.0, "bfloat16"),
    (1, 128, 2, 64, 64, 64, 1.0, "float32"),
    (2, 20, 4, 64, 64, 32, 0.5, "float32"),
]
# The wkv scan of every rwkv6-3b prefill layer at batch 4, prompt 1024.
WKV_SLICE = (4, 1024, 40, 64, 64, 32, 0.5, "bfloat16")
# Kernel vs plain: tests/test_kernels.py's tolerances (atol, rtol) for f32,
# bf16 inputs and strong decay.  Both sides compute in f32 from the same
# inputs, so they differ only in the order of f32 sums.
WKV_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (5e-2, 5e-2), "strong": (2e-3, 5e-3)}
# Full rwkv6-3b, kernel vs plain wkv scan.  Both scans are f32 from the same
# inputs and differ by ~1e-6 relative, so a layer's output changes only where
# that moves a bf16 rounding (2^-8 relative) of the normed wkv output.
# - Layer by layer, each layer fed the same input (the kernel path's): max
#   |dout| / max |out| of the layer below 2e-2, a few bf16 roundings.
# - In bf16, max |dlogits| / max |logits| below 0.5: through 32 layers of
#   random weights the bf16 model carries a rounding-level change up to the
#   size of its logits' own spread.  The run prints the control beside it:
#   the plain scan at chunk 16 against chunk 32, which changes only the
#   order of sums.  A wrong scan moves the logits by more than their max.
# - In f32 (weights cast up), max |dlogits| / max |logits| below 1e-3: f32
#   roundings are 2^16 times finer than bf16's, so the same 32 layers leave
#   them far below the bf16 gap.
RWKV_LAYER_TOL, RWKV_F32_TOL, RWKV_BF16_TOL = 2e-2, 1e-3, 0.5


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_counts(build, name: str, opcodes) -> dict:
    """How many SASS lines of the library built from `<name>.cu` hold each
    opcode, from the toolkit's cuobjdump."""
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    lib = build.library_path(next(src for src in build.sources() if src.stem == name))
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: sum(op in line for line in sass.splitlines()) for op in opcodes}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(fn, label: str, per_call_ms: float, top: int = 6) -> None:
    """Profile one fn() with torch.profiler and print where the device time
    goes: kernel time by group and the top kernels, and the idle share
    against `per_call_ms` (a CUDA-event time of the same call, unprofiled)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print(f"  {label}: device time by kernel not measured (the profiler saw no device time)")
        return
    groups = {"flash_attn kernel": 0.0, "wkv kernel": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        g = "flash_attn kernel" if "flash_attn" in low else "wkv kernel" if "wkv6" in low else (
            "matmul" if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "gemv")) else "other")
        groups[g] += ms
    shares = ", ".join(f"{g} {ms:.2f} ms ({ms / busy:.1%})" for g, ms in groups.items())
    print(f"  {label}: device busy {busy:.2f} ms of {per_call_ms:.2f} ms "
          f"(idle share {max(0.0, 1 - busy / per_call_ms):.1%}); {shares}")
    for name, ms, count in rows[:top]:
        print(f"    {ms:9.3f} ms  x{count:<4d} {name[:110]}")


def attention_bound(shape, dtype_name: str):
    """(ms, "operations" | "bytes", flops): the least time an H100 needs for
    this attention: 4*hd flops for every visible (query, key) pair against
    the peak for the dtype, or q, k, v read and o written once against HBM."""
    from repro_torch.kernels.attention.ref import visible_mask

    b, t, s, h, kv, hd, causal, window = shape
    pairs = int(visible_mask(t, s, causal=causal, window=window).sum()) if (causal or window) else t * s
    flops = 4.0 * hd * pairs * b * h
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * b * t * h * hd + 2 * b * s * kv * hd) * elem
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def attention_inputs(shape, dtype, seed: int):
    import torch

    b, t, s, h, kv, hd, _, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return mk(b, t, h, hd), mk(b, s, kv, hd), mk(b, s, kv, hd)


def check_attention(shape, dtype_name: str, seed: int) -> float:
    """Kernel vs plain version on the card; returns the max abs error."""
    import torch
    from repro_torch.kernels.attention import ops, ref

    dtype = getattr(torch, dtype_name)
    q, k, v = attention_inputs(shape, dtype, seed)
    causal, window = shape[6], shape[7]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    plain = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    o, p = out.float(), plain.float()
    err = (o - p).abs().max().item()
    tol = TOL[dtype_name]
    ok = bool(torch.isfinite(o).all()) and bool(((o - p).abs() <= tol + tol * p.abs()).all())
    print(f"  attention {shape} {dtype_name}: max_abs_err {err:.3e} (atol=rtol={tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with the plain version at {shape} {dtype_name}")
    return err


def time_attention(shape):
    """Times in ms at a bf16 shape: the kernel and the library call (SDPA, with an
    explicit mask when there is a window) in turns, kernel, SDPA, kernel;
    then the plain version.  Returns (kernel_ms_1, library_ms, kernel_ms_2,
    plain_ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref

    q, k, v = attention_inputs(shape, torch.bfloat16, seed=7)
    t, s, causal, window = shape[1], shape[2], shape[6], shape[7]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window:
        mask = ref.visible_mask(t, s, causal=causal, window=window, device=q.device)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    else:
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
    kernel = lambda: ops.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
    kernel_ms_1 = cuda_ms(kernel, iters=100, warmup=10)
    library_ms = cuda_ms(library, iters=100, warmup=10)
    kernel_ms_2 = cuda_ms(kernel, iters=100, warmup=10)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal, window=window), iters=5)
    return kernel_ms_1, library_ms, kernel_ms_2, plain_ms


def report_attention_times(label: str, shape):
    """Print the bf16 route's time, TFLOP/s and roofline share beside SDPA's;
    returns (kernel_ms, plain_ms, library_ms, bound_ms, bound_by)."""
    k1, lib_ms, k2, plain_ms = time_attention(shape)
    kernel_ms = (k1 + k2) / 2
    bound_ms, bound_by, flops = attention_bound(shape, "bfloat16")
    print(f"  {label} {shape} bf16: kernel {k1:.4f} / {k2:.4f} ms (mean {kernel_ms:.4f}, "
          f"{flops / kernel_ms / 1e9:.1f} TFLOP/s), library (SDPA) {lib_ms:.4f} ms "
          f"(kernel/SDPA {kernel_ms / lib_ms:.2f}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"roofline share {bound_ms / kernel_ms:.4f}")
    return kernel_ms, plain_ms, lib_ms, bound_ms, bound_by


def wkv_inputs(case, seed: int):
    """r, k, v (in the case's dtype), w, u, s0 (f32) on the card, distributed
    as tests/test_kernels.py's: decays w = exp(-exp(N(0,1) * decay_scale))."""
    import torch

    b, t, h, k, v, _, decay_scale, dtype_name = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *sh: torch.randn(sh, generator=gen, device="cuda")  # noqa: E731
    dt = getattr(torch, dtype_name)
    return (n(b, t, h, k).to(dt), n(b, t, h, k).to(dt), n(b, t, h, v).to(dt),
            torch.exp(-torch.exp(n(b, t, h, k) * decay_scale)), n(h, k) * 0.1, n(b, h, k, v) * 0.2)


def check_wkv(case, seed: int, kernel_name=None) -> float:
    """Kernel vs plain version on the card, on y and s_T; returns the max abs
    error.  Through the wrapper, asserting the route `kernel.route` names, or,
    given `kernel_name`, that kernel called directly."""
    import torch
    from repro_torch.kernels.wkv import kernel, ops, ref

    xs = wkv_inputs(case, seed)
    chunk = case[5]
    if kernel_name is None:
        name = kernel.route(case[1], case[3], case[4], chunk)
        before = dict(ops.route_launches)
        y, s = ops.wkv6(*xs, chunk=chunk)
        if ops.route_launches[name] != before[name] + 1:
            raise AssertionError(f"wkv6 at {case} did not run on the {name} route")
    else:
        name = kernel_name
        y, s = kernel.wkv6_bthk(*xs, chunk=chunk, kernel=name)
    py, ps = ref.wkv6_ref(*xs, chunk=min(chunk, case[1]))
    torch.cuda.synchronize()
    atol, rtol = WKV_TOL["strong" if case[6] >= 1.0 else case[7]]
    err, ok = 0.0, True
    for o, p in ((y, py), (s, ps)):
        err = max(err, (o - p).abs().max().item())
        ok = ok and bool(torch.isfinite(o).all()) and bool(((o - p).abs() <= atol + rtol * p.abs()).all())
    print(f"  wkv6 {case} [{name}]: max_abs_err {err:.3e} (atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"wkv6 kernel disagrees with the plain version at {case}")
    return err


def wkv_bound(case, with_s0: bool = True, pipe: str = "float32"):
    """(ms, "operations" | "bytes"): the least time an H100 needs for this
    scan.  Bytes: r, k, v read once in their dtype, w read once in f32, y and
    s_T written once in f32, s0 read once if given.  Operations, per chunk of
    C and per (b, h): 4*C*K*V for the state's application to r and its
    update (a multiply-add each), and C*(C+1)*(K+V) for the scores and their
    application to v over tau <= t; against the peak of `pipe`: "float32",
    the f32 pipe without tensor cores (the scalar kernel), or "tf32x3", the
    TF32 tensor cores at a third of their rate (the tensor-core kernel, which
    splits each f32 product into three).  The expf calls are not counted."""
    b, t, h, k, v, chunk, _, dtype_name = case
    c = min(chunk, t)
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = b * t * h * ((2 * k + v) * elem + 4 * k + 4 * v) + 4 * b * h * k * v * (2 if with_s0 else 1)
    flops = (t // c) * b * h * (4 * c * k * v + c * (c + 1) * (k + v))
    t_ops, t_bytes = flops / PEAK_FLOPS[pipe], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def wkv_bounds(case) -> dict:
    """The bound of each route's pipe: {"tf32x3": (ms, by), "float32": (ms, by)}."""
    return {pipe: wkv_bound(case, pipe=pipe) for pipe in ("tf32x3", "float32")}


def time_wkv(case):
    """Times in ms of the tensor-core kernel and the scalar kernel in turns
    (tensor-core, scalar, tensor-core), then the plain version.  No single
    PyTorch call computes wkv6, so there is no library time.  Returns
    (sm90_ms_1, scalar_ms, sm90_ms_2, plain_ms)."""
    from repro_torch.kernels.wkv import kernel, ref

    xs = wkv_inputs(case, seed=7)
    chunk = case[5]
    sm90 = lambda: kernel.wkv6_bthk(*xs, chunk=chunk, kernel="wkv6_sm90")  # noqa: E731
    sm90_ms_1 = cuda_ms(sm90, iters=50, warmup=5)
    scalar_ms = cuda_ms(lambda: kernel.wkv6_bthk(*xs, chunk=chunk, kernel="wkv6"))
    sm90_ms_2 = cuda_ms(sm90, iters=50, warmup=5)
    plain_ms = cuda_ms(lambda: ref.wkv6_ref(*xs, chunk=chunk), iters=3)
    return sm90_ms_1, scalar_ms, sm90_ms_2, plain_ms


def reset_counts(counters) -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for c in counters.values():
        if hasattr(c, "reset_counts"):
            c.reset_counts()
        else:
            c.launches = 0


def serve_rwkv(counters) -> int:
    """Phase 6: rwkv6-3b at full width; returns the wkv6 launches of the serve run."""
    import torch
    from repro_torch.checkpoint import convert
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = get_config("rwkv6-3b")
    b, t, new = 4, 1024, 32
    print(f"[6] serve {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}, "
          f"batch {b}, prompt {t}, {new} new tokens")
    model = build_model(cfg, "cuda")
    params = convert.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    weight_gb = sum(a.numel() * a.element_size() for a in _leaves(params)) / 1e9
    prompts = serve.random_prompts(cfg, b, t, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res = serve.generate(model, params, prompts, new)
    launches = {name: c.launches for name, c in counters.items()}
    routes = dict(counters["wkv6"].route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches during the run: {launches}, wkv6 by route {routes} (expected wkv6 {cfg.n_layers}, one per "
          f"prefill layer, all on wkv6_sm90; decode steps the state in plain PyTorch)")
    if launches != {"flash_attention": 0, "wkv6": cfg.n_layers}:
        raise AssertionError(f"expected {cfg.n_layers} wkv6 launches and no other, got {launches}")
    if routes != {"wkv6": 0, "wkv6_sm90": cfg.n_layers}:
        raise AssertionError(f"expected all {cfg.n_layers} wkv6 launches on the tensor-core route, got {routes}")
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("prefill logits are not finite")
    if tuple(res.tokens.shape) != (b, new) or not bool(((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(res.tokens.shape)}")
    cache = model.init_cache(b, t + new)
    state_mb = sum(a.numel() * a.element_size() for a in cache.values()) / 1e6
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    steps = new - 1
    print(f"  weights {weight_gb:.2f} GB, decode cache {state_mb:.1f} MB; peak memory {peak_gb:.2f} GB "
          f"of {total_gb:.1f} GB")
    if not peak_gb < total_gb:
        raise AssertionError("peak memory above the card's")
    print(f"  first prefill {res.prefill_s * 1e3:.1f} ms; decoded {steps} steps x batch {b} in "
          f"{res.decode_s:.3f}s ({steps * b / res.decode_s:.1f} tok/s)")
    print(f"  tokens[0]: {res.tokens[0].tolist()}")

    plain_model = build_model(cfg.replace(use_kernels=False), "cuda")
    prefill_ms = cuda_ms(lambda: model.prefill(params, {"tokens": prompts}), iters=3, warmup=1)
    plain_prefill_ms = cuda_ms(lambda: plain_model.prefill(params, {"tokens": prompts}), iters=3, warmup=1)
    plain_logits, _ = plain_model.prefill(params, {"tokens": prompts})
    lg = res.prefill_logits
    rel = rel_gap(lg, plain_logits)
    agree = int((lg.argmax(-1) == plain_logits.argmax(-1)).sum())
    print(f"  prefill {prefill_ms:.1f} ms with the kernel, {plain_prefill_ms:.1f} ms with the plain wkv scan")
    device_breakdown(lambda: model.prefill(params, {"tokens": prompts}), "prefill, kernel path", prefill_ms)
    device_breakdown(lambda: plain_model.prefill(params, {"tokens": prompts}), "prefill, plain path",
                     plain_prefill_ms)
    token = res.tokens[:, -1:]
    decode_ms = cuda_ms(lambda: model.decode_step(params, token, cache, t), iters=5, warmup=2)
    device_breakdown(lambda: model.decode_step(params, token, cache, t), "one decode step", decode_ms)
    control = rel_gap(plain_logits, build_model(cfg.replace(use_kernels=False, wkv_chunk=16), "cuda").prefill(
        params, {"tokens": prompts})[0])
    print(f"  kernel vs plain wkv scan, bf16: max|dlogits|/max|logits| {rel:.3e} (bound {RWKV_BF16_TOL}); "
          f"argmax agrees on {agree}/{b} rows; control, plain scan at chunk 16 vs 32: {control:.3e}")
    layer_rel = per_layer_gap(cfg, params, prompts)
    print(f"  kernel vs plain wkv scan, each layer fed the same input: worst max|dout|/max|out| "
          f"{layer_rel:.3e} (bound {RWKV_LAYER_TOL})")
    del plain_logits, res, cache
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params32 = _map(params, lambda a: a.float())
    del params
    lg32 = build_model(cfg32, "cuda").prefill(params32, {"tokens": prompts})[0]
    rel32 = rel_gap(lg32, build_model(cfg32.replace(use_kernels=False), "cuda").prefill(
        params32, {"tokens": prompts})[0])
    print(f"  kernel vs plain wkv scan, f32 (weights cast up): max|dlogits|/max|logits| {rel32:.3e} "
          f"(bound {RWKV_F32_TOL})")
    del params32, lg32
    torch.cuda.empty_cache()

    # smoke config in f32: the kernel path against the plain path, prefill and decode
    small = get_smoke_config("rwkv6-3b")
    runs = {}
    for use in (True, False):
        runs[use] = serve.serve(small.replace(use_kernels=use), batch=2, prompt_len=128, new_tokens=8, seed=3)
    d = (runs[True].prefill_logits - runs[False].prefill_logits).abs().max().item()
    same = bool(torch.equal(runs[True].tokens, runs[False].tokens))
    print(f"  smoke config f32, kernel vs plain: max|dlogits| {d:.3e} (atol 1e-4), greedy tokens equal: {same}")
    if not (rel < RWKV_BF16_TOL and layer_rel < RWKV_LAYER_TOL and rel32 < RWKV_F32_TOL):
        raise AssertionError("rwkv6-3b: the kernel path disagrees with the plain path beyond its bounds")
    if not (d <= 1e-4 and same):
        raise AssertionError("rwkv smoke model: kernel path disagrees with the plain path")
    return routes["wkv6_sm90"]


def rel_gap(a, b) -> float:
    """max |a - b| / max |a|."""
    return ((a - b).abs().max() / a.abs().max()).item()


def per_layer_gap(cfg, params, prompts) -> float:
    """Worst max|dout|/max|out| over the layers when each layer gets the
    same input, the kernel path's output of the layer below, on both paths."""
    import torch
    from repro_torch.models import layers, transformer

    one = cfg.replace(n_layers=1)
    worst = 0.0
    with torch.inference_mode():
        x = layers.embed(params, cfg, prompts)
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.n_layers):
            p_i = _map(params["layers"], lambda a: a[i:i + 1])
            xk, _ = transformer.run_stack_prefill(p_i, one, x, pos)
            xp, _ = transformer.run_stack_prefill(p_i, one.replace(use_kernels=False), x, pos)
            worst = max(worst, rel_gap(xk.float(), xp.float()))
            x = xk
    return worst


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# The engine phase.  tests/goldens/quadratic_mc.npz: made by the JAX package
# with its legacy threefry (tests/goldens/gen_quadratic_goldens.py, whose
# constants these mirror): data from key 0 (m=60, d=4), 2 replicas split
# from key 123, n=6 workers, exp(1), eta 0.005, 60 iterations, eval every 25.
GOLDEN = dict(n=6, m=60, d=4, eta=0.005, iters=60, eval_every=25, replicas=2, data_seed=0, key_seed=123)
# k exact; time within 1e-6 relative: the port's log1p differs from XLA's by
# one ulp on some inputs, and 60 iterations of sums carry that to ~1e-7.
GOLDEN_TIME_RTOL = 1e-6
# fig2 at full width (R=32, n=50, m=2000, d=100), graph-replayed on the card
# against the same step run eagerly on the card over the first eval block
# (bitwise; an eager iteration is host-bound, ~25 ms) and against the
# port on the CPU at the first eval point (500 iterations): k equal, time
# within 1e-5 and loss within 1e-4 relative (the CPU's and the card's
# log1p, matmul sums and reductions differ in the last ulps).  A near-zero
# inner product g_j . g_{j-1} can flip a Pflug sign event and fork that
# replica's k: at most 2 of the 32 may fork, each reported.
ENGINE_ITERS, ENGINE_EAGER_ITERS, ENGINE_CPU_ITERS = 1000, 500, 500
ENGINE_TIME_RTOL, ENGINE_LOSS_RTOL, ENGINE_MAX_FORKS = 1e-5, 1e-4, 2


def golden_controllers():
    from repro_torch.core import controller as c

    n = GOLDEN["n"]
    return {
        "fixed": c.FixedKController(n_workers=n, k=2),
        "pflug": c.PflugController(n_workers=n, k0=1, step=1, thresh=3, burnin=5),
        "sketched_pflug": c.SketchedPflugController(n_workers=n, k0=1, step=1, thresh=3, burnin=5, sketch_dim=8),
        "schedule": c.ScheduleController(n_workers=n, switch_times=[2.0, 6.0], k0=1, step=2),
        "variance_ratio": c.VarianceRatioController(n_workers=n, k0=1, step=2, burnin=10),
    }


def engine_goldens() -> None:
    """The five controllers' sync trajectories on the card against the
    goldens, in the legacy threefry mode they were made in."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.core.montecarlo import run_monte_carlo
    from repro_torch.core.straggler import Exponential
    from repro_torch.data import make_linreg_data
    from repro_torch.launch.quickstart import squared_error

    g = GOLDEN
    gold = np.load(ROOT / "tests" / "goldens" / "quadratic_mc.npz")
    with prng.threefry_mode(False):
        data = make_linreg_data(prng.PRNGKey(g["data_seed"]), m=g["m"], d=g["d"], device="cuda")
        keys = prng.split(prng.PRNGKey(g["key_seed"], device="cuda"), g["replicas"])
        for name, ctrl in golden_controllers().items():
            res = run_monte_carlo(squared_error, torch.zeros(g["d"], device="cuda"), data.X, data.y,
                                  n_workers=g["n"], controller=ctrl, straggler=Exponential(rate=1.0),
                                  eta=g["eta"], num_iters=g["iters"], keys=keys, eval_every=g["eval_every"],
                                  device="cuda")
            k, t, loss = (getattr(res, f).cpu().numpy() for f in ("k", "time", "loss"))
            want = {f: gold[f"{name}__sync__{f}"] for f in ("k", "time", "loss")}
            t_gap = float(np.max(np.abs(t - want["time"]) / np.abs(want["time"])))
            l_gap = float(np.max(np.abs(loss - want["loss"]) / np.abs(want["loss"])))
            ok = np.array_equal(k, want["k"]) and t_gap <= GOLDEN_TIME_RTOL
            print(f"  goldens {name}: k equal {np.array_equal(k, want['k'])}, time max rel gap {t_gap:.3e} "
                  f"(rtol {GOLDEN_TIME_RTOL}), loss max rel gap {l_gap:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"engine on the card disagrees with the goldens for {name}")


def sign_event_divergence(eta: float, replica: int, iters: int):
    """The first iteration at which replica `replica` of fig2's adaptive cell
    takes a different Pflug sign event on the card than on the CPU (its
    count of negative inner products differs), from the engine's own step."""
    import torch
    from repro_torch.core.gradsource import PerExampleSource
    from repro_torch.core.montecarlo import initial_carry, make_step
    from repro_torch.core.straggler import Exponential
    from repro_torch.launch import quickstart

    cfg = quickstart.SETUPS["fig2"]
    ctrl = fig2_case("adaptive").controller
    counts = {}
    for dev in ("cuda", "cpu"):
        data, keys = quickstart.inputs("fig2", device=dev)
        step, _ = make_step(PerExampleSource(quickstart.squared_error), (data.X, data.y), cfg["n"], ctrl,
                            Exponential(rate=1.0), None, eta)
        carry, trace = initial_carry(ctrl, torch.zeros(cfg["d"], device=dev), keys[replica:replica + 1]), []
        for _ in range(iters):
            carry, _ = step(carry)
            trace.append(carry.ctrl_state.count_negative[0])
        counts[dev] = torch.stack(trace).cpu()
    diff = (counts["cuda"] != counts["cpu"]).nonzero()
    return int(diff[0, 0]) + 1 if len(diff) else None


def fig2_case(label: str, eta: float = 0.0):
    from repro_torch.launch import quickstart

    return {c.label: c for c in quickstart.cases("fig2", eta=eta)}[label]


def fig2_cell(label: str, device: str, iters: int, capture: bool, eta: float):
    """One fig2 cell through the port's looped engine, in a worker process:
    (time, loss, k) as numpy, and the wall seconds of the run."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import quickstart

    torch.set_num_threads(1)  # one core for each of the concurrent workers
    torch.backends.cuda.matmul.allow_tf32 = False
    data, keys = quickstart.inputs("fig2", device=device)
    t0 = time.perf_counter()
    res = quickstart.run_case("fig2", fig2_case(label, eta), data, keys, iters, capture)
    out = tuple(getattr(res, f).cpu().numpy() for f in ("time", "loss", "k"))
    return out, time.perf_counter() - t0


def engine_fig2() -> dict:
    """Phase 7: fig2's five cells at full width on the card, graph-replayed,
    against eager on the card and the port on the CPU; returns the numbers.
    The eager and CPU runs are host-bound, so each cell runs in a worker
    process of its own, after the graph-replayed run has been timed alone."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from repro_torch.core.gradsource import PerExampleSource
    from repro_torch.core.montecarlo import initial_carry, make_step, program_cache_stats
    from repro_torch.core.straggler import Exponential
    from repro_torch.launch import quickstart

    cfg = quickstart.SETUPS["fig2"]
    phase_t0 = time.perf_counter()
    print(f"[7] engine, fig2 at full width: R={cfg['replicas']}, n={cfg['n']}, m={cfg['m']}, d={cfg['d']}, "
          f"exp(1), {ENGINE_ITERS} iterations a cell, eval every {cfg['eval_every']}")
    engine_goldens()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = program_cache_stats()["traces"]
    graph = quickstart.run("fig2", iters=ENGINE_ITERS, device="cuda", looped=True)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    captures = program_cache_stats()["traces"] - before
    eta, labels = graph["eta"], list(graph["results"])
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=2 * len(labels), mp_context=multiprocessing.get_context("spawn")) as pool:
        eager_f = {lb: pool.submit(fig2_cell, lb, "cuda", ENGINE_EAGER_ITERS, False, eta) for lb in labels}
        cpu_f = {lb: pool.submit(fig2_cell, lb, "cpu", ENGINE_CPU_ITERS, True, eta) for lb in labels}
        eager = {lb: f.result() for lb, f in eager_f.items()}
        cpu = {lb: f.result() for lb, f in cpu_f.items()}
    workers_s = time.perf_counter() - t0
    n_iters = ENGINE_ITERS * len(labels)
    eager_s = max(s for _, s in eager.values())
    print(f"  graph-replayed: {len(labels)} cells in {graph['wall_s']:.2f} s with {captures} captures "
          f"({graph['wall_s'] / n_iters * 1e3:.4f} ms an iteration, captures included); eager, a worker process "
          f"a cell, {ENGINE_EAGER_ITERS} iterations: the slowest {eager_s:.2f} s "
          f"({eager_s / ENGINE_EAGER_ITERS * 1e3:.4f} ms an iteration); "
          f"CPU, {ENGINE_CPU_ITERS} iterations a cell: the slowest {max(s for _, s in cpu.values()):.2f} s; "
          f"{workers_s:.1f} s for all workers; eta {eta!r}")
    print(f"  peak memory of the graph-replayed run: {peak_mb:.2f} MB")
    for label in labels:
        g = graph["results"][label]
        gk, gt, gl = (getattr(g, f).cpu().numpy() for f in ("k", "time", "loss"))
        (et, el, ek), _ = eager[label]
        (ct, cl, ck), _ = cpu[label]
        e = ek.shape[1]  # the eval points of the eager run: the graph's first ones
        same = np.array_equal(gt[:, :e], et) and np.array_equal(gl[:, :e], el) and np.array_equal(gk[:, :e], ek)
        gk, gt, gl = gk[:, :1], gt[:, :1], gl[:, :1]
        forked = np.nonzero((gk != ck).any(axis=1))[0]
        keep = np.setdiff1d(np.arange(gk.shape[0]), forked)
        t_gap = float(np.max(np.abs(gt[keep] - ct[keep]) / np.abs(ct[keep])))
        l_gap = float(np.max(np.abs(gl[keep] - cl[keep]) / np.abs(cl[keep])))
        s = graph["cases"][label]
        print(f"  {label}: graph vs eager at iteration {ENGINE_EAGER_ITERS} bitwise equal {same}; card vs CPU at iteration {ENGINE_CPU_ITERS}: "
              f"{len(forked)} replicas forked in k, time max rel gap {t_gap:.3e}, loss {l_gap:.3e}; at "
              f"{ENGINE_ITERS}: sim_time {s['time_mean'][-1]:.1f}, excess {s['loss_mean'][-1] - graph['f_star']:.4g}, "
              f"k {s['k_mean'][-1]:.2f}")
        for i in forked:
            at = sign_event_divergence(eta, int(i), ENGINE_CPU_ITERS)
            print(f"    replica {i}: k card {gk[i].tolist()} CPU {ck[i].tolist()}; first differing sign event at "
                  f"iteration {at}")
        if not same:
            raise AssertionError(f"{label}: graph-replayed and eager runs differ")
        if len(forked) > (ENGINE_MAX_FORKS if label == "adaptive" else 0):
            raise AssertionError(f"{label}: {len(forked)} replicas forked in k between the card and the CPU")
        if not (t_gap <= ENGINE_TIME_RTOL and l_gap <= ENGINE_LOSS_RTOL):
            raise AssertionError(f"{label}: card and CPU differ beyond time rtol {ENGINE_TIME_RTOL} "
                                 f"or loss rtol {ENGINE_LOSS_RTOL}")
        if not (np.isfinite(gt).all() and np.isfinite(gl).all()):
            raise AssertionError(f"{label}: time or loss not finite")

    # steady state, the adaptive cell alone: ms an iteration both ways
    data, keys = quickstart.inputs("fig2", device="cuda")

    def cell(iters, capture=True):
        return quickstart.run_case("fig2", fig2_case("adaptive", eta), data, keys, iters, capture)

    cell(ENGINE_ITERS)  # the graphs of this configuration were captured above
    graph_ms = cuda_ms(lambda: cell(ENGINE_ITERS), iters=2, warmup=0) / ENGINE_ITERS
    eager_ms = cuda_ms(lambda: cell(100, capture=False), iters=2, warmup=1) / 100
    ctrl = fig2_case("adaptive").controller
    step, _ = make_step(PerExampleSource(quickstart.squared_error), (data.X, data.y), cfg["n"], ctrl,
                        Exponential(rate=1.0), None, eta)
    carry = initial_carry(ctrl, torch.zeros(cfg["d"], device="cuda"), keys)
    launches = count_kernels(lambda: step(carry))
    print(f"  steady state, adaptive cell: graph-replayed {graph_ms:.4f} ms an iteration, eager {eager_ms:.4f} ms; "
          f"{launches} kernel launches an iteration (eager, torch.profiler)")
    block = cfg["eval_every"]
    cell(block)  # captures this program's graphs before they are timed
    block_ms = cuda_ms(lambda: cell(block), iters=3, warmup=1)
    device_breakdown(lambda: cell(block), f"{block} iterations graph-replayed", block_ms, top=8)
    device_breakdown(lambda: step(carry), "one iteration eager", eager_ms, top=8)
    print(f"  phase 7 took {time.perf_counter() - phase_t0:.1f} s")
    return {"graph_ms": graph_ms, "eager_ms": eager_ms, "launches": launches, "peak_mb": peak_mb,
            "fig2_wall_s": graph["wall_s"], "eta": eta, "results": {
                lb: tuple(getattr(r, f).cpu().numpy() for f in ("time", "loss", "k"))
                for lb, r in graph["results"].items()}}


# The sweep phase.  fig2's grid (5 cells x R=32 = 160 lanes) at phase 7's
# 1000 iterations (its CPU run at 500); the ablation's grid (5 controllers x
# 3 families x R=8 = 120 lanes) at 500.  Each cell is held to the looped
# engine on the card (fig2: phase 7's runs) and to the port's grid on the
# CPU at ENGINE_TIME_RTOL / ENGINE_LOSS_RTOL, with at most ENGINE_MAX_FORKS
# forked replicas in a cell whose controller adapts from the gradients
# (Pflug, variance ratio): the library's products and reductions may round
# differently at another lane count, and a near-zero test statistic then
# forks k.  Graph-replayed against eager on the card, bitwise: fig2's grid
# over one eval block (500 iterations), the ablation's over its run.
ABLATION_ITERS = 500
# fig2's grid is profiled over 100 iterations (~78 000 kernels): the
# profiler's cost grows with the kernels it records.
PROFILE_ITERS = 100


def grid_run(setup: str, grid, device: str, iters: int, capture: bool, looped: bool = False, threads: int = 2):
    """The cells ``grid`` of ``setup`` through the port in a worker process,
    as one grid (`run_sweep`) or (``looped``) a `run_monte_carlo` call each:
    {label: (time, loss, k) numpy}, and the wall seconds of the run."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import quickstart

    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    data, keys = quickstart.inputs(setup, device=device)
    t0 = time.perf_counter()
    if looped:
        res = {c.label: quickstart.run_case(setup, c, data, keys, iters, capture) for c in grid}
    else:
        out = quickstart.run_grid(setup, grid, data, keys, iters, capture)
        res = {lb: out.cell(g) for g, lb in enumerate(out.labels)}
    arrays = {lb: tuple(getattr(r, f).cpu().numpy() for f in ("time", "loss", "k")) for lb, r in res.items()}
    return arrays, time.perf_counter() - t0


def cells_of(result) -> dict:
    """{label: (time, loss, k) numpy} of a SweepResult."""
    return {lb: tuple(getattr(result.cell(g), f).cpu().numpy() for f in ("time", "loss", "k"))
            for g, lb in enumerate(result.labels)}


def hold(what: str, got: dict, want: dict, adaptive: set, cols: int | None = None) -> None:
    """Hold every cell of ``got`` to ``want`` (the first ``cols`` eval points):
    bitwise, or k equal but in at most ENGINE_MAX_FORKS replicas of an
    adaptive cell, time and loss within the engine's tolerances.  Prints
    each cell's largest gaps."""
    import numpy as np

    rows, gaps, bitwise = [], (0.0, 0.0), 0
    for label, g in got.items():
        gt, gl, gk = (a[:, :cols] for a in g)
        wt, wl, wk = (a[:, :cols] for a in want[label])
        same = np.array_equal(gt, wt) and np.array_equal(gl, wl) and np.array_equal(gk, wk)
        forked = np.nonzero((gk != wk).any(axis=1))[0]
        keep = np.setdiff1d(np.arange(gk.shape[0]), forked)
        t_gap = float(np.max(np.abs(gt[keep] - wt[keep]) / np.abs(wt[keep]), initial=0.0))
        l_gap = float(np.max(np.abs(gl[keep] - wl[keep]) / np.abs(wl[keep]), initial=0.0))
        gaps = (max(gaps[0], t_gap), max(gaps[1], l_gap))
        bitwise += same
        rows.append(f"{label} {len(forked)} forked, {t_gap:.2e}/{l_gap:.2e}")
        if len(forked) > (ENGINE_MAX_FORKS if label in adaptive else 0):
            raise AssertionError(f"{what}: {label}: {len(forked)} replicas forked in k: {forked.tolist()}")
        if not (t_gap <= ENGINE_TIME_RTOL and l_gap <= ENGINE_LOSS_RTOL):
            raise AssertionError(f"{what}: {label}: time gap {t_gap:.3e} or loss gap {l_gap:.3e} beyond "
                                 f"{ENGINE_TIME_RTOL} / {ENGINE_LOSS_RTOL}")
        if not (np.isfinite(gt).all() and np.isfinite(gl).all()):
            raise AssertionError(f"{what}: {label}: time or loss not finite")
    print(f"  {what}: {bitwise}/{len(got)} cells bitwise equal; max rel gap time {gaps[0]:.3e}, "
          f"loss {gaps[1]:.3e}; each cell's forks, time/loss gap: " + "; ".join(rows))


def engine_sweep(p7: dict) -> dict:
    """Phase 8: fig2's and the ablation's grids at full width, each as one
    program on the card: graph-replayed against eager (bitwise), against
    the looped engine on the card and against the grid on the CPU; a
    repopulated grid captures nothing new; fig2's grid timed both ways,
    with its launches, device time and peak memory."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from repro_torch.core import controller
    from repro_torch.core.sweep import sweep_cache_stats
    from repro_torch.launch import quickstart

    phase_t0 = time.perf_counter()
    eta = p7["eta"]
    data, keys = quickstart.inputs("fig2", device="cuda")
    fig2 = quickstart.cases("fig2", data, eta)
    ablation = quickstart.cases("ablation", data, eta)
    adaptive = {c.label for c in fig2 + ablation if isinstance(
        c.controller, (controller.PflugController, controller.SketchedPflugController,
                       controller.VarianceRatioController))}
    abl_keys = quickstart.inputs("ablation", device="cuda")[1]
    cfg = quickstart.SETUPS["fig2"]
    block = cfg["eval_every"]
    print(f"[8] sweep: fig2's grid ({len(fig2)} cells x R={cfg['replicas']} = {len(fig2) * cfg['replicas']} lanes, "
          f"{ENGINE_ITERS} iterations) and the ablation's ({len(ablation)} cells x R="
          f"{quickstart.SETUPS['ablation']['replicas']} = {len(ablation) * quickstart.SETUPS['ablation']['replicas']} "
          f"lanes, {ABLATION_ITERS} iterations), each one program")

    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 1e6
    torch.cuda.reset_peak_memory_stats()
    before = sweep_cache_stats()["traces"]
    t0 = time.perf_counter()
    fig2_graph = cells_of(quickstart.run_grid("fig2", fig2, data, keys, ENGINE_ITERS))
    first_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 1e6 - base_mb
    abl_graph = cells_of(quickstart.run_grid("ablation", ablation, data, abl_keys, ABLATION_ITERS))
    captures = sweep_cache_stats()["traces"] - before
    # the fig2 grid repopulated: other eta and k, the same signature and shapes
    other = [dataclasses.replace(c, eta=eta * 0.8, controller=dataclasses.replace(
        c.controller, **({"k": c.controller.k - 5} if hasattr(c.controller, "k") else {"k0": 5})))
        for c in fig2]
    before = sweep_cache_stats()["traces"]
    t0 = time.perf_counter()
    repop = cells_of(quickstart.run_grid("fig2", other, data, keys, ENGINE_ITERS))
    repop_s = time.perf_counter() - t0
    new_captures = sweep_cache_stats()["traces"] - before
    print(f"  first fig2 grid run {first_s:.2f} s (capture included), {captures} captures for both grids; "
          f"repopulated with other eta and k: {repop_s:.2f} s, {new_captures} new captures; peak memory of the "
          f"fig2 grid's program {peak_mb:.2f} MB (above the {base_mb:.2f} MB held before it)")
    if captures != 2 or new_captures != 0:
        raise AssertionError(f"expected 2 captures and none on repopulation, got {captures} and {new_captures}")
    if all(np.array_equal(repop[c.label][1], fig2_graph[c.label][1]) for c in fig2):
        raise AssertionError("the repopulated grid returned the first grid's losses")

    # steady state of the fig2 grid: ms an iteration both ways, launches, device time
    lanes = len(fig2) * cfg["replicas"]

    def grid(iters, capture=True):  # one eval point at the end when iters <= 500
        return quickstart.run_grid("fig2", fig2, data, keys, iters, capture)

    graph_ms = cuda_ms(lambda: grid(ENGINE_ITERS), iters=2, warmup=0) / ENGINE_ITERS
    eager_ms = cuda_ms(lambda: grid(100, capture=False), iters=2, warmup=1) / 100
    launches = (count_kernels(lambda: grid(3, False)) - count_kernels(lambda: grid(1, False))) / 2
    looped_ms = p7["graph_ms"]
    print(f"  fig2 grid, {lanes} lanes: graph-replayed {graph_ms:.4f} ms an iteration, eager {eager_ms:.4f} ms; "
          f"{launches:.1f} kernel launches an iteration (eager, torch.profiler); phase 7's looped adaptive cell "
          f"{looped_ms:.4f} ms an iteration for 32 lanes, x{len(fig2)} cells = {looped_ms * len(fig2):.4f} ms")
    fig2_block = cells_of(grid(block))  # one eval block, held to the eager run below
    grid(PROFILE_ITERS)  # captures this program's graphs before they are timed
    prof_ms = cuda_ms(lambda: grid(PROFILE_ITERS), iters=3, warmup=1)
    device_breakdown(lambda: grid(PROFILE_ITERS), f"fig2 grid, {PROFILE_ITERS} iterations graph-replayed", prof_ms,
                     top=8)
    device_breakdown(lambda: grid(1, False), "fig2 grid, one iteration and one eval eager",
                     cuda_ms(lambda: grid(1, False), iters=2, warmup=1), top=8)

    # the controls, each in a worker process: eager on the card, looped on the card, the grid on the CPU
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=5, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {
            "fig2 eager": pool.submit(grid_run, "fig2", fig2, "cuda", block, False),
            "fig2 CPU": pool.submit(grid_run, "fig2", fig2, "cpu", ENGINE_CPU_ITERS, True),
            "ablation eager": pool.submit(grid_run, "ablation", ablation, "cuda", ABLATION_ITERS, False),
            "ablation looped": pool.submit(grid_run, "ablation", ablation, "cuda", ABLATION_ITERS, True, True),
            "ablation CPU": pool.submit(grid_run, "ablation", ablation, "cpu", ABLATION_ITERS, True),
        }
        runs = {name: f.result() for name, f in jobs.items()}
    print(f"  controls in worker processes: {time.perf_counter() - t0:.1f} s for all; "
          + ", ".join(f"{name} {s:.1f} s" for name, (_, s) in runs.items()))
    for name, got in (("fig2", fig2_block), ("ablation", abl_graph)):
        eager = runs[f"{name} eager"][0]
        diff = [lb for lb in got if not all(np.array_equal(a, b) for a, b in zip(got[lb], eager[lb]))]
        print(f"  {name} grid: graph-replayed vs eager bitwise equal in {len(got) - len(diff)}/{len(got)} cells")
        if diff:
            raise AssertionError(f"{name} grid: graph-replayed and eager runs differ in {diff}")
    hold("fig2 grid vs looped on the card (phase 7)", fig2_graph, p7["results"], adaptive)
    hold("ablation grid vs looped on the card", abl_graph, runs["ablation looped"][0], adaptive)
    hold(f"fig2 grid vs the CPU at iteration {ENGINE_CPU_ITERS}", fig2_graph, runs["fig2 CPU"][0], adaptive,
         cols=ENGINE_CPU_ITERS // cfg["eval_every"])
    hold(f"ablation grid vs the CPU at iteration {ABLATION_ITERS}", abl_graph, runs["ablation CPU"][0], adaptive)
    for name, got in (("fig2", fig2_graph), ("ablation", abl_graph)):
        finals = ", ".join(f"{lb} k {got[lb][2][:, -1].mean():.1f}" for lb in list(got)[:5])
        print(f"  {name} grid at its last eval point: {finals}")
    print(f"  phase 8 took {time.perf_counter() - phase_t0:.1f} s")
    return {"graph_ms": graph_ms, "eager_ms": eager_ms, "launches": launches, "peak_mb": peak_mb}


# The async phase: fig_async's grid at its published size
# (benchmarks/fig_async.py:54-62,74-96), 160 lanes, cut to 200 of its 6000
# iterations graph-replayed, 10 eager (an eager iteration of a grid holding
# a kbatch cell launches ~1.7 x 10^4 kernels) and 100 on the CPU.  Against eager,
# bitwise; against the looped arms on the card, time and k bitwise and the
# loss within ENGINE_LOSS_RTOL (the sync arm's loss differs by 2.2e-6 at 300
# iterations: the card's products and reductions round differently for 160
# lanes than for 32); against the CPU, the engine's tolerances, with forks
# allowed in the Pflug arms only.
ASYNC_ITERS, ASYNC_EAGER_ITERS, ASYNC_CPU_ITERS = 200, 10, 100
# The K = 1 cell: fig_async's data, a Deterministic(1) fleet, eta 0.05/L
# (fully async K = 1 diverges at 0.5/L), 200 updates; the rate twin of
# benchmarks/sweep_bench.py:120 (async_engine_vs_host): K = 1 on exp(1),
# R = 32, 500 updates each (the bench's 2000 cut: the host loop takes ~7 ms
# an update), against the host loop over the same horizon.
ASYNC_DET_ITERS, ASYNC_RATE_ITERS = 200, 500


def host_loop(data, eta: float, straggler, key, total_time: float, eval_every: int):
    """The port's event-driven async SGD (`async_sim`) on fig_async's data,
    each worker's gradient the mean loss over its shard; on the card."""
    import torch
    from repro_torch.core.async_sim import simulate_async_sgd
    from repro_torch.launch import quickstart

    n = quickstart.SETUPS["async"]["n"]
    X, y = data.X, data.y
    s = X.shape[0] // n

    def grad_fn(w, i):
        return torch.func.grad(lambda p: quickstart.squared_error(p, X[i * s:(i + 1) * s], y[i * s:(i + 1) * s])
                               .mean())(w)

    return simulate_async_sgd(grad_fn, lambda w: quickstart.squared_error(w, X, y).mean(),
                              torch.zeros(X.shape[1], device=X.device), n_workers=n, eta=eta, straggler=straggler,
                              total_time=total_time, key=key, eval_every=eval_every, device=X.device)


def engine_async() -> dict:
    """Phase 9: fig_async's mixed-mode grid at its published size as one
    program on the card, against eager, the looped arms and the CPU; a
    repopulated grid captures nothing new; its time, capture and memory, and
    each mode's looped time and launches; then the K = 1 Deterministic cell
    against eager and the host loop, and the K = 1 engine's update rate
    beside the host loop's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from repro_torch.core import controller
    from repro_torch.core.montecarlo import run_monte_carlo
    from repro_torch.core.straggler import Deterministic, Exponential
    from repro_torch.core.sweep import sweep_cache_stats
    from repro_torch.launch import quickstart

    phase_t0 = time.perf_counter()
    cfg = quickstart.SETUPS["async"]
    data, keys = quickstart.inputs("async", device="cuda")
    eta = quickstart.step_size(data.X)
    arms = quickstart.cases("async", data, eta)
    lanes = len(arms) * cfg["replicas"]
    adaptive = {c.label for c in arms if isinstance(c.controller, controller.PflugController)}
    print(f"[9] async modes: fig_async's grid ({len(arms)} arms x R={cfg['replicas']} = {lanes} lanes: "
          + ", ".join(f"{c.label} ({c.mode})" for c in arms)
          + f"), n={cfg['n']} ({cfg['n_fast']} exp(1), {cfg['n_slow']} exp({1 / cfg['slow_factor']})), m={cfg['m']}, "
          f"d={cfg['d']}, eta {eta!r}; {ASYNC_ITERS} of its {cfg['iters']} iterations graph-replayed, "
          f"{ASYNC_EAGER_ITERS} eager, {ASYNC_CPU_ITERS} on the CPU")

    def grid(iters, capture=True, cases=arms):
        return quickstart.run_grid("async", cases, data, keys, iters, capture)

    steps, step_t0 = {}, [time.perf_counter()]

    def took(name):  # the seconds of each step, printed at the end
        now = time.perf_counter()
        steps[name], step_t0[0] = now - step_t0[0], now

    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        cpu_f = pool.submit(grid_run, "async", arms, "cpu", ASYNC_CPU_ITERS, True, False, 4)

        # the grid, graph-replayed: its first run captures
        torch.cuda.synchronize()
        base_alloc, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        before = sweep_cache_stats()["traces"]
        t0 = time.perf_counter()
        graph = cells_of(grid(ASYNC_ITERS))
        first_s = time.perf_counter() - t0
        peak_mb = (torch.cuda.max_memory_allocated() - base_alloc) / 1e6
        pool_mb = (torch.cuda.memory_reserved() - base_reserved) / 1e6
        captures = sweep_cache_stats()["traces"] - before

        # repopulated: other eta, k and k0, the same signature and shapes; this
        # replay of the captured graphs is the grid's timed run
        other = [dataclasses.replace(c, eta=eta * 0.8, controller=dataclasses.replace(
            c.controller, **({"k": c.controller.k - 1} if hasattr(c.controller, "k") else {"k0": 2})))
            for c in arms]
        before = sweep_cache_stats()["traces"]
        repop = {}
        t0 = time.perf_counter()
        graph_ms = cuda_ms(lambda: repop.update(cells_of(grid(ASYNC_ITERS, cases=other))), iters=1,
                           warmup=0) / ASYNC_ITERS
        replay_s = time.perf_counter() - t0
        new_captures = sweep_cache_stats()["traces"] - before
        print(f"  grid, graph-replayed: {graph_ms:.4f} ms an iteration ({lanes} lanes); first run {first_s:.2f} s, a "
              f"replayed run (repopulated with other eta and k) {replay_s:.2f} s: {first_s - replay_s:.2f} s to build "
              f"and capture ({captures} capture, {new_captures} on repopulation); peak memory {peak_mb:.2f} MB above "
              f"the {base_alloc / 1e6:.2f} MB held before it, reserved memory (the graph pool) grew {pool_mb:.2f} MB")
        if captures != 1:
            raise AssertionError(f"expected one capture for the grid, got {captures}")
        if new_captures != 0:
            raise AssertionError(f"the repopulated grid captured {new_captures} times")
        if all(np.array_equal(repop[c.label][1], graph[c.label][1]) for c in arms):
            raise AssertionError("the repopulated grid returned the first grid's losses")
        took("grid")

        # each arm looped on the card; a looped cell of each mode timed
        looped, looped_ms = {}, {}
        for arm in arms:
            res = quickstart.run_case("async", arm, data, keys, ASYNC_ITERS)
            looped[arm.label] = tuple(getattr(res, f).cpu().numpy() for f in ("time", "loss", "k"))
        for label in ("sync_k16", "kasync_k4", "kbatch_k4"):
            arm = next(c for c in arms if c.label == label)
            looped_ms[arm.mode] = cuda_ms(lambda: quickstart.run_case("async", arm, data, keys, ASYNC_ITERS),
                                          iters=1, warmup=0) / ASYNC_ITERS
        rows = []
        for label, (gt, gl, gk) in graph.items():
            lt, ll, lk = looped[label]
            l_gap = float(np.max(np.abs(gl - ll) / np.abs(ll)))
            rows.append(f"{label} time {np.array_equal(gt, lt)}, k {np.array_equal(gk, lk)}, loss {l_gap:.3e}")
            if not (np.array_equal(gt, lt) and np.array_equal(gk, lk) and l_gap <= ENGINE_LOSS_RTOL):
                raise AssertionError(f"{label}: the grid and the looped arm differ beyond time and k bitwise, loss "
                                     f"{ENGINE_LOSS_RTOL}: {rows[-1]}")
            if not (np.isfinite(gt).all() and np.isfinite(gl).all()):
                raise AssertionError(f"{label}: time or loss not finite")
        print("  grid vs each arm looped on the card, equal: " + "; ".join(rows) + f" (loss rtol {ENGINE_LOSS_RTOL})")
        print(f"  a looped arm (R={cfg['replicas']}), graph-replayed: " + ", ".join(
            f"{mode} {ms:.4f} ms an iteration" for mode, ms in looped_ms.items()))
        took("looped")

        # kernels an iteration for the grid and a looped cell of each mode, counted by torch.profiler
        # in graph-replayed runs of 2 and 1 iterations (an eager run's host-side events cost the
        # profiler several times more); each graph also copies the carry back into its buffers
        def graph_launches(run):
            run(1), run(2)  # capture both programs before they are counted
            return count_kernels(lambda: run(2)) - count_kernels(lambda: run(1))

        launches = {"grid": graph_launches(grid)}
        for label in ("sync_k16", "kasync_k4", "kbatch_k4"):
            arm = next(c for c in arms if c.label == label)
            launches[arm.mode] = graph_launches(
                lambda iters, arm=arm: quickstart.run_case("async", arm, data, keys, iters))
        print("  kernels an iteration (graph-replayed, torch.profiler): " + ", ".join(
            f"{k} {v}" for k, v in launches.items()))
        prof_ms = cuda_ms(lambda: grid(1), iters=2, warmup=0)
        device_breakdown(lambda: grid(1), "grid, 1 iteration and the eval graph-replayed", prof_ms, top=8)
        took("launches and profile")

        # graph-replayed against eager, bitwise
        t0 = time.perf_counter()
        eager = cells_of(grid(ASYNC_EAGER_ITERS, capture=False))
        eager_s = time.perf_counter() - t0
        short = cells_of(grid(ASYNC_EAGER_ITERS))
        diff = [lb for lb in short if not all(np.array_equal(a, b) for a, b in zip(short[lb], eager[lb]))]
        print(f"  grid, eager: {eager_s / ASYNC_EAGER_ITERS * 1e3:.1f} ms an iteration (host clock); graph-replayed "
              f"vs eager at iteration {ASYNC_EAGER_ITERS} bitwise equal in {len(short) - len(diff)}/{len(short)} arms")
        if diff:
            raise AssertionError(f"async grid: graph-replayed and eager runs differ in {diff}")
        took("eager")

        # the K = 1 cell on a Deterministic fleet: every clock tied
        eta_det = eta / 10  # 0.05 / L
        det = dict(n_workers=cfg["n"], controller=controller.FixedKController(n_workers=cfg["n"], k=1),
                   straggler=Deterministic(1.0), eta=eta_det, num_iters=ASYNC_DET_ITERS, keys=keys[:1],
                   eval_every=10, mode="kasync", device="cuda")
        w0 = torch.zeros(cfg["d"], device="cuda")
        det_g = run_monte_carlo(quickstart.squared_error, w0, data.X, data.y, **det)
        det_e = run_monte_carlo(quickstart.squared_error, w0, data.X, data.y, capture=False, **det)
        same = all(torch.equal(getattr(det_g, f), getattr(det_e, f)) for f in ("time", "loss", "k"))
        h = host_loop(data, eta_det, Deterministic(1.0), keys[0], float(det_g.time[0, -1]), 10)
        ne = min(len(h["time"]), det_g.time.shape[1])
        t_same = np.array_equal(det_g.time[0, :ne].cpu().numpy(), np.asarray(h["time"][:ne], np.float32))
        u_same = list(det_g.iteration[:ne]) == list(h["updates"][:ne]) and bool((det_g.k == 1).all())
        l_gap = float(np.max(np.abs(det_g.loss[0, :ne].cpu().numpy() - np.asarray(h["loss"][:ne]))
                             / np.abs(np.asarray(h["loss"][:ne]))))
        print(f"  K = 1, Deterministic fleet, {ASYNC_DET_ITERS} updates: graph vs eager bitwise {same}; vs the host "
              f"loop over {ne} eval points: update times equal {t_same}, update counts and k equal {u_same}, loss max "
              f"rel gap {l_gap:.3e}")
        if not (same and t_same and u_same and ne >= ASYNC_DET_ITERS // 10 - 1 and l_gap <= ENGINE_LOSS_RTOL):
            raise AssertionError("the K = 1 Deterministic cell disagrees with eager or the host loop")
        took("K = 1 ties")

        # the K = 1 engine's update rate beside the host loop's (sweep_bench.async_engine_vs_host)
        rate = dict(n_workers=cfg["n"], controller=controller.FixedKController(n_workers=cfg["n"], k=1),
                    straggler=Exponential(1.0), eta=eta_det, num_iters=ASYNC_RATE_ITERS, keys=keys,
                    eval_every=ASYNC_RATE_ITERS // 8, mode="kasync", device="cuda")
        res = run_monte_carlo(quickstart.squared_error, w0, data.X, data.y, **rate)  # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_monte_carlo(quickstart.squared_error, w0, data.X, data.y, **rate)
        float(res.loss[0, -1])
        engine_s = time.perf_counter() - t0
        horizon = float(res.time[:, -1].mean())
        host_loop(data, eta_det, Exponential(1.0), prng_key(3), horizon / 10, ASYNC_RATE_ITERS // 8)  # warm-up
        t0 = time.perf_counter()
        h = host_loop(data, eta_det, Exponential(1.0), prng_key(2), horizon, ASYNC_RATE_ITERS // 8)
        host_s = time.perf_counter() - t0
        host_updates = int(h["updates"][-1])
        engine_rate = ASYNC_RATE_ITERS * cfg["replicas"] / engine_s
        host_rate = host_updates / host_s
        print(f"  K = 1 on exp(1): the engine {ASYNC_RATE_ITERS} updates x R={cfg['replicas']} in {engine_s:.3f} s "
              f"({engine_rate:.0f} updates/s), the host loop {host_updates} updates in {host_s:.3f} s "
              f"({host_rate:.1f} updates/s): {engine_rate / host_rate:.0f}x per update")
        took("K = 1 rate")
        cpu, cpu_s = cpu_f.result()
        took("waiting for the CPU")

    print(f"  the grid on the CPU, {ASYNC_CPU_ITERS} iterations in a worker process: {cpu_s:.1f} s")
    hold(f"async grid vs the CPU at iteration {ASYNC_CPU_ITERS}", graph, cpu, adaptive,
         cols=ASYNC_CPU_ITERS // cfg["eval_every"])
    finals = ", ".join(f"{lb} sim_time {g[0][:, -1].mean():.1f}, k {g[2][:, -1].mean():.1f}" for lb, g in graph.items())
    print(f"  the grid at iteration {ASYNC_ITERS}: {finals}")
    print(f"  phase 9 took {time.perf_counter() - phase_t0:.1f} s: " + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in steps.items()))
    return {"graph_ms": graph_ms, "looped_ms": looped_ms, "launches": launches, "peak_mb": peak_mb,
            "capture_s": first_s - replay_s, "engine_rate": engine_rate, "host_rate": host_rate}


# The fault phase.  The reference test's forced grid
# (tests/test_faults.py:81-129): seven cells over every fault family, every
# robust aggregator and the three modes, n = 8, m = 160, d = 4, R = 3, 100
# iterations, eta 0.05/L; graph-replayed against eager (bitwise) and each
# cell against the looped engine on the card (time and k bitwise, the loss
# within FORCED_LOSS_RTOL, else within ENGINE_LOSS_RTOL, and the run says
# which).  Then fig_byzantine's grid at its published size
# (benchmarks/fig_byzantine.py:62-73,86-112; `quickstart --setup
# byzantine`): 18 cells x R = 32 = 576 lanes, BYZ_ITERS iterations
# graph-replayed against eager (BYZ_EAGER_ITERS, bitwise), each cell looped
# on the card (BYZ_ITERS) and the grid on the CPU (BYZ_CPU_ITERS, in a
# worker process).  The weighted mean at 30% sign flips diverges by design:
# a cell's loss (and an adaptive cell's k and clock) is held only while the
# loss is finite and below the loss the run started from (the loss at
# w = 0: a cell above it has diverged; the figure's 1e4 bar on the final
# excess would hold few points of a 100-iteration run, where converging
# cells are still above it); a fixed cell's time and k always.  Then the
# whole figure, 6000 iterations, graph-replayed.
FORCED = dict(n=8, m=160, d=4, replicas=3, iters=100, eval_every=25)
FORCED_LOSS_RTOL = 1e-6
BYZ_ITERS, BYZ_EAGER_ITERS, BYZ_CPU_ITERS = 200, 10, 100


def forced_cases(eta: float, frac: float = 0.25):
    from repro_torch.core.controller import FixedKController
    from repro_torch.core.faults import byzantine_plan
    from repro_torch.core.straggler import Exponential
    from repro_torch.core.sweep import SweepCase

    n = FORCED["n"]
    exp, c = Exponential(rate=1.0), FixedKController(n_workers=n, k=3)
    return [
        SweepCase(c, exp, eta, label="clean"),
        SweepCase(c, exp, eta, label="flip", fault=byzantine_plan(n, frac, "sign_flip")),
        SweepCase(c, exp, eta, label="gauss_gm", fault=byzantine_plan(n, frac, "random_gauss", param=2.0),
                  agg="geomedian"),
        SweepCase(c, exp, eta, label="rescale_trim_ka", fault=byzantine_plan(n, frac, "rescale", param=-4.0),
                  agg="trimmed", agg_param=0.25, mode="kasync"),
        SweepCase(c, exp, eta, label="crash_ka", fault=byzantine_plan(n, 2 * frac, "crash", onset=2.0), mode="kasync"),
        SweepCase(c, exp, eta, label="crash_kb", fault=byzantine_plan(n, 2 * frac, "crash", onset=2.0), mode="kbatch"),
        SweepCase(c, exp, eta, label="flip_median", fault=byzantine_plan(n, frac, "sign_flip"), agg="median"),
    ]


def hold_byzantine(what: str, got: dict, want: dict, adaptive: set, bar: float, cols: int | None = None,
                   time_rtol: float = 0.0, loss_rtol: float = 0.0) -> str:
    """Hold fig_byzantine's cells of ``got`` to ``want`` (the first ``cols``
    eval points): a fixed cell's time within ``time_rtol`` (0: bitwise) and
    its k equal over the whole run, its loss within ``loss_rtol`` where
    ``want``'s loss is finite and below ``bar``; an adaptive cell's k,
    time and loss there too (its k reads the gradient, and its clock reads
    k), with up to ENGINE_MAX_FORKS replicas forked in k when
    ``time_rtol``.  Returns a summary line."""
    import numpy as np

    gaps, forks, cut, cell_gaps = [0.0, 0.0], 0, 0, []
    for label, g in got.items():
        gt, gl, gk = (a[:, :cols] for a in g)
        wt, wl, wk = (a[:, :cols] for a in want[label])
        held = np.isfinite(wl) & (wl < bar)
        cut += int((~held).sum())
        timed = np.ones_like(held)
        if label in adaptive:
            forked = np.nonzero(((gk != wk) & held).any(axis=1))[0]
            if len(forked) > (ENGINE_MAX_FORKS if time_rtol else 0):
                raise AssertionError(f"{what}: {label}: {len(forked)} replicas forked in k: {forked.tolist()}")
            forks += len(forked)
            held[forked] = False
            timed = held
        elif not np.array_equal(gk, wk):
            raise AssertionError(f"{what}: {label}: k differs")
        t_gap = float(np.max(np.abs(gt[timed] - wt[timed]) / np.abs(wt[timed]), initial=0.0))
        l_gap = float(np.max(np.abs(gl[held] - wl[held]) / np.abs(wl[held]), initial=0.0))
        gaps = [max(gaps[0], t_gap), max(gaps[1], l_gap)]
        cell_gaps.append(f"{label} {l_gap:.2e}")
        if not (t_gap <= time_rtol and l_gap <= loss_rtol):
            raise AssertionError(f"{what}: {label}: time gap {t_gap:.3e} or loss gap {l_gap:.3e} beyond "
                                 f"{time_rtol} / {loss_rtol}")
        if not np.isfinite(gt).all():
            raise AssertionError(f"{what}: {label}: time not finite")
    line = (f"{what}: time max rel gap {gaps[0]:.3e} (rtol {time_rtol}), loss {gaps[1]:.3e} (rtol {loss_rtol}), "
            f"{forks} adaptive replicas forked; {cut} of {sum(g[1][:, :cols].size for g in got.values())} eval points "
            f"past the divergence bar not held")
    print("  " + line + "; each cell's loss gap: " + "; ".join(cell_gaps))
    return line


def byzantine_run(device: str, iters: int, threads: int):
    """fig_byzantine's grid on ``device`` in a worker process: {label:
    (time, loss, k) numpy} and the wall seconds."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import quickstart

    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    data, keys = quickstart.inputs("byzantine", device=device)
    eta = quickstart.step_size(data.X, quickstart.SETUPS["byzantine"]["edge_fraction"])
    t0 = time.perf_counter()
    out = quickstart.run_grid("byzantine", quickstart.cases("byzantine", eta=eta), data, keys, iters)
    return cells_of(out), time.perf_counter() - t0


def engine_faults() -> dict:
    """Phase 10: the forced fault grid and fig_byzantine's grid at its
    published size, each one program on the card: against eager, the looped
    engine and (fig_byzantine) the CPU; repopulation without a capture; the
    grid's ms an iteration, launches, capture, memory and device time; the
    whole figure's wall time, its headline flags and times to target."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from repro_torch.core import controller, prng
    from repro_torch.core.montecarlo import run_monte_carlo
    from repro_torch.core.sweep import run_sweep, sweep_cache_stats
    from repro_torch.data import make_linreg_data
    from repro_torch.launch import quickstart

    phase_t0 = time.perf_counter()
    steps, step_t0 = {}, [time.perf_counter()]

    def took(name):  # the seconds of each step, printed at the end
        now = time.perf_counter()
        steps[name], step_t0[0] = now - step_t0[0], now

    cfg = quickstart.SETUPS["byzantine"]
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        cpu_f = pool.submit(byzantine_run, "cpu", BYZ_CPU_ITERS, 6)

        # the forced grid: every family and robust aggregator over the three modes
        f = FORCED
        fdata = make_linreg_data(prng.PRNGKey(0), m=f["m"], d=f["d"], device="cuda")
        lam = float(torch.linalg.eigvalsh(fdata.X.T @ fdata.X / f["m"]).max())
        feta = 0.05 / (2 * lam)
        fkeys = prng.split(prng.PRNGKey(5, device="cuda"), f["replicas"])
        fcases = forced_cases(feta)
        w0 = torch.zeros(f["d"], device="cuda")

        def forced(cases, capture=True):
            return run_sweep(quickstart.squared_error, w0, fdata.X, fdata.y, n_workers=f["n"], cases=cases,
                             num_iters=f["iters"], eval_every=f["eval_every"], keys=fkeys, device="cuda",
                             capture=capture)

        print(f"[10] faults: the forced grid ({len(fcases)} cells: " + ", ".join(c.label for c in fcases)
              + f"; n={f['n']}, m={f['m']}, d={f['d']}, R={f['replicas']}, {f['iters']} iterations)")
        before = sweep_cache_stats()["traces"]
        fgraph = cells_of(forced(fcases))
        fcaptures = sweep_cache_stats()["traces"] - before
        feager = cells_of(forced(fcases, capture=False))
        diff = [lb for lb in fgraph if not all(np.array_equal(a, b, equal_nan=True)
                                               for a, b in zip(fgraph[lb], feager[lb]))]
        print(f"  forced grid: graph-replayed vs eager bitwise equal in {len(fgraph) - len(diff)}/{len(fgraph)} cells")
        if diff:
            raise AssertionError(f"forced grid: graph-replayed and eager runs differ in {diff}")
        rows, worst = [], 0.0
        for c in fcases:
            res = run_monte_carlo(quickstart.squared_error, w0, fdata.X, fdata.y, n_workers=f["n"],
                                  controller=c.controller, straggler=c.straggler, eta=c.eta, num_iters=f["iters"],
                                  eval_every=f["eval_every"], keys=fkeys, mode=c.mode, fault=c.fault, agg=c.agg,
                                  agg_param=c.agg_param, device="cuda")
            lt, ll, lk = (getattr(res, n).cpu().numpy() for n in ("time", "loss", "k"))
            gt, gl, gk = fgraph[c.label]
            l_gap = float(np.max(np.abs(gl - ll) / np.abs(ll)))
            worst = max(worst, l_gap)
            rows.append(f"{c.label} loss {l_gap:.2e}")
            if not (np.array_equal(gt, lt) and np.array_equal(gk, lk) and l_gap <= ENGINE_LOSS_RTOL):
                raise AssertionError(f"forced grid, {c.label}: the grid and the looped cell differ beyond time and "
                                     f"k bitwise, loss {ENGINE_LOSS_RTOL} ({l_gap:.3e})")
            if not (np.isfinite(gl).all() and np.isfinite(gt).all()):
                raise AssertionError(f"forced grid, {c.label}: time or loss not finite")
        took_tol = FORCED_LOSS_RTOL if worst <= FORCED_LOSS_RTOL else ENGINE_LOSS_RTOL
        print(f"  forced grid vs each cell looped on the card: time and k bitwise in every cell, loss within "
              f"{took_tol} (max rel gap {worst:.3e}): " + "; ".join(rows))
        before = sweep_cache_stats()["traces"]
        frepop = cells_of(forced(forced_cases(feta * 0.8, frac=0.375)))
        frepop_captures = sweep_cache_stats()["traces"] - before
        print(f"  forced grid: {fcaptures} capture; repopulated with other fractions and eta: {frepop_captures}")
        if (fcaptures, frepop_captures) != (1, 0) or all(np.array_equal(frepop[lb][1], fgraph[lb][1]) for lb in fgraph):
            raise AssertionError(f"forced grid: expected one capture and none on repopulation, got {fcaptures} and "
                                 f"{frepop_captures}, or the repopulated grid returned the first grid's losses")
        took("forced grid")

        # fig_byzantine's grid at its published size
        data, keys = quickstart.inputs("byzantine", device="cuda")
        eta = quickstart.step_size(data.X, cfg["edge_fraction"])
        grid_cases = quickstart.cases("byzantine", eta=eta)
        lanes = len(grid_cases) * cfg["replicas"]
        adaptive = {c.label for c in grid_cases if isinstance(c.controller, controller.PflugController)}
        bar = float(quickstart.squared_error(torch.zeros(cfg["d"], device="cuda"), data.X, data.y).mean())
        print(f"[10] fig_byzantine's grid ({len(grid_cases)} cells x R={cfg['replicas']} = {lanes} lanes), "
              f"n={cfg['n']}, m={cfg['m']}, d={cfg['d']}, eta {eta!r} (0.75 x 2/L); {BYZ_ITERS} iterations "
              f"graph-replayed, {BYZ_EAGER_ITERS} eager, {BYZ_CPU_ITERS} on the CPU")

        def grid(iters, capture=True, cases=grid_cases):
            return quickstart.run_grid("byzantine", cases, data, keys, iters, capture)

        torch.cuda.synchronize()
        base_alloc, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        before = sweep_cache_stats()["traces"]
        t0 = time.perf_counter()
        graph = cells_of(grid(BYZ_ITERS))
        first_s = time.perf_counter() - t0
        peak_mb = (torch.cuda.max_memory_allocated() - base_alloc) / 1e6
        pool_mb = (torch.cuda.memory_reserved() - base_reserved) / 1e6
        captures = sweep_cache_stats()["traces"] - before

        # repopulated: other sign-flip fractions and onsets, eta and k (the
        # same signature and shapes); this replay is the grid's timed run
        def other_plan(c):
            if c.fault is None:
                return None
            n_bad = sum(m is not None for m in c.fault.models) + 1
            return dataclasses.replace(c.fault, models=(None,) * (cfg["n"] - n_bad) + (
                dataclasses.replace(c.fault.models[-1], onset=5.0),) * n_bad)

        other = [dataclasses.replace(c, eta=eta * 0.8, fault=other_plan(c), controller=dataclasses.replace(
            c.controller, **({"k": c.controller.k + 1} if hasattr(c.controller, "k") else {"k0": 2})))
            for c in grid_cases]
        before = sweep_cache_stats()["traces"]
        repop = {}
        t0 = time.perf_counter()
        graph_ms = cuda_ms(lambda: repop.update(cells_of(grid(BYZ_ITERS, cases=other))), iters=1,
                           warmup=0) / BYZ_ITERS
        replay_s = time.perf_counter() - t0
        new_captures = sweep_cache_stats()["traces"] - before
        print(f"  grid, graph-replayed: {graph_ms:.4f} ms an iteration ({lanes} lanes); first run {first_s:.2f} s, a "
              f"replayed run (repopulated with other fractions, onsets, eta and k) {replay_s:.2f} s: "
              f"{first_s - replay_s:.2f} s to build and capture ({captures} capture, {new_captures} on repopulation); "
              f"peak memory {peak_mb:.2f} MB above the {base_alloc / 1e6:.2f} MB held before it, reserved memory "
              f"(the graph pool) grew {pool_mb:.2f} MB")
        if captures != 1 or new_captures != 0:
            raise AssertionError(f"expected one capture for the grid and none on repopulation, got {captures} and "
                                 f"{new_captures}")
        if all(np.array_equal(repop[c.label][1], graph[c.label][1]) for c in grid_cases):
            raise AssertionError("the repopulated grid returned the first grid's losses")

        # a random_gauss plan is another fault family, so another signature:
        # one capture for its grid, none for its repopulation with other scales
        def gauss_cases(scale):
            return [dataclasses.replace(c, fault=None if c.fault is None else dataclasses.replace(
                c.fault, models=tuple(None if m is None else dataclasses.replace(
                    m, family="random_gauss", param=scale) for m in c.fault.models))) for c in grid_cases]

        before = sweep_cache_stats()["traces"]
        g1 = cells_of(grid(BYZ_EAGER_ITERS, cases=gauss_cases(1.0)))
        mid = sweep_cache_stats()["traces"]
        g2 = cells_of(grid(BYZ_EAGER_ITERS, cases=gauss_cases(4.0)))
        gauss_captures = (mid - before, sweep_cache_stats()["traces"] - mid)
        print(f"  the grid with random_gauss in place of sign_flip: {gauss_captures[0]} capture; repopulated with "
              f"another noise scale: {gauss_captures[1]} captures")
        if gauss_captures != (1, 0) or all(np.array_equal(g1[lb][1], g2[lb][1]) for lb in g1):
            raise AssertionError(f"gauss grid: expected (1, 0) captures and other losses, got {gauss_captures}")
        took("grid")

        # graph-replayed against eager, bitwise
        t0 = time.perf_counter()
        eager = cells_of(grid(BYZ_EAGER_ITERS, capture=False))
        eager_s = time.perf_counter() - t0
        short = cells_of(grid(BYZ_EAGER_ITERS))
        diff = [lb for lb in short if not all(np.array_equal(a, b, equal_nan=True)
                                              for a, b in zip(short[lb], eager[lb]))]
        print(f"  grid, eager: {eager_s / BYZ_EAGER_ITERS * 1e3:.1f} ms an iteration (host clock); graph-replayed vs "
              f"eager at iteration {BYZ_EAGER_ITERS} bitwise equal in {len(short) - len(diff)}/{len(short)} cells")
        if diff:
            raise AssertionError(f"fig_byzantine grid: graph-replayed and eager runs differ in {diff}")
        took("eager")

        # each cell looped on the card; a looped cell of each aggregator timed
        looped = {}
        for c in grid_cases:
            res = quickstart.run_case("byzantine", c, data, keys, BYZ_ITERS)
            looped[c.label] = tuple(getattr(res, f).cpu().numpy() for f in ("time", "loss", "k"))
        hold_byzantine("grid vs each cell looped on the card", graph, looped, adaptive, bar, loss_rtol=ENGINE_LOSS_RTOL)
        looped_ms = {}
        for label in ("k16|mean|byz30", "k16|gm|byz30"):
            c = next(c for c in grid_cases if c.label == label)
            looped_ms[label] = cuda_ms(lambda: quickstart.run_case("byzantine", c, data, keys, BYZ_ITERS), iters=1,
                                       warmup=0) / BYZ_ITERS
        print(f"  a looped cell (R={cfg['replicas']}), graph-replayed: " + ", ".join(
            f"{lb} {ms:.4f} ms an iteration" for lb, ms in looped_ms.items()))
        took("looped")

        # kernels an iteration (graph-replayed runs of 2 and 1 iterations), and the device's time
        def graph_launches(run):
            run(1), run(2)  # capture both programs before they are counted
            return count_kernels(lambda: run(2)) - count_kernels(lambda: run(1))

        launches = {"grid": graph_launches(grid)}
        for label in ("k16|mean|byz30", "k16|gm|byz30"):
            c = next(c for c in grid_cases if c.label == label)
            launches[label] = graph_launches(lambda iters, c=c: quickstart.run_case("byzantine", c, data, keys, iters))
        print("  kernels an iteration (graph-replayed, torch.profiler): " + ", ".join(
            f"{k} {v}" for k, v in launches.items()))
        grid(PROFILE_ITERS)  # captures this program's graphs before they are timed
        prof_ms = cuda_ms(lambda: grid(PROFILE_ITERS), iters=2, warmup=0)
        device_breakdown(lambda: grid(PROFILE_ITERS), f"grid, {PROFILE_ITERS} iterations graph-replayed", prof_ms,
                         top=8)
        took("launches and profile")

        # the whole figure, graph-replayed (its own program: another iteration count)
        torch.cuda.synchronize()
        base_alloc = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = quickstart.run("byzantine", device="cuda")
        fig_peak_mb = (torch.cuda.max_memory_allocated() - base_alloc) / 1e6
        flags, t_to = quickstart.headline(out), quickstart.time_to_target(out)
        print(f"  the whole figure ({cfg['iters']} iterations, {len(out['cases'])} cells as one grid): "
              f"{out['wall_s']:.2f} s, capture included; peak memory {fig_peak_mb:.2f} MB above the "
              f"{base_alloc / 1e6:.2f} MB held before it")
        print(f"  headline at k = 16, 30% sign flips: weighted mean final excess {flags['excess_mean_k16_b30']:.6g} "
              f"(diverged: {flags['mean_diverged_b30']}), geometric median {flags['excess_gm_k16_b30']:.6g} "
              f"(recovered: {flags['gm_recovered_b30']})")
        print("  simulated time to 1e-3 of the initial excess: " + ", ".join(
            f"{lb} {'not reached' if t is None else f'{t:.1f}'}" for lb, t in t_to.items()))
        took("whole figure")
        cpu, cpu_s = cpu_f.result()
        took("waiting for the CPU")

    print(f"  the grid on the CPU, {BYZ_CPU_ITERS} iterations in a worker process: {cpu_s:.1f} s")
    hold_byzantine(f"grid vs the CPU at iteration {BYZ_CPU_ITERS}", graph, cpu, adaptive, bar,
                   cols=BYZ_CPU_ITERS // cfg["eval_every"], time_rtol=ENGINE_TIME_RTOL, loss_rtol=ENGINE_LOSS_RTOL)
    print(f"  phase 10 took {time.perf_counter() - phase_t0:.1f} s: " + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in steps.items()))
    return {"graph_ms": graph_ms, "looped_ms": looped_ms, "launches": launches, "peak_mb": peak_mb,
            "pool_mb": pool_mb, "capture_s": first_s - replay_s, "figure_s": out["wall_s"], "flags": flags}


# The training phase.  llama3.2-3b at full width and depth, bf16, remat on,
# random weights from seed 0: sync fastest-k, AdamW at lr 3e-4, Pflug with
# the train CLI's defaults, Exponential(1) stragglers, 4 workers, batch 8 x
# seq 512 from TokenStream seed 0, TRAIN_STEPS steps (the first untimed).
# The eval forward (no grad, the model's own config) runs the bf16 attention
# kernel in each of the 28 layers; its CE is held to the plain path's at the
# same parameters within TRAIN_EVAL_RTOL (the plain path rounds its scores
# and probabilities to bf16 in every layer).
TRAIN = dict(batch=8, seq=512, n_workers=4, lr=3e-4, steps=6)
TRAIN_EVAL_RTOL = 1e-2
PFLUG_CLI = dict(k0=1, step=1, thresh=10, burnin=20)  # launch/train.py's defaults
# qwen1.5-0.5b at full width and depth, bf16: each async mode, 3 steps.
QWEN_ASYNC = dict(batch=8, seq=256, n_workers=4, lr=3e-4, steps=3)
# Card against CPU at smoke width, f32, TF32 off: (arch, mode, n_micro), 3
# steps each at T = 128 (the eval forward runs the f32 kernels on the card):
# k equal, sim_time within 1e-6, ce within 1e-5 relative.
TRAIN_SMOKE_CASES = [(arch, mode, n_micro) for arch in ("llama3.2-3b", "rwkv6-3b")
                     for mode, n_micro in (("sync", 1), ("kasync", 1), ("kbatch", 1), ("sync", 2))]
TRAIN_SMOKE_TIME_RTOL, TRAIN_SMOKE_CE_RTOL = 1e-6, 1e-5
# quickstart --setup lm (fig_lm's grid) at LM_ITERS iterations and R = 8:
# graph-replayed against eager bitwise; each cell against its looped run
# (time and k bitwise, loss within LM_LOOPED_RTOL); against the CPU (no
# fork, time within 1e-6, loss within 1e-4 wherever the loss is
# well-conditioned).  The fixed k = 16 cell takes full-batch steps at eta
# 0.1, and between iterations 45 and 60 they amplify a rounding ~1e4-fold
# (on the CPU: the port against the reference 3.9e-3 at iteration 60, the
# port against itself with its weights scaled by 1 + 1e-7 noise 5.3e-4).
# So the CPU worker runs the grid twice, the second time from weights
# scaled by 1 + LM_NOISE noise, and an eval point where that moves the
# loss by more than LM_WELL_CONDITIONED is reported, not held (its time
# and k still are).
LM_ITERS, LM_LOOPED_RTOL, LM_CPU_TIME_RTOL, LM_CPU_LOSS_RTOL = 60, 1e-5, 1e-6, 1e-4
LM_NOISE, LM_WELL_CONDITIONED = 1e-7, 1e-5


def train_flops(cfg, params, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step (PERF.md §2): per token 6 N for the
    gradient pass and 2 N for the eval forward, N the parameters that enter
    a matmul (all but the embedding table, which is gathered), plus the
    attention products: 12 L H hd T for the gradient pass and 4 L H hd T for
    the eval forward (QK^T and PV over every (query, key) pair, causal or
    not).  Remat's recomputed forward is not counted."""
    n = sum(a.numel() for path, a in _leaf_paths(params) if path != "['embed']")
    attn = cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * seq
    return tokens * (8 * n + 16 * attn)


def _leaf_paths(tree):
    from repro_torch.core.tree import leaves_with_path

    return leaves_with_path(tree)


class TrainRun(NamedTuple):
    """A full-width training run: rows are (ce, k, sim_time) a step, secs its
    host seconds, per_step its flash-attention launches."""
    cfg: object
    model: object
    state: object
    step_fn: object
    data: object
    key: object
    rows: list
    secs: list
    per_step: list
    peak_gb: float
    n_params: int


def train_full_width(label: str, arch: str, t: dict, counters, mesh=None, overrides=None) -> TrainRun:
    """t["steps"] sync train steps of `arch` at full width and depth on the
    card: bf16, remat, random weights from seed 0, AdamW at t["lr"], Pflug
    at the train CLI's defaults, Exponential(1) stragglers, t["n_workers"]
    workers, t["batch"] x t["seq"] tokens from TokenStream seed 0 (vlm and
    encdec: step i's `frontend_inputs` of seed i beside them); the config's
    fields replaced by ``overrides``."""
    import torch
    from repro_torch.checkpoint import convert
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.aggregation import CommModel
    from repro_torch.core.controller import get_controller
    from repro_torch.core.straggler import get_straggler_model
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    cfg = get_config(arch).replace(**(overrides or {}))
    model = build_model(cfg, "cuda")
    params = convert.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(a.numel() for _, a in _leaf_paths(params))
    opt = adamw(t["lr"])
    ctrl = get_controller("pflug", t["n_workers"], **PFLUG_CLI)
    step_fn = steps.make_train_step(model, opt, ctrl, get_straggler_model("exponential"), t["n_workers"],
                                    CommModel(0.0, 0.0), mesh=mesh)
    state = steps.init_train_state(opt, ctrl, params, mesh=mesh)
    del params
    data = TokenStream(cfg.vocab_size, t["seq"], t["batch"], seed=0, device="cuda")
    print(f"[{label}] train {cfg.arch_id}: {cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} G parameters, {cfg.param_dtype}, remat {cfg.remat} ({cfg.remat_policy}); sync fastest-k, AdamW lr "
          f"{t['lr']}, Pflug {PFLUG_CLI}, exp(1), {t['n_workers']} workers, batch {t['batch']} x seq {t['seq']}, "
          f"{t['steps']} steps", flush=True)
    key = prng.PRNGKey(0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    rows, secs, per_step = [], [], []
    for i in range(t["steps"]):
        tok, tgt = data.batch_at(i)
        key, sub = prng.split(key).unbind(0)
        before = counters["flash_attention"].launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, {"tokens": tok, "targets": tgt, **frontend_inputs(cfg, t["batch"], i)}, sub)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(counters["flash_attention"].launches - before)
        rows.append((float(m["ce"]), int(m["k"]), float(m["sim_time"])))
    return TrainRun(cfg, model, state, step_fn, data, key, rows, secs, per_step,
                    torch.cuda.max_memory_allocated() / 1e9, n_params)


def train_llama(counters) -> dict:
    """Phase 11a: llama3.2-3b trained at full width and depth on the card."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import build_model

    t = TRAIN
    run = train_full_width("11", "llama3.2-3b", t, counters)
    cfg, model, state, step_fn, data, key, rows, secs, per_step, peak_gb, n_params = run
    del run
    tokens = t["batch"] * t["seq"]
    counts = {name: c.launches for name, c in counters.items()}
    for i, ((ce, k, st), sec) in enumerate(zip(rows, secs)):
        print(f"  step {i}: ce {ce:.4f}, k {k}, sim_time {st:.4f}, {sec * 1e3:.1f} ms"
              + (" (untimed: first step)" if i == 0 else ""))
    print(f"  launches during the run: {counts}; flash_attention per step {per_step} (expected {cfg.n_layers}, "
          f"the eval forward's layers)")
    if any(n != cfg.n_layers for n in per_step) or counts["wkv6"] != 0:
        raise AssertionError(f"expected {cfg.n_layers} flash-attention launches a step and no wkv6, got {per_step}, "
                             f"{counts}")
    ces, ks, sims = zip(*rows)
    if not all(torch.isfinite(torch.tensor(ces))) or not all(1 <= k <= t["n_workers"] for k in ks):
        raise AssertionError(f"bad ce or k: {rows}")
    if not all(b > a for a, b in zip((0.0,) + sims, sims)):
        raise AssertionError(f"sim_time does not rise: {sims}")
    step_ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    flops = train_flops(cfg, state.params, tokens, t["seq"])
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    print(f"  {step_ms:.1f} ms a step (mean of steps 1-{t['steps'] - 1}), {tokens / (step_ms / 1e3):.0f} tokens/s, "
          f"train_mfu {mfu:.4f} ({flops / 1e12:.1f} TFLOP a step at {PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s); "
          f"peak memory {peak_gb:.2f} GB")

    # the eval forward against the plain path, at the trained parameters
    tok, tgt = data.batch_at(0)
    plain = build_model(cfg.replace(use_kernels=False), "cuda")
    with torch.no_grad():
        ce_kernel = float(model.loss_fn(state.params, {"tokens": tok, "targets": tgt})[1]["ce"])
        ce_plain = float(plain.loss_fn(state.params, {"tokens": tok, "targets": tgt})[1]["ce"])
    gap = abs(ce_kernel - ce_plain) / abs(ce_plain)
    print(f"  eval forward, kernel vs plain attention: ce {ce_kernel:.6f} vs {ce_plain:.6f}, relative gap {gap:.3e} "
          f"(bound {TRAIN_EVAL_RTOL})")
    if not gap < TRAIN_EVAL_RTOL:
        raise AssertionError(f"eval CE differs by {gap:.3e} relative between the kernel and the plain path")
    tok, tgt = data.batch_at(TRAIN["steps"])
    batch = {"tokens": tok, "targets": tgt}
    key, sub = prng.split(key).unbind(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step_fn(state, batch, sub)
    torch.cuda.synchronize()
    prof_ms = 1e3 * (time.perf_counter() - t0)
    key, sub = prng.split(key).unbind(0)
    device_breakdown(lambda: step_fn(state, batch, sub), "one train step (host clock beside it)", prof_ms, top=8)
    del state, model, plain
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_s": tokens / (step_ms / 1e3), "mfu": mfu, "peak_gb": peak_gb,
            "launches": counts["flash_attention"], "eval_gap": gap, "n_params": n_params}


def train_llama_worker() -> dict:
    """`train_llama` in a process of its own: a fresh CUDA context whose
    allocator grows its segments in place (PYTORCH_CUDA_ALLOC_CONF, set by
    the parent), so the full-width run neither inherits the earlier phases'
    segments nor fragments its own."""
    counters = _worker_counters()
    try:
        return train_llama(counters)
    finally:
        sys.stdout.flush()


def train_qwen_async() -> dict:
    """Phase 11b: qwen1.5-0.5b at full width and depth in kasync and kbatch."""
    import torch
    from repro_torch.checkpoint import convert
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.controller import get_controller
    from repro_torch.core.straggler import get_straggler_model
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    t = QWEN_ASYNC
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg, "cuda")
    data = TokenStream(cfg.vocab_size, t["seq"], t["batch"], seed=0, device="cuda")
    out = {}
    for mode in ("kasync", "kbatch"):
        params = convert.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        param_gb = sum(a.numel() * a.element_size() for _, a in _leaf_paths(params)) / 1e9
        opt, ctrl = adamw(t["lr"]), get_controller("pflug", t["n_workers"], **PFLUG_CLI)
        step_fn = steps.make_train_step(model, opt, ctrl, get_straggler_model("exponential"), t["n_workers"],
                                        mode=mode)
        state = steps.init_train_state(opt, ctrl, params)
        key = prng.PRNGKey(0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, secs = [], []
        for i in range(t["steps"]):
            tok, tgt = data.batch_at(i)
            key, sub = prng.split(key).unbind(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, {"tokens": tok, "targets": tgt}, sub)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rows.append((float(m["ce"]), int(m["k"]), float(m["sim_time"])))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(ce) and math.isfinite(st) for ce, _, st in rows):
            raise AssertionError(f"{mode}: values not finite: {rows}")
        step_ms = 1e3 * sum(secs[1:]) / len(secs[1:])
        print(f"[11] train {cfg.arch_id} {mode}: {t['n_workers']} workers, batch {t['batch']} x seq {t['seq']}, "
              f"{param_gb:.2f} GB of parameters: steps (ce, k, sim_time) {[(round(a, 4), b, round(c, 4)) for a, b, c in rows]}; "
              f"{step_ms:.1f} ms a step (steps 1-{t['steps'] - 1}; the first {secs[0] * 1e3:.1f} ms), peak memory "
              f"{peak_gb:.2f} GB ({t['n_workers']} snapshots of {param_gb:.2f} GB)")
        out[mode] = {"step_ms": step_ms, "peak_gb": peak_gb}
        del state, params
        torch.cuda.empty_cache()
    return out


def train_smoke_run(arch: str, mode: str, n_micro: int, device: str):
    """3 train steps of a smoke config (f32) from weights drawn on the CPU
    from seed 0, 128 positions (vlm: its patches and T = 128 - P; vlm and
    encdec fed `frontend_inputs`): [(k, sim_time, ce)] and the kernels'
    launches."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.aggregation import CommModel
    from repro_torch.core.controller import PflugController
    from repro_torch.core.straggler import Exponential
    from repro_torch.data import TokenStream
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    cfg = get_smoke_config(arch)
    params = tree_map(lambda a: a.to(device), build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))
    opt, ctrl = sgd(0.3, momentum=0.9), PflugController(n_workers=4, k0=1, step=1, thresh=0, burnin=0)
    step = steps.make_train_step(build_model(cfg, device), opt, ctrl, Exponential(1.0), 4, CommModel(0.1, 0.05),
                                 n_micro=n_micro, mode=mode)
    state = steps.init_train_state(opt, ctrl, params)
    data = TokenStream(cfg.vocab_size, 128 - (cfg.vlm_patches if cfg.family == "vlm" else 0), 8, seed=0,
                       device=device)
    key = prng.PRNGKey(7, device=device)
    before = (ops.launches, wkv_ops.launches)
    rows = []
    for i in range(3):
        tok, tgt = data.batch_at(i)
        key, sub = prng.split(key).unbind(0)
        state, m = step(state, {"tokens": tok, "targets": tgt, **frontend_inputs(cfg, 8, i, device)}, sub)
        rows.append((int(m["k"]), float(m["sim_time"]), float(m["ce"])))
    return rows, (ops.launches - before[0], wkv_ops.launches - before[1])


def train_smoke_cpu_runs(cases, threads: int) -> list:
    """`train_smoke_run` of each (arch, mode, n_micro) of ``cases`` on the
    CPU, in a worker process: each case's rows."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(threads)
    return [train_smoke_run(arch, mode, n_micro, "cpu")[0] for arch, mode, n_micro in cases]


def start_smoke_cpu_runs(cases):
    """(pool, future) of `train_smoke_cpu_runs` of ``cases`` in a worker
    process, started at a phase's start so that it runs beside the card's
    work."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(train_smoke_cpu_runs, cases, 4)


def hold_smoke_vs_cpu(cases, cpu_f) -> tuple:
    """Each case's train steps on the card against the CPU's (``cpu_f``,
    `start_smoke_cpu_runs`): k equal, sim_time and ce within their bounds.
    Returns the worst (sim_time, ce) gaps and each case's kernel launches
    on the card."""
    worst, launches = (0.0, 0.0), {}
    cards = [train_smoke_run(arch, mode, n_micro, "cuda") for arch, mode, n_micro in cases]
    for (arch, mode, n_micro), (card, counts), cpu in zip(cases, cards, cpu_f.result()):
        launches[(arch, mode, n_micro)] = counts
        for (k, st, ce), (k0, st0, ce0) in zip(card, cpu):
            t_gap, c_gap = abs(st - st0) / abs(st0), abs(ce - ce0) / abs(ce0)
            worst = (max(worst[0], t_gap), max(worst[1], c_gap))
            if k != k0 or not (t_gap <= TRAIN_SMOKE_TIME_RTOL and c_gap <= TRAIN_SMOKE_CE_RTOL):
                raise AssertionError(f"card vs CPU, {arch} {mode} n_micro {n_micro}: {card} against {cpu}")
    return worst, launches


def train_smoke_vs_cpu(cpu_f) -> dict:
    """Phase 11c: the train step on the card against the CPU at smoke width
    (the CPU's runs in a worker process since the phase's start)."""
    worst, launches = hold_smoke_vs_cpu(TRAIN_SMOKE_CASES, cpu_f)
    print(f"[11] card vs CPU at smoke width (f32, T = 128, 3 steps): {len(TRAIN_SMOKE_CASES)} runs "
          f"({', '.join(f'{a} {m}' + (f' n_micro {n}' if n > 1 else '') for a, m, n in TRAIN_SMOKE_CASES)}): "
          f"k equal, max rel gap sim_time {worst[0]:.3e} (bound {TRAIN_SMOKE_TIME_RTOL}), ce {worst[1]:.3e} "
          f"(bound {TRAIN_SMOKE_CE_RTOL}); kernel launches on the card (flash, wkv6): "
          + ", ".join(f"{a} {m}{'/' + str(n) if n > 1 else ''} {c}" for (a, m, n), c in launches.items()))
    return {"rwkv_sync_wkv_launches": launches[("rwkv6-3b", "sync", 1)][1]}


def lm_grid_cpu(iters: int, threads: int):
    """fig_lm's grid on the CPU in a worker process, from its weights and
    from them scaled by 1 + LM_NOISE noise: two {label: (time, loss, k)}."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.core.straggler import Exponential
    from repro_torch.core.sweep import run_sweep_source
    from repro_torch.launch import quickstart

    torch.set_num_threads(threads)
    cfg = quickstart.LM
    source, params0, data, keys = quickstart.lm_inputs(device="cpu")
    cases = quickstart.lm_cases(quickstart.theorem1_times(source, params0, data, Exponential(rate=1.0)))
    rng = np.random.default_rng(0)
    noisy = tree_map(lambda a: a * (1 + LM_NOISE * torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))),
                     params0)
    out = []
    for p in (params0, noisy):
        res = run_sweep_source(source, p, data, n_workers=cfg["n"], cases=cases, num_iters=iters, keys=keys,
                               eval_every=cfg["eval_every"], device="cpu")
        out.append(cells_of(res))
    return out


def train_lm_grid() -> dict:
    """Phase 11d: quickstart --setup lm (fig_lm's grid) on the card."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from repro_torch.core.straggler import Exponential
    from repro_torch.core.sweep import run_sweep_source
    from repro_torch.launch import quickstart

    cfg = quickstart.LM
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        cpu_f = pool.submit(lm_grid_cpu, LM_ITERS, 6)
        source, params0, data, keys = quickstart.lm_inputs(device="cuda")
        grid_cases = quickstart.lm_cases(quickstart.theorem1_times(source, params0, data, Exponential(rate=1.0)))

        def grid(iters, capture=True):
            return run_sweep_source(source, params0, data, n_workers=cfg["n"], cases=grid_cases, num_iters=iters,
                                    keys=keys, eval_every=cfg["eval_every"], device="cuda", capture=capture)

        lanes = len(grid_cases) * cfg["replicas"]
        print(f"[11] --setup lm: fig_lm's grid ({len(grid_cases)} cells x R={cfg['replicas']} = {lanes} lanes, "
              f"n={cfg['n']}, a {cfg['rows']} x {cfg['seq']} token batch, the shrunk {cfg['arch']}), {LM_ITERS} "
              "iterations")
        t0 = time.perf_counter()
        graph = cells_of(grid(LM_ITERS))
        first_s = time.perf_counter() - t0
        eager = cells_of(grid(LM_ITERS, capture=False))
        diff = [lb for lb in graph if not all(np.array_equal(a, b) for a, b in zip(graph[lb], eager[lb]))]
        print(f"  graph-replayed vs eager: {len(graph) - len(diff)}/{len(graph)} cells bitwise equal"
              + (f"; differ: {diff}" if diff else "") + f" (first run {first_s:.2f} s, capture included)")
        if diff:
            raise AssertionError(f"--setup lm: graph-replayed run differs from eager in {diff}")
        looped = quickstart.run_lm(iters=LM_ITERS, device="cuda", looped=True)["results"]
        worst = 0.0
        for lb, (gt, gl, gk) in graph.items():
            lt, ll, lk = (getattr(looped[lb], f).cpu().numpy() for f in ("time", "loss", "k"))
            gap = float(np.max(np.abs(gl - ll) / np.abs(ll)))
            worst = max(worst, gap)
            if not (np.array_equal(gt, lt) and np.array_equal(gk, lk) and gap <= LM_LOOPED_RTOL):
                raise AssertionError(f"--setup lm: {lb} differs from its looped run (loss gap {gap:.3e})")
        print(f"  each cell vs its looped run: time and k bitwise, loss within {worst:.3e} (bound {LM_LOOPED_RTOL})")
        grid(1), grid(2)  # capture both programs before they are counted
        launches = count_kernels(lambda: grid(2)) - count_kernels(lambda: grid(1))
        iter_ms = cuda_ms(lambda: grid(LM_ITERS), iters=2, warmup=0) / LM_ITERS
        print(f"  graph-replayed: {iter_ms:.4f} ms an iteration ({lanes} lanes), {launches} kernels an iteration "
              "(torch.profiler, runs of 2 and 1 iterations)")
        cpu, noisy = cpu_f.result()
    worst, unheld = (0.0, 0.0), []
    for lb, (gt, gl, gk) in graph.items():
        ct, cl, ck = cpu[lb]
        t_gap = float(np.max(np.abs(gt - ct) / np.abs(ct)))
        l_gaps = np.abs(gl - cl) / np.abs(cl)
        cond = np.abs(noisy[lb][1] - cl) / np.abs(cl)  # the loss's own move under LM_NOISE
        held = cond <= LM_WELL_CONDITIONED
        worst = (max(worst[0], t_gap), max(worst[1], float(np.max(l_gaps[held], initial=0.0))))
        for r, c in zip(*np.nonzero(~held)):
            unheld.append(f"{lb} replica {r} iteration {(c + 1) * cfg['eval_every']}: card vs CPU {l_gaps[r, c]:.2e}, "
                          f"the CPU under noise {cond[r, c]:.2e}")
        if not (np.array_equal(gk, ck) and t_gap <= LM_CPU_TIME_RTOL and bool((l_gaps[held] <= LM_CPU_LOSS_RTOL).all())
                and np.isfinite(gl).all()):
            raise AssertionError(f"--setup lm: {lb} on the card differs from the CPU (time {t_gap:.3e}, loss "
                                 f"{l_gaps.max():.3e}, k equal {np.array_equal(gk, ck)})")
    print(f"  card vs CPU at iteration {LM_ITERS}: no fork, max rel gap time {worst[0]:.3e} (bound {LM_CPU_TIME_RTOL}),"
          f" loss {worst[1]:.3e} (bound {LM_CPU_LOSS_RTOL}) where weights scaled by 1 + {LM_NOISE:g} noise move the "
          f"CPU's loss by at most {LM_WELL_CONDITIONED:g}; not held there ({len(unheld)} of "
          f"{sum(a[1].size for a in graph.values())} points): " + ("; ".join(unheld) or "none"))
    out = quickstart.run_lm(device="cuda")
    final = {lb: float(s["loss_mean"][-1]) for lb, s in out["cases"].items()}
    print(f"  the whole figure ({cfg['iters']} iterations, one grid): {out['wall_s']:.2f} s; final CE "
          + ", ".join(f"{lb} {ce:.4f}" for lb, ce in final.items())
          + f"; adaptive k_final {out['cases']['adaptive']['k_mean'][-1]:.1f}; Theorem-1 switches "
          f"{[round(x, 1) for x in out['t1_times']]}")
    if not all(math.isfinite(ce) for ce in final.values()):
        raise AssertionError(f"--setup lm: final CE not finite: {final}")
    return {"iter_ms": iter_ms, "launches": launches, "figure_s": out["wall_s"]}


def train_phase() -> dict:
    """Phase 11: the LM training path."""
    import torch
    from repro_torch.core import montecarlo, sweep

    phase_t0 = time.perf_counter()
    # the engine phases' programs hold CUDA-graph pools; the full-width run needs the card
    montecarlo.clear_program_cache()
    sweep.clear_sweep_cache()
    torch.cuda.empty_cache()
    print(f"[11] this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB of the card's memory before the "
          "full-width run (in a process of its own)", flush=True)
    parts, t0 = {}, time.perf_counter()
    out = {}
    pool, cpu_f = start_smoke_cpu_runs(TRAIN_SMOKE_CASES)
    try:
        for name, fn in (("llama", lambda: in_spawned_process(train_llama_worker)), ("qwen", train_qwen_async),
                         ("smoke", lambda: train_smoke_vs_cpu(cpu_f)), ("lm", train_lm_grid)):
            out[name] = fn()
            parts[name], t0 = time.perf_counter() - t0, time.perf_counter()
    finally:
        pool.shutdown()
    print(f"  phase 11 took {time.perf_counter() - phase_t0:.1f} s: llama3.2-3b {parts['llama']:.1f} s, qwen1.5-0.5b "
          f"async {parts['qwen']:.1f} s, card vs CPU {parts['smoke']:.1f} s, --setup lm {parts['lm']:.1f} s")
    return out


# The MoE and hybrid families (phase 12).  The flash-attention kernel at the
# three families' prefill shapes (bf16, causal; hymba-1.5b's 25 heads over 5
# kv heads with its 1024-token sliding window at T = 2048), each held to the
# plain version at TOL and timed in turns with SDPA (hymba's with the
# boolean window mask).  Then each arch served at full width and depth, bf16,
# random weights from seed 0, batch 4, 32 greedy tokens: qwen3-moe-30b-a3b
# (~60 GB of weights) in a process of its own with expandable segments, as
# phase 11 trains llama3.2-3b.  Each layer's attention sub-block is held to
# the plain path from the same input (the kernel path's output of the layer
# below) within FAMILY_LAYER_TOL of its max; for MoE the run reports the
# share of tokens whose expert set differs between the two paths' router
# inputs (a routing flip moves a whole token, so the layer output is no
# test).  The smoke configs in f32: kernel against plain within 1e-4, equal
# greedy tokens.  Then granite-moe-1b-a400m and hymba-1.5b trained at full
# width (phase 11's recipe, FAMILY_TRAIN; the kernel also held and timed at
# the eval forward's shapes, FAMILY_TRAIN_SHAPES), the eval forward at the
# trained parameters held to the plain path, and the train step of all three
# archs on the card against the CPU at smoke width (phase 11's bounds).
FAMILY_SHAPES = {
    "qwen3-moe-30b-a3b": (4, 1024, 1024, 32, 4, 64, True, 0),
    "granite-moe-1b-a400m": (4, 1024, 1024, 16, 8, 64, True, 0),
    "hymba-1.5b": (4, 2048, 2048, 25, 5, 64, True, 1024),
}
# (batch, prompt length, new tokens, window) of each serve run
FAMILY_SERVE = {"qwen3-moe-30b-a3b": (4, 1024, 32, 0), "granite-moe-1b-a400m": (4, 1024, 32, 0),
                "hymba-1.5b": (4, 2048, 32, 1024)}
# the train step's eval forward (FAMILY_TRAIN's batch x seq, the arch's own window)
FAMILY_TRAIN_SHAPES = {
    "granite-moe-1b-a400m": (8, 512, 512, 16, 8, 64, True, 0),
    "hymba-1.5b": (8, 512, 512, 25, 5, 64, True, 1024),
}
FAMILY_LAYER_TOL = 2e-2
FAMILY_TRAIN = dict(batch=8, seq=512, n_workers=4, lr=3e-4, steps=3)


def attention_layer_gaps(cfg, params, prompts, window: int, extra=None):
    """Each layer's attention sub-block, kernel against plain path, from the
    same input (the kernel path's output of the layer below; the input and
    the layer are the model's own, `transformer.attention_input` and
    `block_full`, with vlm's patches before the prompt and encdec's memory
    from `extra`): the worst max|dy|/max|y| over the layers, and for moe the
    share of tokens whose expert set differs between the router inputs the
    two paths give (None for other families)."""
    import torch
    from repro_torch.models import build_model, layers, moe, transformer

    plain = cfg.replace(use_kernels=False)
    extra = extra or {}
    worst, flipped, routed = 0.0, 0, 0
    with torch.inference_mode():
        x = layers.embed(params, cfg, prompts)
        if "patches" in extra:
            x = torch.cat([extra["patches"].to(x.dtype), x], dim=1)
        enc_out = build_model(cfg, x.device).encode(params, extra["frames"]) if "frames" in extra else None
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.n_layers):
            p = transformer.layer_params(params["layers"], i)
            attn, h = transformer.attention_input(p, cfg, x)
            yk = layers.attention_full(attn, cfg, h, pos, causal=True, window=window)
            yp = layers.attention_full(attn, plain, h, pos, causal=True, window=window)
            worst = max(worst, rel_gap(yk.float(), yp.float()))
            if cfg.family == "moe":
                sets = [moe.route(p["moe"], cfg, transformer.ffn_input(p, x + y))[0].sort(dim=0).values
                        for y in (yk, yp)]
                flipped += int((sets[0] != sets[1]).any(dim=0).sum())
                routed += sets[0][0].numel()
            x = transformer.block_full(p, cfg, x, pos, window=window, enc_out=enc_out)[0]
    return worst, (flipped / routed if routed else None)


def serve_family(arch: str, counters, label: str = "12") -> dict:
    """Phases 12b/c and 13b: one arch served at full width on the card, at
    its full depth or `full_width_config`'s, with `frontend_inputs` for vlm
    and encdec."""
    import torch
    from repro_torch.checkpoint import convert
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = full_width_config(arch)
    b, t, new, window = {**FAMILY_SERVE, **NEW_SERVE}[arch]
    extra = frontend_inputs(cfg, b, seed=2)
    n_prefix = cfg.vlm_patches if cfg.family == "vlm" else 0
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = convert.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(a.numel() for a in _leaves(params))
    weight_gb = sum(a.numel() * a.element_size() for a in _leaves(params)) / 1e9
    family_note = {"moe": f", {cfg.n_experts} experts top-{cfg.moe_top_k} of d_ff {cfg.d_ff} ({cfg.moe_dispatch})",
                   "hybrid": f", SSM state {cfg.ssm_state}, d_ff {cfg.d_ff}",
                   "encdec": f", d_ff {cfg.d_ff}; encoder {cfg.encoder_layers} layers over {cfg.encoder_frames} random "
                             "frames",
                   "vlm": f", d_ff {cfg.d_ff}; {cfg.vlm_patches} random patches before the prompt"}
    print(f"[{label}] serve {arch}: {cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv of {cfg.resolved_head_dim}" + family_note.get(cfg.family, f", d_ff {cfg.d_ff}")
          + f"; {n_params / 1e9:.3f} G parameters, {weight_gb:.2f} GB in {cfg.param_dtype} (drawn in {init_s:.1f} s, "
          f"peak {init_peak_gb:.2f} GB while drawn); batch {b}, prompt {t}, {new} new tokens, window {window}",
          flush=True)
    prompts = serve.random_prompts(cfg, b, t, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res = serve.generate(model, params, prompts, new, window=window, **extra)
    counts = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches during the run: {counts} (expected flash_attention {cfg.n_layers}, one per prefill layer)")
    if counts != {"flash_attention": cfg.n_layers, "wkv6": 0}:
        raise AssertionError(f"{arch}: expected {cfg.n_layers} flash-attention launches and no other, got {counts}")
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError(f"{arch}: prefill logits are not finite")
    if tuple(res.tokens.shape) != (b, new) or not bool(((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()):
        raise AssertionError(f"{arch}: bad generated tokens {tuple(res.tokens.shape)}")
    steps = new - 1
    tok_s = steps * b / res.decode_s
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"  first prefill {res.prefill_s * 1e3:.1f} ms; decoded {steps} steps x batch {b} in {res.decode_s:.3f} s "
          f"({tok_s:.1f} tok/s); peak memory {peak_gb:.2f} GB of {total_gb:.1f} GB")
    print(f"  tokens[0]: {res.tokens[0].tolist()}")
    batch = {"tokens": prompts, **extra}
    prefill_ms = cuda_ms(lambda: model.prefill(params, batch, window=window), iters=3, warmup=1)
    print(f"  prefill {prefill_ms:.1f} ms (CUDA events, mean of 3" + (", the encoder's pass included)" if "frames" in
                                                                      extra else ")"))
    device_breakdown(lambda: model.prefill(params, batch, window=window), "prefill", prefill_ms)
    del res
    cache = model.init_cache(b, n_prefix + t + new, window)
    token = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    enc_out = model.encode(params, extra["frames"]) if "frames" in extra else None
    step = lambda: model.decode_step(params, token, cache, n_prefix + t, window=window, enc_out=enc_out)  # noqa: E731
    decode_ms = cuda_ms(step, iters=5, warmup=2)
    device_breakdown(step, "one decode step", decode_ms)
    del cache, enc_out
    layer_rel, flip_share = attention_layer_gaps(cfg, params, prompts, window, extra)
    print(f"  attention sub-block, kernel vs plain, each layer fed the same input: worst max|dy|/max|y| "
          f"{layer_rel:.3e} (bound {FAMILY_LAYER_TOL})"
          + (f"; tokens whose expert set differs between the two paths: {flip_share:.4%}" if flip_share is not None
             else ""))
    if not layer_rel < FAMILY_LAYER_TOL:
        raise AssertionError(f"{arch}: a layer's attention differs by {layer_rel:.3e} relative (> {FAMILY_LAYER_TOL})")
    del params, model
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attention"], "prefill_ms": prefill_ms, "tok_s": tok_s, "peak_gb": peak_gb,
            "layer_rel": layer_rel, "flip_share": flip_share, "weight_gb": weight_gb}


def serve_qwen3_worker() -> dict:
    """`serve_family` of qwen3-moe-30b-a3b in a process of its own: a fresh
    CUDA context whose allocator grows its segments in place
    (PYTORCH_CUDA_ALLOC_CONF, set by the parent), for ~60 GB of weights."""
    counters = _worker_counters()
    try:
        return serve_family("qwen3-moe-30b-a3b", counters)
    finally:
        sys.stdout.flush()


def family_smoke_serving() -> None:
    """Phase 12c: each arch's smoke config in f32, kernel path against plain
    path (hymba at its sliding window, 32): prefill logits within 1e-4 and
    equal greedy tokens.  The MoE smoke configs' head dim is 16 (f32 route)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve

    for arch in FAMILY_SHAPES:
        small = get_smoke_config(arch)
        runs = {use: serve.serve(small.replace(use_kernels=use), batch=2, prompt_len=128, new_tokens=8, seed=3,
                                 window=small.sliding_window) for use in (True, False)}
        d = (runs[True].prefill_logits - runs[False].prefill_logits).abs().max().item()
        same = bool(torch.equal(runs[True].tokens, runs[False].tokens))
        print(f"  {arch} smoke config f32 (head dim {small.resolved_head_dim}, window {small.sliding_window}), "
              f"kernel vs plain: max|dlogits| {d:.3e} (atol 1e-4), greedy tokens equal: {same}")
        if not (d <= 1e-4 and same):
            raise AssertionError(f"{arch} smoke model: kernel path disagrees with the plain path")


def train_family(arch: str, counters, label: str = "12") -> dict:
    """Phases 12d and 13d: one arch trained at full width and depth
    (FAMILY_TRAIN), then the eval forward at the trained parameters held to
    the plain path: ce and moe_aux within TRAIN_EVAL_RTOL, and each layer's
    attention sub-block within FAMILY_LAYER_TOL (ce at random weights hardly
    depends on the attention)."""
    import torch
    from repro_torch.models import build_model

    t = FAMILY_TRAIN
    run = train_full_width(label, arch, t, counters)
    cfg, rows, secs, per_step, peak_gb = run.cfg, run.rows, run.secs, run.per_step, run.peak_gb
    tokens = t["batch"] * t["seq"]
    launches = counters["flash_attention"].launches
    tok, tgt = run.data.batch_at(0)
    extra = frontend_inputs(cfg, t["batch"], 0)
    batch = {"tokens": tok, "targets": tgt, **extra}
    plain = build_model(cfg.replace(use_kernels=False), "cuda")
    with torch.no_grad():
        (ce, aux), (ce_p, aux_p) = ((float(m["ce"]), float(m["moe_aux"])) for m in (
            model.loss_fn(run.state.params, batch)[1] for model in (run.model, plain)))
    layer_rel, flip_share = attention_layer_gaps(cfg, run.state.params, tok, cfg.sliding_window, extra)
    ce_gap = abs(ce - ce_p) / abs(ce_p)
    aux_gap = abs(aux - aux_p) / abs(aux_p) if cfg.family == "moe" else 0.0
    step_ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    print(f"  steps (ce, k, sim_time) {[(round(a, 4), b, round(c, 4)) for a, b, c in rows]}; "
          f"flash_attention per step {per_step} (expected {cfg.n_layers}); {step_ms:.1f} ms a step (steps "
          f"1-{t['steps'] - 1}; the first {secs[0] * 1e3:.1f} ms), {tokens / (step_ms / 1e3):.0f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    print(f"  eval forward at the trained parameters, kernel vs plain path: ce {ce:.6f} vs {ce_p:.6f} (relative "
          f"gap {ce_gap:.3e}), moe_aux {aux:.6f} vs {aux_p:.6f} (relative gap {aux_gap:.3e}; bound "
          f"{TRAIN_EVAL_RTOL}); attention sub-block, each layer fed the same input: worst max|dy|/max|y| "
          f"{layer_rel:.3e} (bound {FAMILY_LAYER_TOL})"
          + (f"; tokens whose expert set differs: {flip_share:.4%}" if flip_share is not None else ""), flush=True)
    if not (ce_gap < TRAIN_EVAL_RTOL and aux_gap < TRAIN_EVAL_RTOL and layer_rel < FAMILY_LAYER_TOL):
        raise AssertionError(f"{arch}: the eval forward's kernel path disagrees with the plain path")
    ces, ks, sims = zip(*rows)
    if any(n != cfg.n_layers for n in per_step):
        raise AssertionError(f"{arch}: expected {cfg.n_layers} flash-attention launches a step, got {per_step}")
    if not all(math.isfinite(ce) for ce in ces) or not math.isfinite(aux) or not all(
            1 <= k <= t["n_workers"] for k in ks):
        raise AssertionError(f"{arch}: bad ce, moe_aux or k: {rows}, {aux}")
    if not all(b > a for a, b in zip((0.0,) + sims, sims)):
        raise AssertionError(f"{arch}: sim_time does not rise: {sims}")
    del run, plain
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_s": tokens / (step_ms / 1e3), "peak_gb": peak_gb, "launches": launches,
            "moe_aux": aux, "eval_gap": ce_gap, "aux_gap": aux_gap, "layer_rel": layer_rel, "flip_share": flip_share}


def family_phase(counters) -> dict:
    """Phase 12: the MoE and hybrid families."""
    phase_t0 = time.perf_counter()
    smoke_cases = [(arch, "sync", 1) for arch in FAMILY_SHAPES]
    pool, cpu_f = start_smoke_cpu_runs(smoke_cases)
    try:
        out = family_phase_on_card(counters, smoke_cases, cpu_f)
    finally:
        pool.shutdown()
    print(f"  phase 12 took {time.perf_counter() - phase_t0:.1f} s")
    return out


def family_phase_on_card(counters, smoke_cases, cpu_f) -> dict:
    """Phase 12's work, beside the CPU's smoke-width train steps (``cpu_f``)."""
    import torch

    out = {"kernel": {}, "train_kernel": {}, "serve": {}, "train": {}}
    print("[12] flash attention at the MoE and hybrid families' prefill shapes and train-step eval shapes (bf16)")
    for i, (key, arch, shape) in enumerate([("kernel", a, sh) for a, sh in FAMILY_SHAPES.items()]
                                           + [("train_kernel", a, sh) for a, sh in FAMILY_TRAIN_SHAPES.items()]):
        err = check_attention(shape, "bfloat16", seed=400 + i)
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = report_attention_times(arch, shape)
        out[key][arch] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    torch.cuda.empty_cache()
    out["serve"]["qwen3-moe-30b-a3b"] = in_spawned_process(serve_qwen3_worker)
    for arch in ("granite-moe-1b-a400m", "hymba-1.5b"):
        out["serve"][arch] = serve_family(arch, counters)
    family_smoke_serving()
    for arch in FAMILY_TRAIN_SHAPES:
        out["train"][arch] = train_family(arch, counters)
    worst, launches = hold_smoke_vs_cpu(smoke_cases, cpu_f)
    smoke_launches = {arch: launches[(arch, mode, n)] for arch, mode, n in smoke_cases}
    print(f"[12] train step card vs CPU at smoke width (f32, T = 128, sync, 3 steps): {', '.join(FAMILY_SHAPES)}: "
          f"k equal, max rel gap sim_time {worst[0]:.3e} (bound {TRAIN_SMOKE_TIME_RTOL}), ce {worst[1]:.3e} "
          f"(bound {TRAIN_SMOKE_CE_RTOL}); kernel launches on the card (flash, wkv6): {smoke_launches}")
    return out


# The vlm and encdec families and the large dense archs (phase 13).  The
# flash-attention kernel at head dims 192 and 256, both routes: the shapes
# of tests/test_kernels.py at those head dims and ragged T = S, and the f32
# route at hd 48 (nemotron-4-340b's smoke config), each held to the plain
# version at TOL; then at the four archs' prefill shapes and the two train
# steps' eval shapes (bf16), held and timed in turns with SDPA.  Then each
# arch served at full width, bf16, random weights from seed 0, batch 4,
# prompt 1024, 32 greedy tokens, with seeded random frames or patches (zero
# ones would leave the encoder's memory 0 and the cross-attention inert):
# qwen1.5-110b at 8 of its 80 layers and nemotron-4-340b at 2 of its 96
# (CUT_DEPTH: all of either holds 222 or 680 GB of bf16 weights), all four
# in one process of their own with expandable segments; each layer's
# attention sub-block held to the plain path as in phase 12.  Then
# seamless-m4t-medium and paligemma-3b trained at full width (FAMILY_TRAIN,
# in a process of their own), the eval forward at the trained parameters
# held to the plain path; and the four smoke configs in f32 on the card
# against the CPU: greedy tokens equal, prefill logits within 1e-4, the
# train step's k equal, sim_time within 1e-6 and ce within 1e-5.
NEW_ARCHS = ("seamless-m4t-medium", "paligemma-3b", "qwen1.5-110b", "nemotron-4-340b")
CUT_DEPTH = {"qwen1.5-110b": 8, "nemotron-4-340b": 2}
NEW_SHAPES = {
    "seamless-m4t-medium": (4, 1024, 1024, 16, 16, 64, True, 0),  # the decoder's self-attention
    "paligemma-3b": (4, 1280, 1280, 8, 1, 256, True, 0),  # 256 patches + 1024 tokens, MQA
    "qwen1.5-110b": (4, 1024, 1024, 64, 8, 128, True, 0),
    "nemotron-4-340b": (4, 1024, 1024, 96, 8, 192, True, 0),
}
NEW_SERVE = {arch: (4, 1024, 32, 0) for arch in NEW_ARCHS}
NEW_TRAIN_SHAPES = {
    "seamless-m4t-medium": (8, 512, 512, 16, 16, 64, True, 0),
    "paligemma-3b": (8, 768, 768, 8, 1, 256, True, 0),  # 256 patches + 512 tokens
}
NEW_HEAD_DIM_SHAPES = ([sh[:5] + (hd,) + sh[6:] for hd in (192, 256) for sh in ATTN_SHAPES]
                       + [(1, t, t, 4, 2, hd, True, 0) for hd in (192, 256) for t in (65, 100, 129, 200)])
HD48_SHAPES = [(2, 128, 128, 8, 2, 48, True, 0), (1, 100, 100, 4, 2, 48, True, 0), (1, 256, 256, 4, 2, 48, True, 64)]
NEW_SMOKE_LOGIT_ATOL = 1e-4


def full_width_config(arch: str):
    """The arch's published config, at CUT_DEPTH's depth where one card
    cannot hold all of it (every width as published)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.replace(n_layers=CUT_DEPTH[arch]) if arch in CUT_DEPTH else cfg


def frontend_inputs(cfg, batch: int, seed: int, device="cuda") -> dict:
    """Seeded random vlm patches or encdec frames, (B, P or F, D) f32, drawn
    on the CPU so that the card and the CPU get the same ones ({} for the
    other families).  Never zeros: zero frames leave every encoder layer at
    0 and the cross-attention adds exactly 0."""
    import torch

    n = {"vlm": cfg.vlm_patches, "encdec": cfg.encoder_frames}.get(cfg.family)
    if n is None:
        return {}
    x = torch.randn((batch, n, cfg.d_model), generator=torch.Generator().manual_seed(1000 + seed))
    return {"patches" if cfg.family == "vlm" else "frames": x.to(device)}


def _worker_counters():
    """The kernel wrappers' counters in a spawned process (TF32 off)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.wkv import ops as wkv_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"flash_attention": ops, "wkv6": wkv_ops}


def serve_new_worker() -> dict:
    """Phase 13b in a process of its own (expandable segments, set by the
    parent): the four archs served at full width, one after another."""
    counters = _worker_counters()
    try:
        return {arch: serve_family(arch, counters, "13") for arch in NEW_ARCHS}
    finally:
        sys.stdout.flush()


def train_new_worker() -> dict:
    """Phase 13c in a process of its own: seamless-m4t-medium and
    paligemma-3b trained at full width."""
    counters = _worker_counters()
    try:
        return {arch: train_family(arch, counters, "13") for arch in NEW_TRAIN_SHAPES}
    finally:
        sys.stdout.flush()


def in_spawned_process(fn):
    """fn() in a spawned process whose allocator grows its segments in place."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # for the spawned process only
    try:
        with ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn")) as pool:
            return pool.submit(fn).result()
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf


def new_smoke_vs_cpu() -> dict:
    """Phase 13d: each new arch's smoke config in f32 on the card against
    the CPU, from the same weights (drawn on the CPU), prompts and random
    patches or frames, 128 positions (vlm: 16 patches + 112 tokens): the
    serving loop (greedy tokens equal, prefill logits within
    NEW_SMOKE_LOGIT_ATOL, one flash launch a decoder layer on the card) and
    the train step (sync, train_smoke_run)."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    worst_logit, worst_train, launches = 0.0, (0.0, 0.0), {}
    for arch in NEW_ARCHS:
        cfg = get_smoke_config(arch)
        t = 128 - (cfg.vlm_patches if cfg.family == "vlm" else 0)
        params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        prompts = torch.randint(0, cfg.vocab_size, (2, t), generator=torch.Generator().manual_seed(3))
        runs = {}
        for dev in ("cpu", "cuda"):
            before = ops.launches
            runs[dev] = serve.generate(build_model(cfg, dev), tree_map(lambda a: a.to(dev), params),
                                       prompts.to(dev), 8, **frontend_inputs(cfg, 2, 0, dev))
            launches[arch] = ops.launches - before
        d = (runs["cuda"].prefill_logits.cpu() - runs["cpu"].prefill_logits).abs().max().item()
        worst_logit = max(worst_logit, d)
        if not (d <= NEW_SMOKE_LOGIT_ATOL and torch.equal(runs["cuda"].tokens.cpu(), runs["cpu"].tokens)
                and launches[arch] == cfg.n_layers):
            raise AssertionError(f"{arch} smoke serving, card vs CPU: max|dlogits| {d:.3e}, tokens "
                                 f"{runs['cuda'].tokens.tolist()} vs {runs['cpu'].tokens.tolist()}, "
                                 f"{launches[arch]} flash launches")
        card, counts = train_smoke_run(arch, "sync", 1, "cuda")
        cpu, _ = train_smoke_run(arch, "sync", 1, "cpu")
        for (k, st, ce), (k0, st0, ce0) in zip(card, cpu):
            t_gap, c_gap = abs(st - st0) / abs(st0), abs(ce - ce0) / abs(ce0)
            worst_train = (max(worst_train[0], t_gap), max(worst_train[1], c_gap))
            if k != k0 or not (t_gap <= TRAIN_SMOKE_TIME_RTOL and c_gap <= TRAIN_SMOKE_CE_RTOL):
                raise AssertionError(f"card vs CPU, {arch} sync: {card} against {cpu}")
        if counts != (3 * cfg.n_layers, 0):
            raise AssertionError(f"{arch} smoke train step: kernel launches {counts}, expected one a layer a step")
    print(f"[13] smoke configs card vs CPU (f32, 128 positions; {', '.join(NEW_ARCHS)}): serving greedy tokens equal, "
          f"max|dlogits| {worst_logit:.3e} (atol {NEW_SMOKE_LOGIT_ATOL}), flash launches a serve run {launches}; "
          f"train step (sync, 3 steps) k equal, max rel gap sim_time {worst_train[0]:.3e} (bound "
          f"{TRAIN_SMOKE_TIME_RTOL}), ce {worst_train[1]:.3e} (bound {TRAIN_SMOKE_CE_RTOL})")
    return {"logit_gap": worst_logit, "ce_gap": worst_train[1]}


def new_families_phase() -> dict:
    """Phase 13: the vlm and encdec families, qwen1.5-110b and nemotron-4-340b."""
    import torch

    phase_t0 = time.perf_counter()
    out = {"kernel": {}, "train_kernel": {}}
    print("[13] flash attention at head dims 192 and 256 (tests/test_kernels.py's shapes and ragged T, both routes) "
          "and the f32 route at head dim 48")
    errs = {dt: 0.0 for dt in ("float32", "bfloat16")}
    for i, shape in enumerate(NEW_HEAD_DIM_SHAPES):
        for dt in errs:
            errs[dt] = max(errs[dt], check_attention(shape, dt, seed=500 + i))
    for i, shape in enumerate(HD48_SHAPES):
        check_attention(shape, "float32", seed=540 + i)
    print(f"  worst max_abs_err at hd 192/256: f32 {errs['float32']:.3e}, bf16 {errs['bfloat16']:.3e}")
    print("[13] flash attention at the new archs' prefill shapes and train-step eval shapes (bf16)")
    for i, (key, arch, shape) in enumerate([("kernel", a, sh) for a, sh in NEW_SHAPES.items()]
                                           + [("train_kernel", a, sh) for a, sh in NEW_TRAIN_SHAPES.items()]):
        err = check_attention(shape, "bfloat16", seed=560 + i)
        kernel_ms, plain_ms, library_ms, bound_ms, bound_by = report_attention_times(arch, shape)
        out[key][arch] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    for arch in ("paligemma-3b", "nemotron-4-340b"):
        check_attention(NEW_SHAPES[arch], "float32", seed=580)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["serve"] = in_spawned_process(serve_new_worker)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = in_spawned_process(train_new_worker)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["smoke"] = new_smoke_vs_cpu()
    print(f"  phase 13 took {time.perf_counter() - phase_t0:.1f} s: serving {serve_s:.1f} s, training {train_s:.1f} "
          f"s, smoke configs {time.perf_counter() - t0:.1f} s")
    return out


# The experiments phase: the paper's experiment entry points of the port on
# the card.  The train CLI's --simulate at fig2's widths (m = 2000, d = 100,
# n = 50, R = 32, 2000 iterations; every controller x exp(1), Pareto: 10
# cells, 320 lanes) and a mixed grid at m = 400, d = 20 (sync and kasync x
# n 10, 20 x no fault and 10% sign flips x the weighted mean and the
# geometric median x Pflug, fixed k x exp(1), Pareto: 64 cells x R = 16,
# 1000 iterations; k0 = fixed k = 4, fig_async's K, at which K-async stays
# stable at the sync step 0.5/L where K = 1 diverges).  Each grid is held at
# R = 4, 300 iterations against the same CLI on the CPU at phase 8's bounds,
# the mixed grid's loss only below the loss at w = 0 (its sign-flip cells
# under the weighted mean may diverge: phase 10's hold).  Then the figure
# functions: fig1, fig_hetero at its size (5 cells x R = 32 x 12 000
# iterations) and fig3 cut to 500 iterations (the script's time limit)
# and one seed of its host
# loop, whose events a second are measured on the card and (over the same
# horizon) on the CPU; fig_hetero's cells at 300 iterations held card
# against CPU.  The CPU runs go to worker processes that overlap the card's.
SIM_FIG2 = ["--simulate", "--sim-m", "2000", "--sim-d", "100", "--n-workers", "50", "--replicas", "32",
            "--steps", "2000", "--sim-controllers", "pflug,fixed,variance_ratio,schedule,sketched_pflug",
            "--sim-stragglers", "exponential,pareto"]
SIM_MIXED = ["--simulate", "--sim-m", "400", "--sim-d", "20", "--n-workers", "20", "--steps", "1000",
             "--sim-mode", "sync,kasync", "--sim-fault", "none,sign_flip:0.1:0", "--sim-agg", "mean,geomedian",
             "--sim-n-grid", "10,20", "--k0", "4", "--fixed-k", "4"]
SIM_HOLD = ["--replicas", "4", "--steps", "300", "--sim-eval-every", "100"]
FIG3_SMOKE_ITERS, HETERO_HOLD_ITERS = 500, 300


def simulate_run(argv: list, eta, device: str, threads: int = 2):
    """`train --simulate` through `run_simulation` at ``eta`` (None: its
    own), its printed lines dropped; in a worker process for the CPU:
    ({label: (time, loss, k) numpy}, wall seconds, eta, the labels of the
    cells whose controller adapts from the gradients)."""
    import contextlib
    import io

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import train

    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import controller

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train.run_simulation(train.parse_args(argv + ["--device", device]), eta=eta)
    adaptive = {c.label for c in out["cases"] if isinstance(c.controller, (
        controller.PflugController, controller.SketchedPflugController, controller.VarianceRatioController))}
    return cells_of(out["result"]), time.perf_counter() - t0, out["eta"], adaptive


def hetero_run(eta: float, t1_times: list, device: str, threads: int = 2):
    """fig_hetero's grid at HETERO_HOLD_ITERS in a worker process."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import figures

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    out = figures.hetero_grid(iters=HETERO_HOLD_ITERS, device=device, eta=eta, t1_times=t1_times)
    arrays = {lb: tuple(getattr(r, f).cpu().numpy() for f in ("time", "loss", "k")) for lb, r in out["results"].items()}
    return arrays, time.perf_counter() - t0


def fig3_async_rate(eta_async: float, horizon: float, device: str, threads: int = 2) -> dict:
    """One seed of fig3's host loop up to ``horizon`` in a worker process:
    its events, seconds and events a second."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import prng
    from repro_torch.core.straggler import Exponential
    from repro_torch.data import make_linreg_data
    from repro_torch.launch import figures

    torch.set_num_threads(threads)
    data = make_linreg_data(prng.PRNGKey(0, device=device), m=figures.FIG3["m"], d=figures.FIG3["d"], device=device)
    t0 = time.perf_counter()
    h = figures.async_host_loop(data, figures.FIG3["n"], eta_async, Exponential(rate=1.0), horizon,
                                prng.PRNGKey(2, device=device), figures.FIG3["async_eval_every"])
    seconds = time.perf_counter() - t0
    return {"events": h["updates"][-1], "seconds": seconds, "events_per_s": h["updates"][-1] / seconds,
            "final_loss": h["loss"][-1]}


def simulate_on_card(argv: list) -> dict:
    """`train.main` on the card, its lines captured: the header and the
    cell lines checked (one a cell, every clock finite, and the excess of
    every synchronous cell without a fault: the weighted mean under sign
    flips may diverge, as fig_byzantine's does, and so may stale updates
    under heavy tails), three of them printed."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = train.main(argv)
    wall = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    header, cells = lines[0], lines[1:]
    if header["grid_cells"] != len(cells) or [c["cell"] for c in cells] != list(out["result"].labels):
        raise AssertionError(f"--simulate printed {len(cells)} cell lines for {header['grid_cells']} cells")
    clean = [c for c in cells if ("--sim-fault" not in argv or "|none" in c["cell"])
             and not any(f"|{mode}" in c["cell"] for mode in ("kasync", "kbatch"))]
    if not all(math.isfinite(c["sim_time"]) for c in cells) or not all(math.isfinite(c["final_excess"])
                                                                     for c in clean):
        raise AssertionError("--simulate: a cell's time, or a fault-free cell's final excess, is not finite")
    diverged = [c["cell"] for c in cells if not math.isfinite(c["final_excess"])]
    print(f"  {json.dumps(header)} ({wall:.2f} s with the data and the cases; {len(diverged)} cells "
          f"diverged{': ' + ', '.join(diverged[:4]) if diverged else ''})")
    for c in cells[:3]:
        print(f"    {json.dumps(c)}")
    return out


def experiments_phase() -> dict:
    """Phase 14: `train --simulate` and the figure functions on the card,
    held against the CPU in worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core import prng
    from repro_torch.data import make_linreg_data
    from repro_torch.launch import figures

    phase_t0 = time.perf_counter()
    grids = {"fig2-width grid": SIM_FIG2, "mixed grid": SIM_MIXED}
    print(f"[14] experiments: train --simulate, {' and '.join(grids)}, each held at R=4, 300 iterations against "
          f"the CPU; fig1, fig_hetero, fig3 at {FIG3_SMOKE_ITERS} iterations")
    out = {}
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        held, jobs = {}, {}
        for name, argv in grids.items():  # the card's small runs first, so that the CPU's start early
            arrays, _, eta, adaptive = simulate_run(argv + SIM_HOLD, None, "cuda")
            held[name] = arrays, adaptive
            jobs[name] = pool.submit(simulate_run, argv + SIM_HOLD, eta, "cpu")
        hetero_card = figures.hetero_grid(iters=HETERO_HOLD_ITERS)
        jobs["fig_hetero"] = pool.submit(hetero_run, hetero_card["eta"], hetero_card["t1_times"], "cpu")
        # fig3's adaptive arm fixes its host loop's horizon: the CPU's seed starts now
        fig3_arm = figures.fig3_adaptive(iters=FIG3_SMOKE_ITERS)
        horizon = float(fig3_arm["stats"]["time_mean"][-1])
        jobs["fig3 async"] = pool.submit(fig3_async_rate, fig3_arm["eta"] / 10.0, horizon, "cpu")

        for name, argv in grids.items():
            print(f"  {name}: train.main({' '.join(argv)})")
            t0 = time.perf_counter()
            res = simulate_on_card(argv)
            out[name] = {"wall_s": time.perf_counter() - t0, "cells": len(res["cases"]),
                         "lanes": len(res["cases"]) * res["header"]["replicas"]}

        rows = {}
        for name, fn in (("fig1", figures.run_fig1), ("fig_hetero", figures.run_fig_hetero),
                         ("fig3", lambda: figures.run_fig3(iters=FIG3_SMOKE_ITERS, async_seeds=1))):
            t0 = time.perf_counter()
            rows[name] = fn()
            out[name] = {"wall_s": time.perf_counter() - t0}
            print(f"  {name}: {out[name]['wall_s']:.2f} s; {rows[name]['name']},{rows[name]['us_per_call']:.1f},"
                  f"{rows[name]['derived']}")
        runs = {name: job.result() for name, job in jobs.items()}

    rate = rows["fig3"]["async_rate"]
    if rate["horizon"] != horizon:
        raise AssertionError(f"fig3's adaptive arm ended at t = {rate['horizon']} in the figure, {horizon} alone")
    print(f"  fig3's host loop, one seed to t = {rate['horizon']:.2f}: {rate['events']} events in "
          f"{rate['seconds']:.2f} s on the card, {rate['events_per_s']:.1f} events/s; on the CPU (2 threads, a worker "
          f"process) {runs['fig3 async']['events']} events in {runs['fig3 async']['seconds']:.2f} s, "
          f"{runs['fig3 async']['events_per_s']:.1f} events/s")
    if runs["fig3 async"]["events"] != rate["events"]:
        raise AssertionError(f"fig3's host loop ran {rate['events']} events on the card, "
                             f"{runs['fig3 async']['events']} on the CPU")
    out["fig3"]["async_rate"] = {"card": rate["events_per_s"], "cpu": runs["fig3 async"]["events_per_s"],
                                 "events": rate["events"]}
    arrays, adaptive = held["fig2-width grid"]
    hold("fig2-width grid (R=4, 300 iterations) vs the CPU", arrays, runs["fig2-width grid"][0], adaptive)
    # the mixed grid's sign-flip cells under the weighted mean may diverge:
    # held as phase 10 holds fig_byzantine's, below the loss at w = 0
    y = make_linreg_data(prng.PRNGKey(0, device="cuda"), m=400, d=20, device="cuda").y
    arrays, adaptive = held["mixed grid"]
    hold_byzantine("mixed grid (R=4, 300 iterations) vs the CPU", arrays, runs["mixed grid"][0], adaptive,
                   bar=float((y * y).mean()), time_rtol=ENGINE_TIME_RTOL, loss_rtol=ENGINE_LOSS_RTOL)
    card_hetero = {lb: tuple(getattr(r, f).cpu().numpy() for f in ("time", "loss", "k"))
                   for lb, r in hetero_card["results"].items()}
    hold(f"fig_hetero at {HETERO_HOLD_ITERS} iterations vs the CPU", card_hetero, runs["fig_hetero"][0],
         {"adaptive", "adaptive_mixed"})
    print("  CPU runs in worker processes: " + ", ".join(
        f"{name} {runs[name][1]:.1f} s" for name in (*grids, "fig_hetero")))
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"  phase 14 took {out['phase_s']:.1f} s: " + ", ".join(
        f"{name} {v['wall_s']:.1f} s" for name, v in out.items() if isinstance(v, dict)))
    return out


# The distribution phase (15).  Blocked attention (`layers._sdpa_blocked`:
# the model's own online-softmax algorithm in plain PyTorch, not a kernel)
# at one llama3.2-3b layer, B=4, T=1024, against the naive path within the
# kernels' tolerances (PERF.md §2: 2e-5 f32, 2e-2 bf16, max |d| / max
# |out|), timed beside the naive path and the flash kernel.  Then the
# mesh, in two ways, since the card is one: a world of one NCCL rank in a
# spawned process (so that its process group does not outlive it), where
# every redistribute is a no-op, so the DTensor prefill gives the mesh-free
# logits bit for bit and the train step the mesh-free step's k and sim_time
# (its ce within MESH_CE_RTOL: the DTensor lookup's backward accumulates the
# embedding's gradient in another order); and four gloo ranks sharing the
# card (NCCL refuses two ranks on one GPU), each running its block of the
# grid's lanes on the card and gathering time, loss and k over gloo as
# CPU tensors.
BLOCKED_B, BLOCKED_T, BLOCKED_BLOCKS = 4, 1024, (1024, 256)
BLOCKED_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MESH_TRAIN_STEPS, MESH_CE_RTOL = 3, 1e-5
SWEEP_RANKS, SWEEP_MESHES, MIXED_PICK = 4, ((1, 4), (2, 2)), slice(None, None, 13)  # 5 of the 64 mixed cells
SWEEP_LOSS_RTOL = 1e-6
SIM_WORLD = ["--simulate", "--steps", "200", "--replicas", "4", "--sim-eval-every", "100", "--n-workers", "20"]
# The four-rank world's sharded train step: qwen1.5-0.5b smoke (vocab 512)
# on a ("data", "model") mesh, the vocab on "model" (the vocab-parallel
# CE), against the mesh-free step: k exact, ce within 1e-6.  Its DTensors
# are the host's: gloo cannot move CUDA DTensors on the card's torch (the
# first all-gather of a CUDA DTensor over gloo ends in SIGSEGV) and NCCL
# takes one rank a GPU; the world of one NCCL rank above runs the CE on
# CUDA DTensors.
VOCAB_TRAIN_ARCH, VOCAB_TRAIN_MESH, VOCAB_CE_RTOL = "qwen1.5-0.5b", (2, 2), 1e-6
# The reference's attention layouts.  The flash kernel's head pieces on a
# 16-way model axis at two archs' full-width prefill attention (B, T, S, H,
# KV, hd, causal, window), joined and held to the kernel on the whole
# tensor.  Then, in the four-rank world on the host's DTensors, two smoke
# archs on a (1, 4) mesh against the mesh-free run, with the prompt length
# of each: llama3.2-3b's 6 heads split the query sequence (124 positions
# take the naive path, the cache of 128 splits its sequence), qwen3-moe's 8
# split the heads (128 positions take the kernel's wrapper, its 2 kv heads
# sliced; a cache of 132 splits its sequence).  Logits within the serving
# tests' 1e-5, tokens equal; the train step's ce within 1e-6, k exact.
LAYOUT_PIECE_SHAPES = {"qwen3-moe-30b-a3b": (4, 1024, 1024, 32, 4, 64, True, 0),
                       "granite-moe-1b-a400m": (4, 1024, 1024, 16, 8, 64, True, 0)}
LAYOUT_EXTENT = 16
LAYOUT_MESH, LAYOUT_PROMPTS, LAYOUT_NEW_TOKENS = (1, 4), {"llama3.2-3b": 124, "qwen3-moe-30b-a3b": 128}, 4
LAYOUT_LOGITS_ATOL, LAYOUT_CE_RTOL = 1e-5, 1e-6
# The wkv scan in the reference's value-side layout: rwkv6-3b's 40 heads do
# not divide a 16-way model axis and its head dim does, so each rank scans V/16
# = 4 columns of every head (`ops.wkv6_piece`, the per-rank call of
# `_wkv6_sharded`), on the scalar route (the tensor-core one takes K = V =
# 64 only).  The 16 pieces at the prefill shape (phase 5's WKV_SLICE), in f32
# and bf16, joined and held to the whole call and to the plain version at
# WKV_TOL.
VALUE_PIECE_DTYPES = ("float32", "bfloat16")


def blocked_attention(counters) -> dict:
    """Phase 15a: blocked attention at one llama3.2-3b layer against the
    naive path, timed beside it and the flash kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("llama3.2-3b")
    gen = torch.Generator(device="cuda").manual_seed(15)
    p32 = layers.attention_init(gen, cfg.replace(param_dtype="float32"), "cuda")
    x32 = torch.randn((BLOCKED_B, BLOCKED_T, cfg.d_model), generator=gen, device="cuda")
    pos = torch.arange(BLOCKED_T, device="cuda")
    print(f"[15] blocked attention at one {cfg.arch_id} layer (B={BLOCKED_B}, T={BLOCKED_T}, H={cfg.n_heads}, "
          f"KV={cfg.n_kv_heads}, hd={cfg.resolved_head_dim}, causal), blocks {BLOCKED_BLOCKS}, against the naive path")
    out = {}
    for dt in ("float32", "bfloat16"):
        p = {k: v.to(getattr(torch, dt)) for k, v in p32.items()}
        x = x32.to(getattr(torch, dt))
        plain = cfg.replace(use_kernels=False)
        with torch.no_grad():
            naive = layers.attention_full(p, plain, x, pos)
            row = {"naive_ms": cuda_ms(lambda: layers.attention_full(p, plain, x, pos), iters=5, warmup=1)}
            reset_counts(counters)
            kern = layers.attention_full(p, cfg, x, pos)
            if counters["flash_attention"].launches != 1:
                raise AssertionError("the kernel path did not launch flash attention")
            row["kernel_ms"] = cuda_ms(lambda: layers.attention_full(p, cfg, x, pos), iters=5, warmup=1)
            row["kernel_gap"] = rel_gap(naive, kern)
            for blk in BLOCKED_BLOCKS:
                bcfg = plain.replace(attention_impl="blocked", attention_block=blk)
                gap = rel_gap(naive, layers.attention_full(p, bcfg, x, pos))
                ms = cuda_ms(lambda: layers.attention_full(p, bcfg, x, pos), iters=5, warmup=1)
                row[blk] = {"gap": gap, "ms": ms}
                if not gap < BLOCKED_TOL[dt]:
                    raise AssertionError(f"blocked attention ({dt}, block {blk}) differs from the naive path by "
                                         f"{gap:.3e} of its max (> {BLOCKED_TOL[dt]})")
        print(f"  {dt}: naive {row['naive_ms']:.3f} ms, flash kernel {row['kernel_ms']:.3f} ms (gap "
              f"{row['kernel_gap']:.3e}), " + ", ".join(
                  f"blocked {b}: {row[b]['ms']:.3f} ms, gap {row[b]['gap']:.3e}" for b in BLOCKED_BLOCKS)
              + f" (bound {BLOCKED_TOL[dt]}; a layer: the projections and the attention)")
        out[dt] = row
        del p, x, naive, kern
    torch.cuda.empty_cache()
    return out


def mesh_world1_worker(store: str) -> dict:
    """Phase 15b in a process of its own: a world of one NCCL rank and its
    (1, 1) ("data", "model") mesh; llama3.2-3b's prefill at full width with
    DTensor parameters against the mesh-free prefill, then three sync train
    steps at phase 11's recipe, mesh-free and then on the mesh."""
    counters = _worker_counters()
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import convert
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import serve, sharding, steps
    from repro_torch.models import build_model

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        cfg = get_config("llama3.2-3b")
        b, t = 4, 1024
        model = build_model(cfg, "cuda")
        params = convert.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        prompts = serve.random_prompts(cfg, b, t, seed=1)
        shape = InputShape("prefill", t, b, "prefill")
        free_step, mesh_step = steps.make_prefill_step(model, cfg, shape), steps.make_prefill_step(model, cfg, shape,
                                                                                                      mesh=mesh)
        free_logits, _ = free_step(params, {"tokens": prompts})
        placed = sharding.place_state(params, mesh)
        reset_counts(counters)
        logits, cache = mesh_step(placed, {"tokens": prompts})
        launches = counters["flash_attention"].launches
        logits = logits.full_tensor()
        gap = float((logits - free_logits).abs().max())
        placements = {k: [str(p) for p in v.placements] for k, v in cache.items()}
        del cache
        free_ms = cuda_ms(lambda: free_step(params, {"tokens": prompts}), iters=3, warmup=1)
        mesh_ms = cuda_ms(lambda: mesh_step(placed, {"tokens": prompts}), iters=3, warmup=1)
        print(f"  world of 1 NCCL rank, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {cfg.arch_id} prefill "
              f"(B={b}, T={t}) with DTensor parameters: {launches} flash-attention launches through the wrapper's "
              f"local-shard path (expected {cfg.n_layers}); max |dlogits| against the mesh-free prefill {gap:.3e} "
              f"(bitwise: {gap == 0.0}); {mesh_ms:.1f} ms against {free_ms:.1f} ms mesh-free; cache {placements}",
              flush=True)
        if launches != cfg.n_layers or counters["wkv6"].launches != 0:
            raise AssertionError(f"expected {cfg.n_layers} flash launches on the mesh, got {launches}")
        if not gap <= 1e-6 * float(free_logits.abs().max()):
            raise AssertionError(f"the mesh prefill's logits differ from the mesh-free ones by {gap:.3e}")
        del params, placed, logits, free_logits, model
        torch.cuda.empty_cache()

        t_cfg = {**TRAIN, "steps": MESH_TRAIN_STEPS}
        runs = {}
        for name, m in (("mesh-free", None), ("mesh", mesh)):
            ce_calls, restore = counting_vocab_parallel_ce()
            try:
                run = train_full_width("15", "llama3.2-3b", t_cfg, counters, mesh=m)
            finally:
                restore()
            runs[name] = {"rows": run.rows, "secs": run.secs, "per_step": run.per_step, "peak_gb": run.peak_gb,
                          "step_ms": 1e3 * sum(run.secs[1:]) / len(run.secs[1:]), "ce_calls": len(ce_calls)}
            del run
            torch.cuda.empty_cache()
        free, on = runs["mesh-free"], runs["mesh"]
        for i, ((ce, k, st), (fce, fk, fst), sec) in enumerate(zip(on["rows"], free["rows"], on["secs"])):
            print(f"  step {i} on the mesh: ce {ce:.6f} (mesh-free {fce:.6f}), k {k} ({fk}), sim_time {st:.4f} "
                  f"({fst:.4f}), {sec * 1e3:.1f} ms" + (" (untimed: first step)" if i == 0 else ""))
            if k != fk or st != fst or not abs(ce - fce) <= MESH_CE_RTOL * abs(fce):
                raise AssertionError(f"step {i} on the mesh: (ce, k, sim_time) {(ce, k, st)} against the mesh-free "
                                     f"{(fce, fk, fst)} (ce rtol {MESH_CE_RTOL})")
        if any(n != cfg.n_layers for n in on["per_step"]):
            raise AssertionError(f"expected {cfg.n_layers} flash launches a step on the mesh, got {on['per_step']}")
        print(f"  the CE on CUDA DTensors, the vocab on 'model': {on['ce_calls']} vocab-parallel calls on the mesh "
              f"({free['ce_calls']} mesh-free)", flush=True)
        if not on["ce_calls"] or free["ce_calls"]:
            raise AssertionError(f"vocab-parallel CE calls {on['ce_calls']} on the mesh, {free['ce_calls']} mesh-free")
        print(f"  {on['step_ms']:.1f} ms a step on the mesh against {free['step_ms']:.1f} ms mesh-free (mean of steps "
              f"1-{MESH_TRAIN_STEPS - 1}); peak memory {on['peak_gb']:.2f} GB against {free['peak_gb']:.2f} GB; "
              f"flash launches a step {on['per_step']}", flush=True)
        return {"prefill_gap": gap, "prefill_launches": launches, "prefill_ms": mesh_ms, "free_prefill_ms": free_ms,
                "step_ms": on["step_ms"], "free_step_ms": free["step_ms"], "peak_gb": on["peak_gb"],
                "free_peak_gb": free["peak_gb"], "rows": on["rows"], "train_launches": on["per_step"]}
    finally:
        sys.stdout.flush()
        dist.destroy_process_group()


def _sweep_world_rank(rank: int, world: int, store: str, out_dir: str, eta: float) -> None:
    """Phase 15c on one of SWEEP_RANKS gloo ranks sharing the card."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = _sweep_world_body(rank, eta)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        sys.stdout.flush()
        dist.barrier()
        dist.destroy_process_group()


def _sweep_world_body(rank: int, eta: float) -> dict:
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import prng
    from repro_torch.core.sweep import run_sweep, sweep_cache_stats
    from repro_torch.data import make_linreg_data
    from repro_torch.launch import quickstart, train

    data, keys = quickstart.inputs("fig2", device="cuda")
    fig2 = quickstart.cases("fig2", data, eta)
    other = [dataclasses.replace(c, eta=eta * 0.8, controller=dataclasses.replace(
        c.controller, **({"k": c.controller.k - 5} if hasattr(c.controller, "k") else {"k0": 5}))) for c in fig2]
    cfg = quickstart.SETUPS["fig2"]

    def fig2_grid(cases, mesh, partition="auto"):
        return run_sweep(quickstart.squared_error, torch.zeros(cfg["d"], device="cuda"), data.X, data.y,
                         n_workers=cfg["n"], cases=cases, num_iters=ENGINE_ITERS, keys=keys,
                         eval_every=cfg["eval_every"], device="cuda", mesh=mesh, partition=partition)

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def arrays(res):
        return tuple(getattr(res, f).cpu().numpy() for f in ("time", "loss", "k"))

    out = {}
    for shape in SWEEP_MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("cells", "replicas"))
        res, wall = timed(lambda: fig2_grid(fig2, mesh))
        out[shape] = {"fig2": arrays(res), "wall": wall}
    # the first mesh's grid repopulated: other eta and k, the same program
    before = sweep_cache_stats()["traces"]
    repop, repop_wall = timed(lambda: fig2_grid(other, init_device_mesh("cpu", SWEEP_MESHES[0],
                                                                        mesh_dim_names=("cells", "replicas"))))
    out["repop"] = {"grid": arrays(repop), "wall": repop_wall, "new_captures": sweep_cache_stats()["traces"] - before}

    args = train.parse_args(SIM_MIXED + ["--device", "cuda"])
    mdata = make_linreg_data(prng.PRNGKey(args.seed, device="cuda"), m=args.sim_m, d=args.sim_d, device="cuda")
    mixed = train.simulation_cases(args, quickstart.step_size(mdata.X))[MIXED_PICK]
    n_slots = max(train._n_values(args))

    def mixed_grid(mesh, partition="auto"):
        return run_sweep(quickstart.squared_error, torch.zeros(args.sim_d, device="cuda"), mdata.X, mdata.y,
                         n_workers=n_slots, cases=mixed, num_iters=args.steps,
                         key=prng.PRNGKey(args.seed + 1, device="cuda"), n_replicas=args.replicas,
                         eval_every=args.sim_eval_every, device="cuda", mesh=mesh, partition=partition)

    res, wall = timed(lambda: mixed_grid(init_device_mesh("cpu", (2, 2), mesh_dim_names=("cells", "replicas"))))
    out["mixed"] = {"grid": arrays(res), "wall": wall, "labels": [c.label for c in mixed],
                    "lanes": len(mixed) * args.replicas, "iters": args.steps, "bar": float((mdata.y * mdata.y).mean())}

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(SIM_WORLD + ["--device", "cuda"])
    out["simulate"] = buf.getvalue()
    out["train"] = _vocab_parallel_train_step()
    out["layouts"] = _layout_world_checks()
    if rank == 0:  # the one-device grids, after the timed runs
        out["fig2_one"] = arrays(fig2_grid(fig2, None, "none"))
        out["repop_one"] = arrays(fig2_grid(other, None, "none"))
        out["mixed_one"] = arrays(mixed_grid(None, "none"))
    return out


def counting_vocab_parallel_ce():
    """Wraps `model._nll_vocab_parallel` to count its calls: (calls, restore)."""
    from repro_torch.models import model as model_lib

    inner, calls = model_lib._nll_vocab_parallel, []

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    model_lib._nll_vocab_parallel = counted
    return calls, lambda: setattr(model_lib, "_nll_vocab_parallel", inner)


def _vocab_parallel_train_step() -> dict:
    """Phase 15d on each rank of the four-rank world: one sync train step
    of VOCAB_TRAIN_ARCH smoke (batch 8 x 32, Pflug, SGD with momentum, a
    comm model; seed-0 weights) mesh-free, then on VOCAB_TRAIN_MESH with
    the parameters and the batch as DTensors (the host's, see
    VOCAB_TRAIN_MESH); the metrics of both and the number of
    vocab-parallel CE calls in each."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import aggregation, controller, prng, straggler
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import optimizers

    cfg = get_smoke_config(VOCAB_TRAIN_ARCH)
    model = build_model(cfg, "cpu")
    mesh = init_device_mesh("cpu", VOCAB_TRAIN_MESH, mesh_dim_names=("data", "model"))
    tokens, targets = TokenStream(cfg.vocab_size, 32, 8, seed=0, device="cpu").batch_at(0)
    out = {}
    for name, m in (("mesh-free", None), ("mesh", mesh)):
        params = convert.init(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = optimizers.sgd(0.3, momentum=0.9)
        ctrl = controller.get_controller("pflug", 4, k0=1, step=1, thresh=0, burnin=0)
        state = steps.init_train_state(opt, ctrl, params, mesh=m)
        step = steps.make_train_step(model, opt, ctrl, straggler.Exponential(rate=1.0), 4,
                                     aggregation.CommModel(0.1, 0.05), mesh=m)
        calls, restore = counting_vocab_parallel_ce()
        try:
            _, metrics = step(state, {"tokens": tokens, "targets": targets}, prng.PRNGKey(7))
        finally:
            restore()
        out[name] = {k: float(v) for k, v in metrics.items()}
        out[f"{name}_ce_calls"] = len(calls)
    out["lm_head"] = [str(p) for p in state.params["lm_head"].placements]
    return out


def hold_vocab_train(ranks) -> dict:
    """Phase 15d's check: k exact and ce within VOCAB_CE_RTOL of the
    mesh-free step, every rank the same metrics, the CE vocab-parallel."""
    zero = ranks[0]["train"]
    free, on = zero["mesh-free"], zero["mesh"]
    gap = abs(on["ce"] - free["ce"]) / abs(free["ce"])
    print(f"  {VOCAB_TRAIN_ARCH} smoke, one sync train step on ('data', 'model') {VOCAB_TRAIN_MESH} of the host's DTensors "
          f"(lm_head {zero['lm_head']}): ce {on['ce']:.8f} against {free['ce']:.8f} mesh-free (relative gap "
          f"{gap:.3e}, bound {VOCAB_CE_RTOL}), k {int(on['k'])} ({int(free['k'])}); vocab-parallel CE calls "
          f"{zero['mesh_ce_calls']} on the mesh, {zero['mesh-free_ce_calls']} mesh-free", flush=True)
    if int(on["k"]) != int(free["k"]) or not gap <= VOCAB_CE_RTOL:
        raise AssertionError(f"the sharded train step: {on} against the mesh-free {free}")
    if not zero["mesh_ce_calls"] or zero["mesh-free_ce_calls"]:
        raise AssertionError(f"vocab-parallel CE calls: {zero['mesh_ce_calls']} on the mesh, "
                             f"{zero['mesh-free_ce_calls']} mesh-free")
    if any(r["train"]["mesh"] != on for r in ranks[1:]):
        raise AssertionError("the ranks' sharded train steps disagree")
    return {"ce": on["ce"], "free_ce": free["ce"], "gap": gap, "k": int(on["k"])}


def layout_pieces() -> dict:
    """Phase 15e: the flash kernel on every rank's head piece of a
    LAYOUT_EXTENT-way model axis (`ops.flash_attention_piece`: the local
    tensors a rank holds, through the per-rank step that
    `_flash_attention_sharded` runs), all on the one card, joined
    along the heads and held to the kernel on the whole tensor; the pieces'
    time beside the whole call's."""
    import torch
    from repro_torch.kernels.attention import ops

    out = {}
    for arch, shape in LAYOUT_PIECE_SHAPES.items():
        row = {"launches": 0}
        for dt in ("float32", "bfloat16"):
            q, k, v = attention_inputs(shape, getattr(torch, dt), seed=17)
            whole = ops.flash_attention(q, k, v, causal=True)
            before = ops.launches
            joined = torch.cat([ops.flash_attention_piece(q, k, v, r, LAYOUT_EXTENT) for r in range(LAYOUT_EXTENT)],
                               dim=2)
            torch.cuda.synchronize()
            launched = ops.launches - before
            row["launches"] += launched
            o, p = joined.float(), whole.float()
            err = (o - p).abs().max().item()
            bitwise = bool(torch.equal(joined, whole))
            tol = TOL[dt]
            ok = bitwise or bool(((o - p).abs() <= tol + tol * p.abs()).all())
            pieces_ms = cuda_ms(lambda: [ops.flash_attention_piece(q, k, v, r, LAYOUT_EXTENT)
                                         for r in range(LAYOUT_EXTENT)], iters=5, warmup=1)
            whole_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), iters=5, warmup=1)
            h, kv = shape[3], shape[4]
            print(f"  {arch} prefill heads {shape} {dt}: {LAYOUT_EXTENT} pieces of {h // LAYOUT_EXTENT} q heads "
                  f"over {max(1, kv // LAYOUT_EXTENT) if kv % LAYOUT_EXTENT == 0 else 1} kv head(s), {launched} "
                  f"launches, joined against the whole call: {'bitwise' if bitwise else f'max_abs_err {err:.3e}'} "
                  f"(atol=rtol={tol}); the 16 pieces {pieces_ms:.4f} ms on one card against {whole_ms:.4f} ms whole")
            if launched != LAYOUT_EXTENT or not ok:
                raise AssertionError(f"{arch} {dt}: the head pieces ({launched} launches) differ from the whole "
                                     f"kernel by {err:.3e}")
            row[dt] = {"bitwise": bitwise, "max_abs_err": err, "pieces_ms": pieces_ms, "whole_ms": whole_ms}
            del q, k, v, whole, joined
        out[arch] = row
    torch.cuda.empty_cache()
    return out


def value_pieces() -> dict:
    """Phase 15f: the wkv kernel on each rank's V piece of a
    LAYOUT_EXTENT-way model axis at rwkv6-3b's prefill shape, all on the
    one card, joined along V and held to the whole call (the tensor-core
    route; and the scalar route, the pieces' own, where the run says whether
    it is bitwise) and to the plain version on the whole tensor; the
    pieces' time beside the whole call's on either route."""
    import torch
    from repro_torch.kernels.wkv import kernel, ops, ref

    out = {"launches": 0}
    for dt in VALUE_PIECE_DTYPES:
        case = WKV_SLICE[:7] + (dt,)
        r, k, v, w, u, _ = wkv_inputs(case, seed=19)  # a prefill: no s0
        chunk = case[5]
        pieces = lambda: [ops.wkv6_piece(r, k, v, w, u, None, j, LAYOUT_EXTENT, chunk=chunk)  # noqa: E731
                          for j in range(LAYOUT_EXTENT)]
        before = ops.route_launches["wkv6"]
        joined = [torch.cat(parts, dim=-1) for parts in zip(*pieces())]
        torch.cuda.synchronize()
        launched = ops.route_launches["wkv6"] - before
        out["launches"] += launched
        whole = ops.wkv6(r, k, v, w, u, None, chunk=chunk)
        scalar = kernel.wkv6_bthk(r, k, v, w, u, None, chunk=chunk, kernel="wkv6")
        plain = ref.wkv6_ref(r, k, v, w, u, None, chunk=chunk)
        atol, rtol = WKV_TOL[dt]
        errs, ok = {}, launched == LAYOUT_EXTENT
        for label, want in (("whole", whole), ("scalar", scalar), ("plain", plain)):
            errs[label] = max((o - p).abs().max().item() for o, p in zip(joined, want))
            ok = ok and all(bool(torch.isfinite(o).all()) and bool(((o - p).abs() <= atol + rtol * p.abs()).all())
                            for o, p in zip(joined, want))
        bitwise = all(bool(torch.equal(o, p)) for o, p in zip(joined, scalar))
        pieces_ms = cuda_ms(pieces, iters=5, warmup=1)
        whole_ms = cuda_ms(lambda: ops.wkv6(r, k, v, w, u, None, chunk=chunk), iters=20, warmup=3)
        scalar_ms = cuda_ms(lambda: kernel.wkv6_bthk(r, k, v, w, u, None, chunk=chunk, kernel="wkv6"), iters=5,
                            warmup=1)
        print(f"  rwkv6-3b prefill wkv {case} {dt}: {LAYOUT_EXTENT} pieces of V = {case[4] // LAYOUT_EXTENT} "
              f"[wkv6], {launched} launches, joined against the whole call [wkv6_sm90] max_abs_err "
              f"{errs['whole']:.3e}, against the scalar route's whole call "
              f"{'bitwise' if bitwise else 'max_abs_err %.3e' % errs['scalar']}, against the plain version "
              f"{errs['plain']:.3e} (atol {atol}, rtol {rtol}); the {LAYOUT_EXTENT} pieces {pieces_ms:.4f} ms on "
              f"one card against the whole call's {whole_ms:.4f} ms [wkv6_sm90] and {scalar_ms:.4f} ms [wkv6]")
        if not ok:
            raise AssertionError(f"wkv6 {dt}: the V pieces ({launched} launches) differ from the whole call: {errs}")
        out[dt] = {"bitwise_scalar": bitwise, "max_abs_err": errs, "pieces_ms": pieces_ms, "whole_ms": whole_ms,
                   "whole_scalar_ms": scalar_ms}
        del r, k, v, w, u, joined, whole, scalar, plain
    torch.cuda.empty_cache()
    return out


def _layout_world_checks() -> dict:
    """Phase 15f on each rank of the four-rank world: each arch of
    LAYOUT_PROMPTS (smoke, seed-0 weights) generating LAYOUT_NEW_TOKENS
    tokens from a batch of 4 prompts and taking one sync train step at
    `_vocab_parallel_train_step`'s recipe, mesh-free and on a
    LAYOUT_MESH ("data", "model") mesh of the host's DTensors; returns
    both runs' prefill logits, tokens and metrics, and the (function,
    local q shape) of every attention piece the mesh runs took."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import aggregation, controller, prng, straggler
    from repro_torch.data import TokenStream
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model, layers
    from repro_torch.optim import optimizers
    from repro_torch.shardctx import is_dtensor

    mesh = init_device_mesh("cpu", LAYOUT_MESH, mesh_dim_names=("data", "model"))
    pieces = set()
    spied = {(layers, "_sdpa"): 1, (layers, "_sdpa_decode_partial"): 0, (ops, "flash_attention"): 0}
    saved = {key: getattr(*key) for key in spied}

    def spy(name, fn, qi):
        def run(*args, **kwargs):
            if not is_dtensor(args[qi]):
                pieces.add((name, tuple(args[qi].shape)))
            return fn(*args, **kwargs)

        return run

    out = {}
    for arch, t in LAYOUT_PROMPTS.items():
        cfg = get_smoke_config(arch)
        model = build_model(cfg, "cpu")
        prompts = serve.random_prompts(cfg, 4, t, 1, "cpu")
        tokens, targets = TokenStream(cfg.vocab_size, 32, 8, seed=0, device="cpu").batch_at(0)
        res = {}
        for name, m in (("mesh-free", None), ("mesh", mesh)):
            params = convert.init(cfg, torch.Generator().manual_seed(0), "cpu")  # the step updates it in place
            pieces.clear()
            for (mod, fn_name), qi in spied.items():
                if m is not None:
                    setattr(mod, fn_name, spy(fn_name, saved[(mod, fn_name)], qi))
            try:
                gen = serve.generate(model, params, prompts, LAYOUT_NEW_TOKENS, mesh=m)
                opt = optimizers.sgd(0.3, momentum=0.9)
                ctrl = controller.get_controller("pflug", 4, k0=1, step=1, thresh=0, burnin=0)
                state = steps.init_train_state(opt, ctrl, params, mesh=m)
                step = steps.make_train_step(model, opt, ctrl, straggler.Exponential(rate=1.0), 4,
                                             aggregation.CommModel(0.1, 0.05), mesh=m)
                _, metrics = step(state, {"tokens": tokens, "targets": targets}, prng.PRNGKey(7))
            finally:
                for key, fn in saved.items():
                    setattr(*key, fn)
            res[name] = {"prefill_logits": gen.prefill_logits, "tokens": gen.tokens,
                         "metrics": {k: float(v) for k, v in metrics.items()}}
        res["pieces"] = sorted(pieces)
        out[arch] = res
    return out


def hold_layouts(ranks) -> dict:
    """Phase 15f's check: on every rank the mesh's logits within
    LAYOUT_LOGITS_ATOL of the mesh-free run's, the tokens equal, k exact
    and ce within LAYOUT_CE_RTOL; rank 0's pieces printed."""
    import torch

    out = {}
    for arch in LAYOUT_PROMPTS:
        worst = {"logits": 0.0, "ce": 0.0}
        for r in ranks:
            free, on = (r["layouts"][arch][name] for name in ("mesh-free", "mesh"))
            fm, om = free["metrics"], on["metrics"]
            worst["logits"] = max(worst["logits"], (on["prefill_logits"] - free["prefill_logits"]).abs().max().item())
            worst["ce"] = max(worst["ce"], abs(om["ce"] - fm["ce"]) / abs(fm["ce"]))
            if not (torch.equal(on["tokens"], free["tokens"]) and int(om["k"]) == int(fm["k"])):
                raise AssertionError(f"{arch} on {LAYOUT_MESH}: tokens or k differ from the mesh-free run")
        zero = ranks[0]["layouts"][arch]
        print(f"  {arch} smoke on ('data', 'model') {LAYOUT_MESH} of the host's DTensors, prompt "
              f"{LAYOUT_PROMPTS[arch]}: prefill logits within {worst['logits']:.3e} of mesh-free (atol "
              f"{LAYOUT_LOGITS_ATOL}), {LAYOUT_NEW_TOKENS} tokens equal on every rank; a train step's ce "
              f"{zero['mesh']['metrics']['ce']:.8f} (relative gap {worst['ce']:.3e}, bound {LAYOUT_CE_RTOL}), k "
              f"{int(zero['mesh']['metrics']['k'])}; rank 0's attention pieces (function, local q): {zero['pieces']}",
              flush=True)
        if not (worst["logits"] <= LAYOUT_LOGITS_ATOL and worst["ce"] <= LAYOUT_CE_RTOL):
            raise AssertionError(f"{arch} on {LAYOUT_MESH}: {worst}")
        out[arch] = {**worst, "pieces": zero["pieces"]}
    return out


def hold_lanes(what: str, got: tuple, want: tuple, bar: float = math.inf,
               loss_rtol: float = SWEEP_LOSS_RTOL) -> str:
    """time and k bitwise per lane, the loss within ``loss_rtol`` where the
    one-device grid's loss is below ``bar`` (a diverging lane, past the loss
    at w = 0, amplifies a rounding step by step: its gap is reported, not
    held, as phase 10 holds fig_byzantine's); returns a line that says what
    was equal."""
    import numpy as np

    (gt, gl, gk), (wt, wl, wk) = got, want
    if not (np.array_equal(gt, wt) and np.array_equal(gk, wk)):
        bad = np.argwhere((gt != wt) | (gk != wk))
        raise AssertionError(f"{what}: time or k differ from the one-device grid at (cell, replica, eval) "
                             f"{bad[:4].tolist()}")
    fin = np.isfinite(wl)
    if not np.array_equal(np.isfinite(gl), fin) or not np.array_equal(gl[~fin], wl[~fin]):
        raise AssertionError(f"{what}: the loss is not finite where the one-device grid's is, or differs there")
    rel = np.abs(gl - wl) / np.maximum(np.abs(wl), 1e-30)
    held = fin & (wl < bar)
    gap = float(np.max(rel[held], initial=0.0))
    past = float(np.max(rel[fin & ~held], initial=0.0))
    by_cell = ", ".join(f"{float(np.max(rel[g][held[g]], initial=0.0)):.2e}" for g in range(wl.shape[0]))
    if not gap <= loss_rtol:
        raise AssertionError(f"{what}: loss differs from the one-device grid by {gap:.3e} (> {loss_rtol}); by cell "
                             f"{by_cell}")
    line = (f"time and k bitwise; loss {'bitwise' if gap == 0.0 else f'within {gap:.3e}'} at {int(held.sum())} "
            f"eval points (bound {loss_rtol}; by cell {by_cell})")
    if held.sum() < fin.sum():
        line += f", {int(fin.sum() - held.sum())} past the divergence bar {bar:.4g} within {past:.3e} (reported)"
    return line


def sweep_world(eta: float) -> dict:
    """Phase 15c: SWEEP_RANKS gloo ranks sharing the card."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    print(f"[15] {SWEEP_RANKS} gloo ranks sharing the card: fig2's grid ({ENGINE_ITERS} iterations) on "
          f"('cells', 'replicas') meshes {list(SWEEP_MESHES)}, repopulated; 5 cells of phase 14's mixed grid on "
          f"(2, 2); each against the one-device grid", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_sweep_world_rank, args=(SWEEP_RANKS, f"{tmp}/store", tmp, eta), nprocs=SWEEP_RANKS,
                           start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(SWEEP_RANKS)]
    zero = ranks[0]
    bitwise = {}
    for shape in SWEEP_MESHES:
        bitwise[shape] = hold_lanes(f"fig2 grid on {shape}", zero[shape]["fig2"], zero["fig2_one"])
        lanes = 160 // (shape[0] * shape[1])
        print(f"  fig2 grid on mesh {shape} ({lanes} lanes a rank): ms an iteration by rank "
              + ", ".join(f"{1e3 * r[shape]['wall'] / ENGINE_ITERS:.3f}" for r in ranks)
              + f" (capture and the gather included); against the one-device grid: {bitwise[shape]}")
    rp = zero["repop"]
    if any(r["repop"]["new_captures"] for r in ranks):
        raise AssertionError(f"the repopulated grid captured {[r['repop']['new_captures'] for r in ranks]} new "
                             "programs")
    bitwise["repop"] = hold_lanes("fig2 grid repopulated", rp["grid"], zero["repop_one"])
    print(f"  fig2 grid repopulated on {SWEEP_MESHES[0]} (other eta and k), no new capture: ms an iteration by rank "
          + ", ".join(f"{1e3 * r['repop']['wall'] / ENGINE_ITERS:.3f}" for r in ranks)
          + f" (the gather included); against the one-device grid: {bitwise['repop']}")
    for r in ranks[1:]:
        if any(not all(np.array_equal(a, b) for a, b in zip(r[k]["fig2" if k != "repop" else "grid"],
                                                             zero[k]["fig2" if k != "repop" else "grid"]))
               for k in (*SWEEP_MESHES, "repop")):
            raise AssertionError("the ranks gathered different grids")
    m = zero["mixed"]
    bitwise["mixed"] = hold_lanes("mixed grid on (2, 2)", m["grid"], zero["mixed_one"], bar=m["bar"],
                                  loss_rtol=ENGINE_LOSS_RTOL)
    print(f"  mixed grid, cells {m['labels']} ({m['lanes']} lanes, {m['iters']} iterations) on (2, 2), cells padded "
          f"5 -> 6: wall by rank " + ", ".join(f"{r['mixed']['wall']:.2f} s" for r in ranks)
          + f"; against the one-device grid: {bitwise['mixed']}")
    header = json.loads(zero["simulate"].splitlines()[0])
    if header["processes"] != SWEEP_RANKS or header["mesh_shape"] != [SWEEP_RANKS, 1] or any(
            r["simulate"] for r in ranks[1:]):
        raise AssertionError(f"train --simulate in the world printed {header} (and lines on other ranks)")
    print(f"  train --simulate ({' '.join(SIM_WORLD)}) in the world, rank 0's header: {json.dumps(header)}")
    train = hold_vocab_train(ranks)
    layouts = hold_layouts(ranks)
    print(f"  the world's wall time {wall:.1f} s, spawn and CUDA contexts included", flush=True)
    return {"ranks": [{str(s): {"ms_iter": 1e3 * r[s]["wall"] / ENGINE_ITERS, "wall": r[s]["wall"]}
                       for s in SWEEP_MESHES} for r in ranks], "bitwise": bitwise, "wall": wall, "header": header,
            "train": train, "layouts": layouts}


def distribution_phase(counters, eta: float) -> dict:
    """Phase 15: blocked attention, the world-1 mesh and the 4-rank sweep."""
    import tempfile

    import torch
    from repro_torch.core import montecarlo, sweep

    phase_t0 = time.perf_counter()
    # the earlier phases' programs hold CUDA-graph pools; the full-width run needs the card
    montecarlo.clear_program_cache()
    sweep.clear_sweep_cache()
    torch.cuda.empty_cache()
    print(f"[15] this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB of the card's memory before phase 15",
          flush=True)
    out = {"blocked": blocked_attention(counters)}
    print("[15] a world of one NCCL rank in a spawned process: llama3.2-3b prefill and train steps on DTensors",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out["world1"] = in_spawned_process(functools.partial(mesh_world1_worker, f"{tmp}/store"))
    print(f"[15] the flash kernel on each rank's head piece of a {LAYOUT_EXTENT}-way model axis, joined, against "
          f"the whole call", flush=True)
    out["pieces"] = layout_pieces()
    print(f"[15] the wkv kernel on each rank's V piece of a {LAYOUT_EXTENT}-way model axis (rwkv6-3b), joined, "
          f"against the whole call", flush=True)
    out["value_pieces"] = value_pieces()
    out["sweep"] = sweep_world(eta)
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"  phase 15 took {out['phase_s']:.1f} s")
    return out


# ----------------------------------------------------------------- phase 16
# The dry run, the roofline and the kernel cache (`launch/dryrun.py`,
# `roofline/`, `core/cache.py`).  The reference test's trio, each traced at
# full depth on a fake world in a process of its own (the process group is
# global), the card's program: fake CUDA tensors through the kernels' custom
# ops.  (arch, shape, multi-pod, what else the run must show)
DRYRUN_TRIO = [("qwen1.5-0.5b", "train_4k", False), ("llama3.2-3b", "decode_32k", True),
               ("rwkv6-3b", "long_500k", False)]
# One job per site of the sharded path that DTensor on the card's torch
# refused until the port ran it on local shards: the MoE dispatch's index
# work, the backward of the head-dim-sharded projection, rwkv's decay LoRA
# on (2, 16, 16), the SSM's decode step.  Traced beside the trio, at the
# depth below (None: full depth), each with counts > 0, no launch and the
# kernels' custom ops called where the step reaches them.
DRYRUN_REPAIRED = [("qwen3-moe-30b-a3b", "train_4k", False), ("hymba-1.5b", "train_4k", False),
                   ("rwkv6-3b", "prefill_32k", True), ("hymba-1.5b", "decode_32k", True)]
DRYRUN_REPAIRED_LAYERS = None
# Two jobs whose attention takes the reference's layouts: llama3.2-3b's 24
# heads do not divide the 16-way model axis, so its train step splits the
# query sequence, and its decode scores each rank's slots of the
# sequence-sharded cache.  The gathering decode moved 6.03e10 collective
# bytes a rank on the card's torch, of which the cache gathered twice a
# layer (a lost write's and the attention's gather) was 6.01e10;
# the decode must now move at least one gathered cache (28 layers x k and
# v of 8 rows x 32768 x 8 x 128 bf16, 3.01e10 bytes) less.
DRYRUN_LAYOUTS = [("llama3.2-3b", "decode_32k", False), ("llama3.2-3b", "train_4k", False)]
LLAMA_DECODE_COLL_GATHERED, LLAMA_DECODE_CACHE = 6.03e10, 28 * 2 * 8 * 32768 * 8 * 128 * 2
# qwen1.5-0.5b train_4k's all-gather bytes a rank while the CE gathered the
# vocab (163.6 GB, on the card's torch); the vocab-parallel CE must take at
# least 70 GB of it away
QWEN_AG_GATHERED, QWEN_AG_CUT = 163.6e9, 70e9
# The two scans in the reference's value-side layout: rwkv6-3b's 40 heads and
# hymba-1.5b's 25 do not divide the 16-way model axis and their head dim
# does, so each rank scans V/16 (P/16) columns of every head and the time mix
# and the SSM gather only their key side.  rwkv6-3b train_4k on 16x16 is
# traced beside the jobs above, of which hymba-1.5b train_4k and rwkv6-3b
# prefill_32k on 2x16x16 moved too.  {job: (all-gather bytes a rank with v and
# xs gathered, on the card's torch (NVIDIA H100 80GB HBM3, torch 2.11); the
# bytes of the gathers of v (xs) that the forward passes no longer make, a
# layer's whole bf16 v a rank in the step's forward and its eval forward, in
# the prefill's one forward less the final state it now gathers)}.  Each
# job's all-gather bytes must fall by at least SCAN_CUT_SHARE of that.
DRYRUN_SCANS = {("rwkv6-3b", "train_4k", False): (2.250755e11, 32 * 2 * 16 * 4096 * 2560 * 2),
                ("hymba-1.5b", "train_4k", False): (8.301481e10, 32 * 2 * 16 * 4096 * 1600 * 2),
                ("rwkv6-3b", "prefill_32k", True): (3.907516e10, 32 * (32768 * 2560 * 2 - 40 * 64 * 64 * 4))}
SCAN_CUT_SHARE = 0.9
# The traces are Python-bound (15-100 s each at full depth on the card's
# host); they start before phase 12 and run beside phases 12 and 13, whose
# work is on the card (beside phases 14 and 15 they slowed those phases'
# CPU workers).
DRYRUN_TIMEOUT_S = 600
# Phase 16's prefill: llama3.2-3b, batch 4 x prompt 1024, bf16 (phase 4's).
ROOFLINE_PREFILL = ("llama3.2-3b", 4, 1024)
# remat_policy "dots" against "full": one arch that fits either way.
REMAT_RUN = dict(arch="qwen1.5-0.5b", steps=2, lr=3e-4, n_workers=4, batch=8, seq=512)


def start_dryruns(out_dir: Path) -> list:
    """Start the trio's and the repaired jobs' dry runs (`python -m
    repro_torch.launch.dryrun`, the card's program) at low priority;
    returns [(job, popen, json, log)]."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    started = []
    jobs = DRYRUN_TRIO + DRYRUN_REPAIRED + DRYRUN_LAYOUTS
    for job in jobs + [j for j in DRYRUN_SCANS if j not in jobs]:
        arch, shape, pod = job
        name = f"{arch}__{shape}__{'pod2' if pod else 'base'}"
        out, log = out_dir / f"{name}.json", open(out_dir / f"{name}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--out", str(out)]
        if pod:
            cmd.append("--multi-pod")
        if job in DRYRUN_REPAIRED and DRYRUN_REPAIRED_LAYERS:
            cmd += ["--override", f"n_layers={DRYRUN_REPAIRED_LAYERS}"]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                                preexec_fn=lambda: os.nice(10))
        started.append((job, proc, out, log))
    return started


def stop_dryruns(started) -> None:
    for _, proc, _, log in started:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def finish_dryruns(started, t_started: float) -> dict:
    """Wait for the dry runs (at most DRYRUN_TIMEOUT_S from their start),
    print and check each result; returns {(arch, shape, multi-pod): result}."""
    out = {}
    try:
        for (arch, shape, pod), proc, path, log in started:
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t_started)
            try:
                rc = proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"the dry run of {arch} {shape} did not end within {DRYRUN_TIMEOUT_S} s")
            log.flush()
            if rc != 0 or not path.exists():
                tail = Path(log.name).read_text()[-3000:]
                raise AssertionError(f"the dry run of {arch} {shape} failed (exit {rc}):\n{tail}")
            r = json.loads(path.read_text())
            rl, am, mem, coll = r["roofline"], r["analytic_memory"], r["memory"], r["collectives"]
            print(f"  {arch} {shape} on {r['mesh']} ({r['n_devices']} fake ranks, {r['device']}, torch {r['torch']}): "
                  f"traced in {r['trace_s']} s; per rank {rl['flops']:.4e} FLOPs, {rl['bytes_accessed']:.4e} bytes, "
                  f"collective bytes {coll['total']:.4e} (all-reduce {coll['all-reduce']:.4e}, all-gather "
                  f"{coll['all-gather']:.4e}, reduce-scatter {coll['reduce-scatter']:.4e}, all-to-all "
                  f"{coll['all-to-all']:.4e}, permute {coll['collective-permute']:.4e}); memory: arguments "
                  f"{mem['argument_bytes'] / 1e9:.3f} GB, traced peak {mem['peak_bytes'] / 1e9:.3f} GB, analytic "
                  f"{am['total_bytes'] / 1e9:.3f} GB (state {am['state_bytes'] / 1e9:.3f}), fits 80 GB "
                  f"{am['fits_80gb']}; terms compute {rl['compute_s']:.4e} s, memory {rl['memory_s']:.4e} s, "
                  f"collective {rl['collective_s']:.4e} s, dominant {rl['dominant']}; useful-FLOP ratio "
                  f"{rl['useful_flops_ratio']:.4f}; kernel calls {r['kernel_calls']}, launches {r['kernel_launches']}")
            want_devices, want_mesh = (512, "2x16x16") if pod else (256, "16x16")
            if (r["n_devices"], r["mesh"], r["device"]) != (want_devices, want_mesh, "cuda"):
                raise AssertionError(f"{arch} {shape}: {r['n_devices']} ranks on {r['mesh']} ({r['device']})")
            if not (rl["flops"] > 0 and rl["bytes_accessed"] > 0 and coll["total"] > 0):
                raise AssertionError(f"{arch} {shape}: a count is 0: {rl}")
            if any(r["kernel_launches"].values()):
                raise AssertionError(f"{arch} {shape}: a fake trace launched a kernel: {r['kernel_launches']}")
            kernel = "wkv6" if arch.startswith("rwkv") else "flash_attention"
            checked = (arch, shape, pod) in DRYRUN_REPAIRED or (arch, shape, pod) in DRYRUN_SCANS
            if checked and shape != "decode_32k" and not r["kernel_calls"][kernel]:
                raise AssertionError(f"{arch} {shape}: the step traced no call of {kernel}: {r['kernel_calls']}")
            out[(arch, shape, pod)] = r
    finally:
        stop_dryruns(started)
    decode = out[DRYRUN_LAYOUTS[0]]["collectives"]
    print(f"  llama3.2-3b decode_32k on 16x16 moves {decode['total']:.4e} collective bytes a rank (all-gather "
          f"{decode['all-gather']:.4e}) against {LLAMA_DECODE_COLL_GATHERED:.4e} with the cache gathered: "
          f"{(LLAMA_DECODE_COLL_GATHERED - decode['total']) / 1e9:.2f} GB less (at least "
          f"{LLAMA_DECODE_CACHE / 1e9:.2f} GB required)")
    if not decode["total"] < LLAMA_DECODE_COLL_GATHERED - LLAMA_DECODE_CACHE:
        raise AssertionError(f"llama3.2-3b decode_32k moves {decode['total']:.4e} collective bytes a rank")
    for (arch, shape, pod), (before, cut) in DRYRUN_SCANS.items():
        ag = out[(arch, shape, pod)]["collectives"]["all-gather"]
        print(f"  {arch} {shape} on {'2x16x16' if pod else '16x16'} all-gathers {ag:.4e} bytes a rank with the "
              f"scan's value side sharded, against {before:.4e} with v (xs) gathered: {(before - ag) / 1e9:.3f} GB "
              f"less (at least {SCAN_CUT_SHARE * cut / 1e9:.3f} GB required)")
        if not ag < before - SCAN_CUT_SHARE * cut:
            raise AssertionError(f"{arch} {shape}: the value-side layout all-gathers {ag:.4e} bytes a rank")
    qwen, _, rwkv = (out[job] for job in DRYRUN_TRIO)
    if not qwen["analytic_memory"]["fits_80gb"]:
        raise AssertionError("qwen1.5-0.5b train_4k does not fit 80 GB by the analytic model")
    from repro_torch.configs import get_config

    if qwen["kernel_calls"]["flash_attention"] != get_config("qwen1.5-0.5b").n_layers:
        raise AssertionError(f"qwen1.5-0.5b train_4k's eval forward traced {qwen['kernel_calls']} kernel calls")
    ag = qwen["collectives"]["all-gather"]
    print(f"  qwen1.5-0.5b train_4k all-gathers {ag / 1e9:.2f} GB a rank with the vocab-parallel CE, against "
          f"{QWEN_AG_GATHERED / 1e9:.1f} GB with the vocab gathered: {(QWEN_AG_GATHERED - ag) / 1e9:.2f} GB less "
          f"(at least {QWEN_AG_CUT / 1e9:.0f} GB required)")
    if not ag < QWEN_AG_GATHERED - QWEN_AG_CUT:
        raise AssertionError(f"qwen1.5-0.5b train_4k all-gathers {ag:.4e} bytes a rank")
    if not rwkv["analytic_memory"]["total_bytes"] < 1e9:
        raise AssertionError(f"rwkv6-3b long_500k analytic total {rwkv['analytic_memory']['total_bytes']} >= 1e9")
    return out


def prefill_roofline(counters) -> dict:
    """llama3.2-3b's bf16 prefill (batch 4 x 1024) counted by
    `roofline.count_step` for real (the kernels launched) and on its fake
    twin (fake CUDA tensors through the custom ops): FLOPs and bytes held
    equal; the measured ms against the roofline bound; the analytic state
    bytes against the weights allocated."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.checkpoint import convert
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import serve, sharding
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import build_model
    from repro_torch.roofline import analysis, memory

    arch, b, t = ROOFLINE_PREFILL
    cfg = get_config(arch)
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = convert.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = serve.random_prompts(cfg, b, t, seed=1)
    weights = sum(p.numel() * p.element_size() for p in _leaves(params))
    reset_counts(counters)
    real = analysis.count_step(model.prefill, params, {"tokens": prompts})
    real_launches = counters["flash_attention"].launches
    with FakeTensorMode():
        fparams = convert.init(cfg, torch.Generator(device="cuda"), "cuda")
        ftokens = torch.empty(prompts.shape, dtype=prompts.dtype, device="cuda")
        fake = analysis.count_step(model.prefill, fparams, {"tokens": ftokens})
    fake_launches = counters["flash_attention"].launches - real_launches
    print(f"  {arch} prefill, batch {b} x {t}, bf16: real {real['flops']:.6e} FLOPs, {real['bytes accessed']:.6e} "
          f"bytes, kernel calls {real['kernel_calls']}, {real_launches} launches; fake twin {fake['flops']:.6e} FLOPs, "
          f"{fake['bytes accessed']:.6e} bytes, kernel calls {fake['kernel_calls']}, {fake_launches} launches; "
          f"traced peak {real['peak_bytes'] / 1e9:.3f} GB real, {fake['peak_bytes'] / 1e9:.3f} GB fake")
    if (real["flops"], real["bytes accessed"], real["kernel_calls"]) != (
            fake["flops"], fake["bytes accessed"], fake["kernel_calls"]):
        raise AssertionError(f"real and fake prefill counts differ: {real} vs {fake}")
    if real_launches != cfg.n_layers or fake_launches != 0:
        raise AssertionError(f"launches: real {real_launches} (expected {cfg.n_layers}), fake {fake_launches}")
    ms = cuda_ms(lambda: model.prefill(params, {"tokens": prompts}), iters=3, warmup=1)
    terms = analysis.roofline_terms(real, 0.0)
    bound_s = max(terms["compute_s"], terms["memory_s"])
    print(f"  prefill {ms:.2f} ms; roofline bound max(compute {terms['compute_s'] * 1e3:.3f} ms, memory "
          f"{terms['memory_s'] * 1e3:.3f} ms) = {bound_s * 1e3:.3f} ms; roofline share {bound_s * 1e3 / ms:.4f}")
    mesh = HostMesh(("data", "model"))
    shape = InputShape("prefill_4x1024", t, b, "prefill")
    am = memory.analytic_memory(cfg, shape, mesh, params, sharding.param_shardings(params, mesh))
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    print(f"  analytic memory: state {am['state_bytes'] / 1e9:.4f} GB (weights allocated {weights / 1e9:.4f} GB), "
          f"total {am['total_bytes'] / 1e9:.3f} GB; max_memory_allocated {peak / 1e9:.3f} GB; the card's total "
          f"{total / 1e9:.3f} GB (mem_get_info)")
    if am["state_bytes"] != weights:
        raise AssertionError(f"analytic state bytes {am['state_bytes']} != the weights allocated {weights}")
    del params, fparams
    torch.cuda.empty_cache()
    return {"flops": real["flops"], "bytes": real["bytes accessed"], "ms": ms, "bound_ms": bound_s * 1e3,
            "share": bound_s * 1e3 / ms}


def cache_probe() -> dict:
    """In a fresh process: the kernel cache from REPRO_COMPILATION_CACHE_DIR,
    every library built (or found), one flash-attention launch; returns the
    wall clock at that launch and the libraries compiled."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import cache
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops

    where = cache.maybe_enable_from_env()
    built = _build.build_all()
    q, k, v = attention_inputs(SLICE_SHAPE, torch.bfloat16, seed=5)
    ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    return {"first_launch": time.time(), "built": sorted(built), "dir": where}


def cache_check() -> dict:
    """Two fresh processes share a new REPRO_COMPILATION_CACHE_DIR: the
    first builds all four libraries, the second adds 0 entries."""
    import os
    import tempfile

    from repro_torch.core import cache

    out = {}
    with tempfile.TemporaryDirectory(prefix="repro-kernels-") as d:
        os.environ[cache.ENV_VAR] = d
        try:
            for run in ("cold", "warm"):
                before = cache.cache_entries(d)
                t0 = time.time()
                res = in_spawned_process(cache_probe)
                added = cache.cache_entries(d) - before
                out[run] = {"seconds": res["first_launch"] - t0, "added": added, "built": res["built"]}
                print(f"  {run} process: {res['first_launch'] - t0:.2f} s from start to the first launch; compiled "
                      f"{res['built']}; {added} entries added to {res['dir']}")
        finally:
            del os.environ[cache.ENV_VAR]
    from repro_torch.kernels import _build

    n_src = len(_build.sources())
    if out["cold"]["added"] != n_src or len(out["cold"]["built"]) != n_src:
        raise AssertionError(f"the cold process added {out['cold']['added']} entries for {n_src} sources")
    if out["warm"]["added"] != 0 or out["warm"]["built"]:
        raise AssertionError(f"the warm process compiled {out['warm']['built']} ({out['warm']['added']} entries)")
    return out


def remat_dots_check(counters) -> dict:
    """One full-width sync train step of REMAT_RUN's arch with
    remat_policy "dots" against "full": ms, peak GB, ce within 1e-5."""
    import torch

    t = dict(REMAT_RUN)
    arch = t.pop("arch")
    runs = {}
    for policy in ("full", "dots"):
        run = train_full_width("16", arch, t, counters, overrides={"remat": True, "remat_policy": policy})
        runs[policy] = {"ce": [r[0] for r in run.rows], "k": [r[1] for r in run.rows], "ms": run.secs[-1] * 1e3,
                        "first_ms": run.secs[0] * 1e3, "peak_gb": run.peak_gb}
        print(f"  remat_policy {policy}: steps (ce, k, sim_time) {run.rows}; {run.secs[-1] * 1e3:.1f} ms a step "
              f"(the first {run.secs[0] * 1e3:.1f}), peak {run.peak_gb:.2f} GB")
        del run
        torch.cuda.empty_cache()
    gap = max(abs(a - b) / abs(b) for a, b in zip(runs["dots"]["ce"], runs["full"]["ce"]))
    print(f"  dots vs full: ce max rel gap {gap:.3e} (bound 1e-5), k equal {runs['dots']['k'] == runs['full']['k']}")
    if not (gap <= 1e-5 and runs["dots"]["k"] == runs["full"]["k"]):
        raise AssertionError(f"remat_policy dots and full disagree: {runs}")
    return runs


def tooling_phase(counters, dryruns, t_dryruns: float) -> dict:
    """Phase 16: the dry-run trio's results, the prefill's roofline, the
    kernel cache across processes, remat_policy "dots"."""
    phase_t0 = time.perf_counter()
    print("[16] the dry run, the roofline and the kernel cache")
    print(f"[16] dry-run trio (full depth) and the repaired jobs ("
          f"{'full depth' if not DRYRUN_REPAIRED_LAYERS else f'{DRYRUN_REPAIRED_LAYERS} layers'}): the card's program "
          f"on fake CUDA tensors, fake worlds of 256 and 512 ranks")
    out = {"dryrun": finish_dryruns(dryruns, t_dryruns)}
    t_wait = time.perf_counter() - phase_t0
    print(f"[16] count_step on {ROOFLINE_PREFILL[0]}'s prefill, real and fake")
    out["prefill"] = prefill_roofline(counters)
    print("[16] the kernel cache (REPRO_COMPILATION_CACHE_DIR) across two fresh processes")
    out["cache"] = cache_check()
    print(f"[16] remat_policy dots against full, {REMAT_RUN['arch']} at full width")
    out["remat"] = remat_dots_check(counters)
    print(f"  phase 16 took {time.perf_counter() - phase_t0:.1f} s (waiting for the dry runs {t_wait:.1f} s)")
    return out


def prng_key(seed: int):
    from repro_torch.core import prng

    return prng.PRNGKey(seed, device="cuda")


def count_kernels(fn) -> int:
    """CUDA kernels (and memsets/copies) fn() launches, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if args not in ([], ["--only", "15"], ["--only", "16"]):
        print(f"usage: {Path(__file__).name} [--only 15|16]", file=sys.stderr)
        return 2
    only = args[1] if args else None

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: the port (src/repro_torch) is not beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.checkpoint import convert
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    script_t0 = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1] device: {kind}; count {torch.cuda.device_count()}; torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"[1] nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    for src in _build.sources():
        _build.load(src.stem)
    print(f"[2] built {[s.name for s in _build.sources()]} in {time.perf_counter() - t0:.1f}s "
          f"(one nvcc per source, in parallel)")
    for name, log in logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        if regs:
            print(f"    {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, "
                  f"spill stores up to {max(spills, default=0)} bytes")
        if name.startswith("flash_attn"):  # each head dim's instantiation: hd 192 and 256 are this slice's
            for hd, body in re.findall(r"Compiling entry function '[^']*kernelILi(\d+)EE[^']*'(.*?)(?=Compiling|\Z)",
                                       log, flags=re.S):
                lines = [ln.strip() for ln in body.splitlines() if "registers" in ln or "spill" in ln]
                print(f"      hd {hd}: {'; '.join(lines)}")
    sass = sass_counts(_build, "flash_attn_sm90", ("HGMMA", "UTMALDG"))
    print(f"[2] flash_attn_sm90 SASS (cuobjdump -sass): {sass}")
    if not all(sass.values()):
        raise AssertionError(f"the bf16 attention kernel lacks wgmma or TMA instructions: {sass}")
    wkv_sass = sass_counts(_build, "wkv6_sm90", ("HMMA", "HGMMA", "LDGSTS"))
    print(f"[2] wkv6_sm90 SASS (cuobjdump -sass): {wkv_sass}")
    if not all(wkv_sass.values()):
        raise AssertionError(f"the tensor-core wkv6 kernel lacks mma.sync, wgmma or cp.async instructions: {wkv_sass}")

    if only == "15":  # a check of phase 15 alone: no kernels line and no last line
        from repro_torch.launch import quickstart

        data, _ = quickstart.inputs("fig2", device="cuda")
        distribution_phase({"flash_attention": ops, "wkv6": wkv_ops}, quickstart.step_size(data.X))
        return 0
    dryrun_dir = ROOT / "results" / "torch" / "dryrun_trio"  # the trio's JSONs and logs
    dryrun_dir.mkdir(parents=True, exist_ok=True)
    if only == "16":  # a check of phase 16 alone: no kernels line and no last line
        tooling_phase({"flash_attention": ops, "wkv6": wkv_ops}, start_dryruns(dryrun_dir), time.perf_counter())
        return 0

    # 3. kernel vs plain
    print("[3] flash attention, kernel vs plain version (f32: scalar route; bf16: wgmma + TMA route)")
    for i, shape in enumerate(ATTN_SHAPES):
        for dt in ("float32", "bfloat16"):
            check_attention(shape, dt, seed=i)
    for i, shape in enumerate(RAGGED_SHAPES):
        check_attention(shape, "bfloat16", seed=50 + i)
    slice_err = check_attention(SLICE_SHAPE, "bfloat16", seed=100)
    check_attention(SLICE_WINDOW_SHAPE, "bfloat16", seed=101)
    check_attention(SLICE_SHAPE, "float32", seed=102)
    kernel_ms, plain_ms, library_ms, bound_ms, bound_by = report_attention_times("slice shape", SLICE_SHAPE)
    report_attention_times("window shape", SLICE_WINDOW_SHAPE)
    q32, k32, v32 = attention_inputs(SLICE_SHAPE, torch.float32, seed=7)
    f32_kernel = lambda: ops.flash_attention(q32, k32, v32, causal=True)  # noqa: E731
    f32_library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q32.transpose(1, 2), k32.transpose(1, 2), v32.transpose(1, 2), is_causal=True, enable_gqa=True)
    f32_ms_1 = cuda_ms(f32_kernel, iters=50, warmup=5)
    f32_library_ms = cuda_ms(f32_library, iters=50, warmup=5)
    f32_ms_2 = cuda_ms(f32_kernel, iters=50, warmup=5)
    f32_ms = (f32_ms_1 + f32_ms_2) / 2
    del q32, k32, v32
    f32_bound_ms, f32_bound_by, _ = attention_bound(SLICE_SHAPE, "float32")
    print(f"  slice shape f32 (scalar route): kernel {f32_ms_1:.4f} / {f32_ms_2:.4f} ms (mean {f32_ms:.4f}), library "
          f"(SDPA, f32) {f32_library_ms:.4f} ms, bound {f32_bound_ms:.4f} ms ({f32_bound_by}, the 67 TFLOP/s f32 "
          f"pipe), roofline share {f32_bound_ms / f32_ms:.4f}")

    counters = {"flash_attention": ops, "wkv6": wkv_ops}

    # 4. the slice: llama3.2-3b serving at full width
    cfg = get_config("llama3.2-3b")
    b, t, new = 4, 1024, 32
    print(f"[4] serve {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.param_dtype}, "
          f"batch {b}, prompt {t}, {new} new tokens")
    model = build_model(cfg, "cuda")
    params = convert.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = serve.random_prompts(cfg, b, t, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    res = serve.generate(model, params, prompts, new)
    counts = {name: c.launches for name, c in counters.items()}
    launches = counts["flash_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  flash-attention launches during the run: {launches} (expected {cfg.n_layers}, one per prefill layer)")
    if counts != {"flash_attention": cfg.n_layers, "wkv6": 0}:
        raise AssertionError(f"expected {cfg.n_layers} flash-attention launches and no other, got {counts}")
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("prefill logits are not finite")
    if tuple(res.tokens.shape) != (b, new) or not bool(((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(res.tokens.shape)}")
    steps = new - 1
    print(f"  first prefill {res.prefill_s * 1e3:.1f} ms; decoded {steps} steps x batch {b} in "
          f"{res.decode_s:.3f}s ({steps * b / res.decode_s:.1f} tok/s); peak memory {peak_gb:.2f} GB")
    print(f"  tokens[0]: {res.tokens[0].tolist()}")

    plain_model = build_model(cfg.replace(use_kernels=False), "cuda")
    prefill_ms = cuda_ms(lambda: model.prefill(params, {"tokens": prompts}), iters=3, warmup=1)
    plain_prefill_ms = cuda_ms(lambda: plain_model.prefill(params, {"tokens": prompts}), iters=3, warmup=1)
    plain_logits, _ = plain_model.prefill(params, {"tokens": prompts})
    lg = res.prefill_logits
    rel = ((lg - plain_logits).abs().max() / lg.abs().max()).item()
    agree = int((lg.argmax(-1) == plain_logits.argmax(-1)).sum())
    print(f"  prefill {prefill_ms:.1f} ms with the kernel, {plain_prefill_ms:.1f} ms with plain attention")
    device_breakdown(lambda: model.prefill(params, {"tokens": prompts}), "prefill, kernel path", prefill_ms)
    device_breakdown(lambda: plain_model.prefill(params, {"tokens": prompts}), "prefill, plain path",
                     plain_prefill_ms)
    token = res.tokens[:, -1:]
    decode_cache = model.init_cache(b, t + new)
    decode_ms = cuda_ms(lambda: model.decode_step(params, token, decode_cache, t), iters=5, warmup=2)
    device_breakdown(lambda: model.decode_step(params, token, decode_cache, t), "one decode step", decode_ms)
    print(f"  kernel vs plain attention: max|dlogits|/max|logits| {rel:.3e} (bound {MODEL_REL_TOL}); "
          f"argmax agrees on {agree}/{b} rows")
    layer_rel = per_layer_gap(cfg, params, prompts)
    print(f"  kernel vs plain attention, each layer fed the same input: worst max|dout|/max|out| "
          f"{layer_rel:.3e} (bound {LLAMA_LAYER_TOL})")
    if not rel < MODEL_REL_TOL:
        raise AssertionError(f"full-model logits differ by {rel:.3e} relative (> {MODEL_REL_TOL})")
    if not layer_rel < LLAMA_LAYER_TOL:
        raise AssertionError(f"a layer's output differs by {layer_rel:.3e} relative (> {LLAMA_LAYER_TOL})")
    del params, plain_logits, res, decode_cache
    torch.cuda.empty_cache()

    # smoke config in f32: the kernel path against the plain path, prefill and decode
    small = get_smoke_config("llama3.2-3b")
    runs = {}
    for use in (True, False):
        runs[use] = serve.serve(small.replace(use_kernels=use), batch=2, prompt_len=128, new_tokens=8, seed=3)
    d = (runs[True].prefill_logits - runs[False].prefill_logits).abs().max().item()
    same = bool(torch.equal(runs[True].tokens, runs[False].tokens))
    print(f"  smoke config f32, kernel vs plain: max|dlogits| {d:.3e} (atol 1e-4), greedy tokens equal: {same}")
    if not (d <= 1e-4 and same):
        raise AssertionError("smoke model: kernel path disagrees with the plain path")

    # 5. wkv6 kernels vs plain
    print("[5] wkv6, kernel vs plain version (K = V = 64 with whole chunks: tensor-core route; else scalar)")
    for i, case in enumerate(WKV_CASES):
        check_wkv(case, seed=200 + i)
    wkv_err = check_wkv(WKV_SLICE, seed=300)
    check_wkv(WKV_SLICE, seed=301, kernel_name="wkv6")
    w1, wkv_scalar_ms, w2, wkv_plain_ms = time_wkv(WKV_SLICE)
    wkv_ms = (w1 + w2) / 2
    bounds = wkv_bounds(WKV_SLICE)
    (wkv_bound_ms, wkv_bound_by), (scalar_bound_ms, scalar_bound_by) = bounds["tf32x3"], bounds["float32"]
    print(f"  slice shape {WKV_SLICE}: tensor-core kernel {w1:.4f} / {w2:.4f} ms (mean {wkv_ms:.4f}), "
          f"scalar kernel {wkv_scalar_ms:.4f} ms, plain {wkv_plain_ms:.4f} ms, "
          f"library none (no single PyTorch call computes wkv6)")
    print(f"  bounds: tensor-core route (TF32 tensor cores / 3) {wkv_bound_ms:.4f} ms ({wkv_bound_by}), "
          f"roofline share {wkv_bound_ms / wkv_ms:.4f}; scalar route (f32 pipe) {scalar_bound_ms:.4f} ms "
          f"({scalar_bound_by}), roofline share {scalar_bound_ms / wkv_scalar_ms:.4f}")

    # 6. the slice: rwkv6-3b serving at full width
    wkv_launches = serve_rwkv(counters)

    # 7. the simulation engine (no kernel of the port on its path)
    p7 = engine_fig2()

    # 8. the sweep engine: two grids, each one program (no kernel of the port on its path)
    engine_sweep(p7)

    # 9. the async modes: fig_async's mixed-mode grid as one program (no kernel of the port on its path)
    engine_async()

    # 10. faults and robust aggregation: the forced grid and fig_byzantine's grid (no kernel of the port on their path)
    engine_faults()

    # 11. the LM training path: the eval forward of each step runs the kernels, the gradients the plain path
    sys.stdout.flush()
    p11 = train_phase()

    # 16's dry runs start here, on the host's cores beside phases 12 and 13, whose work is on the card
    dryruns, t_dryruns = start_dryruns(dryrun_dir), time.perf_counter()
    try:
        # 12. the MoE and hybrid families: the kernel at their prefill shapes, serving and training at full width
        sys.stdout.flush()
        p12 = family_phase(counters)

        # 13. the vlm and encdec families and the large dense archs: the kernel at head dims 192 and 256, serving
        # and training at full width
        sys.stdout.flush()
        p13 = new_families_phase()

        # 14. the experiment entry points: train --simulate and the figure functions (no kernel of the port on
        # their path)
        sys.stdout.flush()
        experiments_phase()

        # 15. distribution and blocked attention: the mesh's prefill and train step run the kernels on local shards
        sys.stdout.flush()
        p15 = distribution_phase(counters, p7["eta"])

        # 16. the dry run, the roofline and the kernel cache
        sys.stdout.flush()
        tooling_phase(counters, dryruns, t_dryruns)
    finally:
        stop_dryruns(dryruns)

    # 17. summary
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/flash_attn_sm90.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:96",
        "launches": launches,
        "max_abs_err": slice_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "f32_source": "src/repro_torch/kernels/attention/csrc/flash_attn.cu",
        "f32_ms": f32_ms,
        "f32_bound_ms": f32_bound_ms,
        "f32_bound_by": f32_bound_by,
        "f32_library_ms": f32_library_ms,
        "train_launches": p11["llama"]["launches"],
        "mesh_prefill_launches": p15["world1"]["prefill_launches"],
        "mesh_train_launches": p15["world1"]["train_launches"],
        "layout_piece_launches": {arch: r["launches"] for arch, r in p15["pieces"].items()},
        "family_shapes": {arch: {**p12["kernel"][arch], "shape": list(FAMILY_SHAPES[arch]),
                                 "launches": p12["serve"][arch]["launches"]}
                          for arch in FAMILY_SHAPES},
        "family_train_shapes": {arch: {**p12["train_kernel"][arch], "shape": list(FAMILY_TRAIN_SHAPES[arch]),
                                       "launches": p12["train"][arch]["launches"]}
                                for arch in FAMILY_TRAIN_SHAPES},
        "new_arch_shapes": {arch: {**p13["kernel"][arch], "shape": list(NEW_SHAPES[arch]),
                                   "launches": p13["serve"][arch]["launches"]}
                            for arch in NEW_SHAPES},
        "new_arch_train_shapes": {arch: {**p13["train_kernel"][arch], "shape": list(NEW_TRAIN_SHAPES[arch]),
                                         "launches": p13["train"][arch]["launches"]}
                                  for arch in NEW_TRAIN_SHAPES},
    }, {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/wkv/csrc/wkv6_sm90.cu",
        "replaces": "src/repro/kernels/wkv/kernel.py:118",
        "launches": wkv_launches,
        "max_abs_err": wkv_err,
        "ms": wkv_ms,
        "plain_ms": wkv_plain_ms,
        "bound_ms": wkv_bound_ms,
        "bound_by": wkv_bound_by,
        "library_ms": None,
        "scalar_source": "src/repro_torch/kernels/wkv/csrc/wkv6.cu",
        "scalar_ms": wkv_scalar_ms,
        "scalar_bound_ms": scalar_bound_ms,
        "scalar_bound_by": scalar_bound_by,
        "train_launches": p11["smoke"]["rwkv_sync_wkv_launches"],
        "value_piece_launches": p15["value_pieces"]["launches"],
        "value_pieces": {dt: p15["value_pieces"][dt] for dt in VALUE_PIECE_DTYPES},
    }]
    print(f"[17] chip_smoke.py took {time.perf_counter() - script_t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
