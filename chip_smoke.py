#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

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
   time at the causal shape in f32.
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
   k = 10, 20, 30, 40) at full width, R=32, n=50, m=2000, d=100, 2000
   iterations each, graph-replayed, against the same cells run eagerly on
   the card (bitwise) and run on the CPU (500 iterations); print the
   launches and ms of an iteration both ways, the device's idle share and
   top operations, and the peak memory.
8. Run the sweep engine (no kernel of the port on its path either): fig2's
   five cells as one grid of 160 lanes (2000 iterations) and the
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
10. Print one `kernels` JSON line, the card again, and, as the last line,
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line.  It does the same when there is no CUDA device or no port beside it.
No kernel has a CPU path and nothing falls back to a plain version; the
engine phases run the CPU only as the reference they are held to.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

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
# against the same step run eagerly on the card (bitwise) and against the
# port on the CPU at the first eval point (500 iterations): k equal, time
# within 1e-5 and loss within 1e-4 relative (the CPU's and the card's
# log1p, matmul sums and reductions differ in the last ulps).  A near-zero
# inner product g_j . g_{j-1} can flip a Pflug sign event and fork that
# replica's k: at most 2 of the 32 may fork, each reported.
ENGINE_ITERS, ENGINE_CPU_ITERS = 2000, 500
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
        eager_f = {lb: pool.submit(fig2_cell, lb, "cuda", ENGINE_ITERS, False, eta) for lb in labels}
        cpu_f = {lb: pool.submit(fig2_cell, lb, "cpu", ENGINE_CPU_ITERS, True, eta) for lb in labels}
        eager = {lb: f.result() for lb, f in eager_f.items()}
        cpu = {lb: f.result() for lb, f in cpu_f.items()}
    workers_s = time.perf_counter() - t0
    n_iters = ENGINE_ITERS * len(labels)
    eager_s = max(s for _, s in eager.values())
    print(f"  graph-replayed: {len(labels)} cells in {graph['wall_s']:.2f} s with {captures} captures "
          f"({graph['wall_s'] / n_iters * 1e3:.4f} ms an iteration, captures included); eager, a worker process "
          f"a cell: the slowest cell {eager_s:.2f} s ({eager_s / ENGINE_ITERS * 1e3:.4f} ms an iteration); "
          f"CPU, {ENGINE_CPU_ITERS} iterations a cell: the slowest {max(s for _, s in cpu.values()):.2f} s; "
          f"{workers_s:.1f} s for all workers; eta {eta!r}")
    print(f"  peak memory of the graph-replayed run: {peak_mb:.2f} MB")
    for label in labels:
        g = graph["results"][label]
        gk, gt, gl = (getattr(g, f).cpu().numpy() for f in ("k", "time", "loss"))
        (et, el, ek), _ = eager[label]
        (ct, cl, ck), _ = cpu[label]
        same = np.array_equal(gt, et) and np.array_equal(gl, el) and np.array_equal(gk, ek)
        gk, gt, gl = gk[:, :1], gt[:, :1], gl[:, :1]
        forked = np.nonzero((gk != ck).any(axis=1))[0]
        keep = np.setdiff1d(np.arange(gk.shape[0]), forked)
        t_gap = float(np.max(np.abs(gt[keep] - ct[keep]) / np.abs(ct[keep])))
        l_gap = float(np.max(np.abs(gl[keep] - cl[keep]) / np.abs(cl[keep])))
        s = graph["cases"][label]
        print(f"  {label}: graph vs eager bitwise equal {same}; card vs CPU at iteration {ENGINE_CPU_ITERS}: "
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
# 2000 iterations (its CPU run at 500); the ablation's grid (5 controllers x
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
    adaptive cell, time and loss within the engine's tolerances."""
    import numpy as np

    rows, gaps = [], (0.0, 0.0)
    for label, g in got.items():
        gt, gl, gk = (a[:, :cols] for a in g)
        wt, wl, wk = (a[:, :cols] for a in want[label])
        same = np.array_equal(gt, wt) and np.array_equal(gl, wl) and np.array_equal(gk, wk)
        forked = np.nonzero((gk != wk).any(axis=1))[0]
        keep = np.setdiff1d(np.arange(gk.shape[0]), forked)
        t_gap = float(np.max(np.abs(gt[keep] - wt[keep]) / np.abs(wt[keep]), initial=0.0))
        l_gap = float(np.max(np.abs(gl[keep] - wl[keep]) / np.abs(wl[keep]), initial=0.0))
        gaps = (max(gaps[0], t_gap), max(gaps[1], l_gap))
        if not same:
            rows.append(f"{label} {len(forked)} forked, {t_gap:.2e}/{l_gap:.2e}")
        if len(forked) > (ENGINE_MAX_FORKS if label in adaptive else 0):
            raise AssertionError(f"{what}: {label}: {len(forked)} replicas forked in k: {forked.tolist()}")
        if not (t_gap <= ENGINE_TIME_RTOL and l_gap <= ENGINE_LOSS_RTOL):
            raise AssertionError(f"{what}: {label}: time gap {t_gap:.3e} or loss gap {l_gap:.3e} beyond "
                                 f"{ENGINE_TIME_RTOL} / {ENGINE_LOSS_RTOL}")
        if not (np.isfinite(gt).all() and np.isfinite(gl).all()):
            raise AssertionError(f"{what}: {label}: time or loss not finite")
    print(f"  {what}: {len(got) - len(rows)}/{len(got)} cells bitwise equal; max rel gap time {gaps[0]:.3e}, "
          f"loss {gaps[1]:.3e}" + "".join(f"; {r}" for r in rows))


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


def main() -> int:
    import torch

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
    sass = sass_counts(_build, "flash_attn_sm90", ("HGMMA", "UTMALDG"))
    print(f"[2] flash_attn_sm90 SASS (cuobjdump -sass): {sass}")
    if not all(sass.values()):
        raise AssertionError(f"the bf16 attention kernel lacks wgmma or TMA instructions: {sass}")
    wkv_sass = sass_counts(_build, "wkv6_sm90", ("HMMA", "HGMMA", "LDGSTS"))
    print(f"[2] wkv6_sm90 SASS (cuobjdump -sass): {wkv_sass}")
    if not all(wkv_sass.values()):
        raise AssertionError(f"the tensor-core wkv6 kernel lacks mma.sync, wgmma or cp.async instructions: {wkv_sass}")

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
    f32_ms = cuda_ms(lambda: ops.flash_attention(q32, k32, v32, causal=True), iters=50, warmup=5)
    del q32, k32, v32
    f32_bound_ms, f32_bound_by, _ = attention_bound(SLICE_SHAPE, "float32")
    print(f"  slice shape f32 (scalar route): kernel {f32_ms:.4f} ms, bound {f32_bound_ms:.4f} ms ({f32_bound_by}), "
          f"roofline share {f32_bound_ms / f32_ms:.4f}")

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

    # 10. summary
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
