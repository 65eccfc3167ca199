"""ctypes binding of the CUDA flash-attention kernels, one route per dtype.

The port of `repro/kernels/attention/kernel.py::flash_attention_bhtd`.  The
route is fixed by the dtype (`ROUTES`):
- bf16 goes to `csrc/flash_attn_sm90.cu`: TMA loads into shared memory and
  both products on the tensor cores (`wgmma`, f32 accumulation);
- f32 goes to `csrc/flash_attn.cu`: scalar f32 FMAs, since `wgmma` has no
  f32 product other than TF32 and the f32 callers need full f32.
A route that fails to build or launch raises; nothing falls back to the other
route or to the plain version.  Both kernels read their operands through
strides, so the (B, H, T, hd) tensors they take may be transposed views of
the model's (B, T, H, hd) activations; only the head dimension has to be
contiguous, and the bf16 route also needs what TMA needs
(`tma_layout_error`).  They launch on the current CUDA stream and allocate
nothing: the output comes from `torch.empty` here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from repro_torch.kernels import _build

# dtype -> the CUDA source (and library) that computes it
ROUTES = {torch.float32: "flash_attn", torch.bfloat16: "flash_attn_sm90"}
# route -> the head dims it is instantiated for: 192 is nemotron-4-340b's and
# 256 paligemma-3b's; the f32 route also takes 16 and 48, the head dims of
# the MoE archs' and nemotron-4-340b's smoke configs
ROUTE_HEAD_DIMS = {"flash_attn": (16, 32, 48, 64, 128, 192, 256), "flash_attn_sm90": (32, 64, 128, 192, 256)}
# TMA reads a tile from a base address, and through strides, that are
# multiples of 16 bytes; a stride must also be below 2^40 bytes.
TMA_ALIGN = 16
TMA_MAX_STRIDE = 1 << 40

_entries: dict = {}


def _entry(route: str):
    """(launch, error_string) C functions of the library built from `<route>.cu`."""
    if route not in _entries:
        lib = _build.load(route)
        fn = getattr(lib, f"{route}_fwd")
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H KV T S
            ctypes.c_int,  # hd
            ctypes.POINTER(ctypes.c_int64),  # 12 strides
            ctypes.c_int, ctypes.c_int, ctypes.c_float,  # causal window sm_scale
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{route}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _entries[route] = (fn, err_str)
    return _entries[route]


def tma_layout_error(shape: Sequence[int], strides: Sequence[int], data_ptr: int, itemsize: int) -> str | None:
    """Why TMA cannot read a (B, N, L, hd) view with these strides (in
    elements) and base address, or None if it can.  A dim of size 1 is never
    stepped over, so its stride does not matter."""
    if strides[3] != 1:
        return "the head dimension is not contiguous"
    if data_ptr % TMA_ALIGN:
        return f"the base address {data_ptr:#x} is not a multiple of {TMA_ALIGN} bytes"
    for name, size, stride in zip(("batch", "head", "sequence"), shape[:3], strides[:3]):
        nbytes = stride * itemsize
        if size > 1 and (nbytes % TMA_ALIGN or not 0 < nbytes < TMA_MAX_STRIDE):
            return f"the {name} stride of {nbytes} bytes is not a positive multiple of {TMA_ALIGN} below 2^40"
    return None


def _tma_check(name: str, x: torch.Tensor) -> None:
    why = tma_layout_error(x.shape, x.stride(), x.data_ptr(), x.element_size())
    if why is not None:
        raise ValueError(f"{name}: the bf16 kernel cannot take this view: {why}")


def _strides(x: torch.Tensor) -> tuple:
    """(batch, sequence, head) strides in elements of a (B, N, L, hd) tensor;
    a dim of size 1 gets the stride of a contiguous head row, which TMA takes
    whatever the view's own stride is there."""
    return tuple(st if n > 1 else x.shape[3] for n, st in ((x.shape[0], x.stride(0)), (x.shape[2], x.stride(2)),
                                                         (x.shape[1], x.stride(1))))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> None:
    """Raise ValueError for what the kernels do not take.  (B,H,T,hd) layout."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be rank 4 (B, H, T, hd)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in ROUTES:
        raise ValueError(f"q, k, v must share a dtype in {list(ROUTES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    b, h, t, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k, v must be (B, KV, S, hd) matching q {tuple(q.shape)}; got {tuple(k.shape)}, {tuple(v.shape)}")
    head_dims = ROUTE_HEAD_DIMS[ROUTES[q.dtype]]
    if hd not in head_dims:
        raise ValueError(f"head_dim {hd} not in {head_dims} for {q.dtype}")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"n_heads {h} must be a multiple of n_kv_heads {k.shape[1]}")
    if causal and t != k.shape[2]:
        raise ValueError(f"causal attention needs T == S (positions start at 0); got T={t}, S={k.shape[2]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its head dimension")


def flash_attention_bhtd(
    q: torch.Tensor,  # (B, H, T, hd)
    k: torch.Tensor,  # (B, KV, S, hd)
    v: torch.Tensor,  # (B, KV, S, hd)
    *,
    causal: bool = True,
    window: int = 0,
    out: torch.Tensor | None = None,  # (B, H, T, hd), same dtype; allocated if None
) -> torch.Tensor:
    """Launch the kernel of q's dtype on CUDA tensors.  Returns `out`."""
    check_inputs(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {q.device}")
    b, h, t, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty_like(q)
    elif out.shape != q.shape or out.dtype != q.dtype or out.device != q.device or out.stride(-1) != 1:
        raise ValueError("out must match q in shape, dtype and device, contiguous in hd")
    route = ROUTES[q.dtype]
    if route == "flash_attn_sm90":
        for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
            _tma_check(name, x)
    strides = (ctypes.c_int64 * 12)(*_strides(q), *_strides(k), *_strides(v), *_strides(out))
    fn, err_str = _entry(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kvh, t, s, hd, strides, int(causal), int(window),
            1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"{route}_fwd launch failed: {err_str(err).decode()} (error {err})")
    return out
