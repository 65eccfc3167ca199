"""ctypes binding of the CUDA flash-attention kernel (`csrc/flash_attn.cu`).

The port of `repro/kernels/attention/kernel.py::flash_attention_bhtd`.  The
kernel reads its operands through strides, so the (B, H, T, hd) tensors it
takes may be transposed views of the model's (B, T, H, hd) activations; only
the head dimension has to be contiguous.  It launches on the current CUDA
stream and allocates nothing: the output comes from `torch.empty` here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attn")
        fn = lib.flash_attn_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
            ctypes.c_int,  # dtype
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H KV T S
            ctypes.c_int,  # hd
            ctypes.POINTER(ctypes.c_int64),  # 12 strides
            ctypes.c_int, ctypes.c_int, ctypes.c_float,  # causal window sm_scale
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attn_error_string)
    return _fn


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> None:
    """Raise ValueError for what the kernel does not take.  (B,H,T,hd) layout."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be rank 4 (B, H, T, hd)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share a dtype in {list(_DTYPES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    b, h, t, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k, v must be (B, KV, S, hd) matching q {tuple(q.shape)}; got {tuple(k.shape)}, {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
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
    """Launch the kernel on CUDA tensors.  Returns `out`."""
    check_inputs(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {q.device}")
    b, h, t, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty_like(q)
    elif out.shape != q.shape or out.dtype != q.dtype or out.device != q.device or out.stride(-1) != 1:
        raise ValueError("out must match q in shape, dtype and device, contiguous in hd")
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(2), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        out.stride(0), out.stride(2), out.stride(1),
    )
    fn, err_str = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, h, kvh, t, s, hd, strides, int(causal), int(window),
            1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: {err_str(err).decode()} (cuda error {err})")
    return out
