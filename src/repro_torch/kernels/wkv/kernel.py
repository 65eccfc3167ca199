"""ctypes binding of the CUDA wkv6 kernel (`csrc/wkv6.cu`).

The port of `repro/kernels/wkv/kernel.py::wkv6_bhtk`.  Where the Pallas
kernel takes inputs folded to (B*H, T, K), this one reads r, k, v, w in the
model's (B, T, H, K) layout through strides, so only the last dimension has
to be contiguous.  It launches on the current CUDA stream and allocates
nothing: y and s_T come from `torch.empty` here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_DIM = 64  # chunk, K and V: the kernel stages chunk x 64 tiles in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = _build.load("wkv6")
        fn = lib.wkv6_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # r k v w
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u s0 y s_T
            ctypes.c_int,  # dtype
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H T C K V
            ctypes.POINTER(ctypes.c_int64),  # 12 strides
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.wkv6_error_string)
    return _fn


def check_inputs(r, k, v, w, u, s0: Optional[torch.Tensor], *, chunk: int) -> None:
    """Raise ValueError for what the kernel does not take.  (B,T,H,K) layout."""
    if any(x.dim() != 4 for x in (r, k, v, w)):
        raise ValueError("r, k, v, w must be rank 4 (B, T, H, K)")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise ValueError(f"r, k, v must share a dtype in {list(_DTYPES)}; got {r.dtype}, {k.dtype}, {v.dtype}")
    b, t, h, kdim = r.shape
    vdim = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"r, k, w must be (B,T,H,K) and v (B,T,H,V) alike; got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    if tuple(u.shape) != (h, kdim):
        raise ValueError(f"u must be (H, K) = {(h, kdim)}; got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (b, h, kdim, vdim):
        raise ValueError(f"s0 must be (B, H, K, V) = {(b, h, kdim, vdim)}; got {tuple(s0.shape)}")
    for name, x in (("w", w), ("u", u), ("s0", s0)):
        if x is not None and x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {x.dtype}")
    if kdim > MAX_DIM or vdim > MAX_DIM:
        raise ValueError(f"K and V must be <= {MAX_DIM}; got K={kdim}, V={vdim}")
    if not 0 < chunk <= MAX_DIM or t % chunk:
        raise ValueError(f"T={t} must be a multiple of chunk={chunk}, and 0 < chunk <= {MAX_DIM}")
    tensors = [x for x in (r, k, v, w, u, s0) if x is not None]
    if len({x.device for x in tensors}) != 1:
        raise ValueError("r, k, v, w, u, s0 must be on one device")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    for name, x in (("u", u), ("s0", s0)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def wkv6_bthk(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    w: torch.Tensor,  # (B, T, H, K) f32 decays in (0, 1)
    u: torch.Tensor,  # (H, K) f32
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V) f32; None means zeros
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors.  Returns (y (B,T,H,V) f32, s_T (B,H,K,V) f32)."""
    check_inputs(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {r.device}")
    b, t, h, kdim = r.shape
    vdim = v.shape[-1]
    y = torch.empty((b, t, h, vdim), dtype=torch.float32, device=r.device)
    s_t = torch.empty((b, h, kdim, vdim), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 12)(
        *(x.stride(i) for x in (r, k, v, w) for i in (0, 1, 2))
    )
    fn, err_str = _entry()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_t.data_ptr(),
            _DTYPES[r.dtype], b, h, t, chunk, kdim, vdim, strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: {err_str(err).decode()} (cuda error {err})")
    return y, s_t
