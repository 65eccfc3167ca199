"""ctypes binding of the CUDA wkv6 kernels, one route per shape.

The port of `repro/kernels/wkv/kernel.py::wkv6_bhtk`.  Where the Pallas
kernel takes inputs folded to (B*H, T, K), these read r, k, v, w in the
model's (B, T, H, K) layout through strides, so only the last dimension has
to be contiguous.  `route` picks the kernel from the shapes alone:
- `csrc/wkv6_sm90.cu` for K = V = 64 and whole chunks of 16, 32, 48 or 64
  (T >= chunk): every product on the tensor cores (split TF32, f32
  accumulation), the state in registers, the next chunk loaded with
  cp.async while this one computes.  Its copies move 16 bytes, so the base
  addresses and strides must be multiples of 16 bytes (`align_error`);
- `csrc/wkv6.cu` for every other shape the wrapper takes (K or V below 64,
  a prompt shorter than the chunk, which runs one chunk of C = T): scalar
  f32.
A route that fails to build or launch raises; nothing falls back to the
other route or to the plain version.  Both launch on the current CUDA stream
and allocate nothing: y and s_T come from `torch.empty` here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_DIM = 64  # chunk, K and V: the scalar kernel stages chunk x 64 tiles in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM90_DIM = 64  # K = V of the tensor-core route
SM90_CHUNKS = (16, 32, 48, 64)
ALIGN = 16  # bytes of one cp.async copy

_entries: dict = {}


def route(t: int, k_dim: int, v_dim: int, chunk: int) -> str:
    """The kernel ("wkv6_sm90" or "wkv6") for a (B, T, H, K) scan asked to
    run chunks of `chunk`; a prompt shorter than that (one chunk of T) takes
    the scalar kernel."""
    if k_dim == v_dim == SM90_DIM and chunk <= t and chunk in SM90_CHUNKS:
        return "wkv6_sm90"
    return "wkv6"


def _entry(name: str):
    """(launch, error_string) C functions of the library built from `<name>.cu`."""
    if name not in _entries:
        lib = _build.load(name)
        fn = getattr(lib, f"{name}_fwd")
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # r k v w
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u s0 y s_T
            ctypes.c_int,  # dtype
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H T C K V
            ctypes.POINTER(ctypes.c_int64),  # 12 strides
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _entries[name] = (fn, err_str)
    return _entries[name]


def align_error(x: torch.Tensor) -> str | None:
    """Why the tensor-core route cannot copy this (B, T, H, K) view with
    16-byte cp.async, or None if it can.  A dim of size 1 is never stepped
    over, so its stride does not matter."""
    if x.data_ptr() % ALIGN:
        return f"the base address {x.data_ptr():#x} is not a multiple of {ALIGN} bytes"
    for name, size, stride in zip(("batch", "time", "head"), x.shape[:3], x.stride()[:3]):
        if size > 1 and (stride * x.element_size()) % ALIGN:
            return f"the {name} stride of {stride * x.element_size()} bytes is not a multiple of {ALIGN}"
    return None


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
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a kernel on CUDA tensors.  Returns (y (B,T,H,V) f32, s_T (B,H,K,V) f32).

    `chunk` is the chunk the scan runs (at most T); `kernel` is the route,
    `route(T, K, V, chunk)` if None."""
    check_inputs(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {r.device}")
    b, t, h, kdim = r.shape
    vdim = v.shape[-1]
    name = route(t, kdim, vdim, chunk) if kernel is None else kernel
    if name == "wkv6_sm90":
        if kdim != SM90_DIM or vdim != SM90_DIM or chunk not in SM90_CHUNKS:
            raise ValueError(f"the tensor-core wkv6 kernel needs K = V = {SM90_DIM} and a chunk in {SM90_CHUNKS}; "
                             f"got K={kdim}, V={vdim}, chunk={chunk}")
        for label, x in (("r", r), ("k", k), ("v", v), ("w", w)):
            why = align_error(x)
            if why is not None:
                raise ValueError(f"{label}: the tensor-core wkv6 kernel cannot take this view: {why}")
        if u.data_ptr() % 8:  # read two channels at a time
            raise ValueError("u: the tensor-core wkv6 kernel needs its base address on 8 bytes")
    elif name != "wkv6":
        raise ValueError(f"no wkv6 kernel named {name!r}")
    y = torch.empty((b, t, h, vdim), dtype=torch.float32, device=r.device)
    s_t = torch.empty((b, h, kdim, vdim), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 12)(
        *(x.stride(i) for x in (r, k, v, w) for i in (0, 1, 2))
    )
    fn, err_str = _entry(name)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_t.data_ptr(),
            _DTYPES[r.dtype], b, h, t, chunk, kdim, vdim, strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}_fwd launch failed: {err_str(err).decode()} (cuda error {err})")
    return y, s_t
