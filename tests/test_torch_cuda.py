"""The port's CUDA kernels (flash attention, wkv6) against their plain
PyTorch versions, on the card.

Marked `cuda`: without an NVIDIA GPU every test here skips (a CUDA kernel has
no CPU mode).  This file imports nothing of JAX, so it runs on a GPU host
that has only PyTorch and nvcc:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops, ref  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv import ref as wkv_ref  # noqa: E402

pytestmark = pytest.mark.cuda

# (B, T, S, H, KV, hd, causal, window): tests/test_kernels.py's shapes, and
# llama3.2-3b's prefill attention with and without a window.
ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 64, True, 64),
    (2, 128, 256, 8, 2, 32, False, 0),
    (1, 128, 128, 8, 1, 64, True, 0),
    (1, 512, 512, 2, 2, 128, True, 128),
    (1, 1024, 1024, 24, 8, 128, True, 0),
    (1, 1024, 1024, 24, 8, 128, True, 256),
    (1, 100, 100, 4, 2, 64, True, 0),  # ragged: T not a multiple of the kernel's tiles
]
# f32 differs from the plain version only in summation order; bf16 also in
# where the plain version rounds scores and probabilities (2^-8 relative).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_kernel_matches_plain_version(cuda_device, shape, dtype):
    b, t, s, h, kv, hd, causal, window = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (
        torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(cuda_device, getattr(torch, dtype))
        for sh in ((b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    )
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    plain = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(), atol=tol, rtol=tol)


def test_rows_that_see_no_key_are_zero_on_the_card(cuda_device):
    q = torch.randn(1, 256, 2, 64, device=cuda_device)
    k = torch.randn(1, 128, 1, 64, device=cuda_device)
    v = torch.randn(1, 128, 1, 64, device=cuda_device)
    out = ops.flash_attention(q, k, v, causal=False, window=64)
    plain = ref.attention_ref(q, k, v, causal=False, window=64)
    torch.cuda.synchronize()
    assert not out[:, 191:].any()
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(), atol=2e-5, rtol=2e-5)


# (B, T, H, K, V, chunk, decay_scale): tests/test_kernels.py's wkv shapes and
# chunk sizes, its strong-decay case, rwkv6-3b's prefill scan at batch 4 x
# 1024, and ragged prompts shorter than the model's chunk of 32 (one chunk of
# T, also when T is not a power of two).
WKV_CASES = [
    (2, 128, 3, 16, 16, 32, 0.5),
    (1, 64, 2, 32, 32, 32, 0.5),
    (1, 256, 1, 64, 64, 32, 0.5),
    (4, 32, 2, 8, 8, 32, 0.5),
    (2, 128, 2, 16, 16, 16, 0.5),
    (2, 128, 2, 16, 16, 32, 0.5),
    (2, 128, 2, 16, 16, 64, 0.5),
    (1, 128, 1, 8, 8, 64, 1.0),
    (4, 1024, 40, 64, 64, 32, 0.5),
    (2, 16, 4, 64, 64, 32, 0.5),
    (2, 20, 4, 64, 64, 32, 0.5),
]
# Kernel vs plain version, both f32 inside (bf16 r/k/v are widened before any
# arithmetic on both sides): tests/test_kernels.py's f32 tolerances, the
# looser ones under strong decay.
WKV_TOL = {0.5: dict(atol=5e-4, rtol=1e-3), 1.0: dict(atol=2e-3, rtol=5e-3)}


def _wkv_inputs(case, dtype, device):
    b, t, h, k, v, _, decay_scale = case
    rng = np.random.default_rng(sum(case[:5]))
    n = lambda *sh: rng.standard_normal(sh, dtype=np.float32)  # noqa: E731
    w = np.exp(-np.exp(n(b, t, h, k) * decay_scale)).astype(np.float32)
    f = lambda a, dt=torch.float32: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return (f(n(b, t, h, k), dtype), f(n(b, t, h, k), dtype), f(n(b, t, h, v), dtype), f(w),
            f(n(h, k) * 0.1), f(n(b, h, k, v) * 0.2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_kernel_matches_plain_version(cuda_device, case, dtype):
    xs = _wkv_inputs(case, getattr(torch, dtype), cuda_device)
    chunk = case[5]
    before = wkv_ops.launches
    y, s = wkv_ops.wkv6(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_ops.launches == before + 1
    py, ps = wkv_ref.wkv6_ref(*xs, chunk=min(chunk, case[1]))
    assert y.dtype == s.dtype == torch.float32 and y.shape == py.shape and s.shape == ps.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    tol = WKV_TOL[case[6]]
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **tol)
    np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), **tol)


def test_wkv_kernel_reads_strided_views_and_zero_state(cuda_device):
    """r, k, v, w as views into wider tensors (the kernel reads them through
    strides), and s0=None (zeros, not read)."""
    b, t, h, k = 2, 64, 3, 32
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    big = torch.randn(b, t, h, 4 * k, generator=gen, device=cuda_device)
    r, kk, v = big[..., :k], big[..., k:2 * k], big[..., 2 * k:3 * k]
    w = torch.exp(-torch.exp(big[..., 3 * k:] * 0.5))
    u = torch.randn(h, k, generator=gen, device=cuda_device) * 0.1
    y, s = wkv_ops.wkv6(r, kk, v, w, u, None, chunk=32)
    py, ps = wkv_ref.wkv6_ref(r, kk, v, w, u, None, chunk=32)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **WKV_TOL[0.5])
    np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), **WKV_TOL[0.5])
