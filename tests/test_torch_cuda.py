"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without an NVIDIA GPU every test here skips (a CUDA kernel has
no CPU mode).  This file imports nothing of JAX, so it runs on a GPU host
that has only PyTorch and nvcc:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops, ref  # noqa: E402

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
