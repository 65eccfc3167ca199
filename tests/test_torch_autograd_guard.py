"""The forward-only kernels and autograd, on the CPU: `kernels.forbid_autograd`
(which both CUDA wrappers call before they launch) and the CPU branches of
both wrappers, which autograd differentiates through their plain versions.
tests/test_torch_cuda.py holds the CUDA branches on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import forbid_autograd  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402


def _leaf(shape, seed, requires_grad=True, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.tensor(x, requires_grad=requires_grad)


def test_guard_raises_under_grad_mode_for_an_input_that_requires_grad():
    a, b = _leaf((2, 3), 0), _leaf((2, 3), 1, requires_grad=False)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        forbid_autograd("some_kernel", b, None, a)


@pytest.mark.parametrize("case", ["no_grad", "inference_mode", "nothing_requires_grad", "no_tensors"])
def test_guard_passes_where_no_gradient_is_asked_for(case):
    a, b = _leaf((2, 3), 0), _leaf((2, 3), 1, requires_grad=False)
    if case == "no_grad":
        with torch.no_grad():
            forbid_autograd("k", a, b)
    elif case == "inference_mode":
        with torch.inference_mode():
            forbid_autograd("k", a, b)
    elif case == "nothing_requires_grad":
        forbid_autograd("k", b, None)
    else:
        forbid_autograd("k")


def test_cpu_flash_attention_stays_differentiable():
    q, k, v = _leaf((1, 16, 4, 32), 0), _leaf((1, 16, 2, 32), 1), _leaf((1, 16, 2, 32), 2)
    out = attn_ops.flash_attention(q, k, v, causal=True)
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in (gq, gk, gv))


def test_cpu_wkv6_stays_differentiable():
    b, t, h, kd, vd = 1, 16, 2, 8, 8
    r, k, v = _leaf((b, t, h, kd), 0), _leaf((b, t, h, kd), 1), _leaf((b, t, h, vd), 2)
    decay = np.exp(-np.exp(np.random.default_rng(3).standard_normal((b, t, h, kd)) * 0.5 - 1))
    w = torch.tensor(decay.astype(np.float32), requires_grad=True)  # in (0, 1)
    u, s0 = _leaf((h, kd), 4), _leaf((b, h, kd, vd), 5)
    y, s_t = wkv_ops.wkv6(r, k, v, w, u, s0, chunk=8)
    grads = torch.autograd.grad(y.square().sum() + s_t.square().sum(), (r, k, v, w, u, s0))
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in grads)
