"""The port's flash attention (repro_torch.kernels.attention) against the JAX
package's: the Pallas kernel in interpret mode (which its wrapper picks by
itself off-TPU) and its oracle `attention_ref`.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version; the CUDA kernel is held to
that plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.attention.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.attention import kernel, ops, ref  # noqa: E402

# (B, T, S, H, KV, hd, causal, window), as tests/test_kernels.py
ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, 0),  # GQA causal
    (1, 256, 256, 4, 4, 64, True, 64),  # MHA sliding window
    (2, 128, 256, 8, 2, 32, False, 0),  # cross-ish (no mask), longer kv
    (1, 128, 128, 8, 1, 64, True, 0),  # MQA
    (1, 512, 512, 2, 2, 128, True, 128),  # long window
    (1, 256, 256, 8, 1, 256, True, 0),  # MQA at hd 256, paligemma-3b's group of 8
    (1, 128, 128, 12, 1, 192, True, 0),  # hd 192 and a group of 12, nemotron-4-340b's
]
# f32: the two sides differ only in summation order (and the Pallas kernel's
# online softmax), the tolerance tests/test_kernels.py holds the kernel to.
# bf16: the port's plain version rounds scores and probabilities to bf16 as
# attention_ref does, the Pallas kernel keeps them f32; 2^-8 relative.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PORT_FNS = {"ops.flash_attention": ops.flash_attention, "ref.attention_ref": ref.attention_ref}


def _inputs(shape, seed):
    b, t, s, h, kv, hd, _, _ = shape
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, t, h, hd), dtype=np.float32),
        rng.standard_normal((b, s, kv, hd), dtype=np.float32),
        rng.standard_normal((b, s, kv, hd), dtype=np.float32),
    )


def _to_torch(xs, dtype_name):
    return [torch.from_numpy(x).to(getattr(torch, dtype_name)) for x in xs]


def _to_jax(xs, dtype_name):
    return [jnp.asarray(x, getattr(jnp, dtype_name)) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("fn", list(PORT_FNS), ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_port_attention_matches_jax(shape, dtype, fn):
    causal, window = shape[6], shape[7]
    xs = _inputs(shape, seed=ATTN_SHAPES.index(shape))
    port = PORT_FNS[fn](*_to_torch(xs, dtype), causal=causal, window=window)
    jq, jk, jv = _to_jax(xs, dtype)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert port.dtype == getattr(torch, dtype) and tuple(port.shape) == tuple(pallas.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(port), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(port), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype, hd", [(dt, hd) for dt, route in kernel.ROUTES.items()
                                       for hd in kernel.ROUTE_HEAD_DIMS[route]], ids=str)
def test_port_attention_matches_jax_at_each_route_head_dim(dtype, hd):
    """Every head dim a route is instantiated for (192 and 256 in both, and
    the f32 route's 16 and 48, the MoE and nemotron-4-340b smoke configs'),
    GQA causal with a window, against the Pallas kernel in interpret mode."""
    shape = (1, 128, 128, 4, 2, hd, True, 64)
    name = str(dtype).removeprefix("torch.")
    xs = _inputs(shape, seed=hd)
    port = ops.flash_attention(*_to_torch(xs, name), causal=True, window=64)
    pallas = jax_flash_attention(*_to_jax(xs, name), causal=True, window=64, block_q=64, block_k=64)
    assert port.dtype == dtype and tuple(port.shape) == tuple(pallas.shape)
    np.testing.assert_allclose(_np(port), _np(pallas), atol=TOL[name], rtol=TOL[name])


def test_first_token_attends_only_to_itself():
    """Causal row 0 equals v[0] (softmax over a single key), and matches JAX."""
    shape = (1, 64, 64, 2, 2, 32, True, 0)
    xs = _inputs(shape, seed=2)
    q, k, v = _to_torch(xs, "float32")
    out = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0].numpy(), atol=1e-5)
    jq, jk, jv = _to_jax(xs, "float32")
    jout = jax_flash_attention(jq, jk, jv, causal=True, block_q=32, block_k=32)
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(jout[:, 0]), atol=1e-5)


def test_rows_that_see_no_key_are_zero():
    """Non-causal window with T > S: rows 191.. see no key.  The Pallas kernel
    outputs 0 there and so does the port (a plain softmax would not)."""
    shape = (1, 256, 128, 2, 1, 64, False, 64)
    xs = _inputs(shape, seed=3)
    out = ops.flash_attention(*_to_torch(xs, "float32"), causal=False, window=64)
    jout = jax_flash_attention(*_to_jax(xs, "float32"), causal=False, window=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
    assert not out[:, 191:].any() and out[:, :191].abs().sum(-1).min() > 0


@pytest.mark.parametrize(
    "case",
    ["head_dim_48", "float16", "mixed_dtypes", "causal_t_ne_s", "kv_heads_not_dividing"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    b, t, h, kv, hd = 1, 128, 4, 2, 64
    q, k, v = torch.zeros(b, t, h, hd), torch.zeros(b, t, kv, hd), torch.zeros(b, t, kv, hd)
    if case == "head_dim_48":  # taken by the f32 route (nemotron-4-340b's smoke config), not by bf16
        q, k, v = (x[..., :48].to(torch.bfloat16) for x in (q, k, v))
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtypes":
        q = q.to(torch.bfloat16)
    elif case == "causal_t_ne_s":
        k, v = torch.zeros(b, 2 * t, kv, hd), torch.zeros(b, 2 * t, kv, hd)
    elif case == "kv_heads_not_dividing":
        k, v = torch.zeros(b, t, 3, hd), torch.zeros(b, t, 3, hd)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, causal=True)


def test_kernel_binding_refuses_cpu_tensors():
    """The binding launches on CUDA tensors only; it never computes on the CPU."""
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention_bhtd(q, q[:, :1], q[:, :1])


def test_dtype_picks_the_kernel_route():
    """bf16 goes to the wgmma + TMA kernel, f32 to the scalar f32 kernel;
    each route names a CUDA source of the port, and no other dtype has one."""
    from repro_torch.kernels import _build

    assert kernel.ROUTES == {torch.float32: "flash_attn", torch.bfloat16: "flash_attn_sm90"}
    names = {src.stem for src in _build.sources()}
    assert set(kernel.ROUTES.values()) <= names
    with pytest.raises(ValueError, match="dtype"):
        kernel.check_inputs(*(torch.zeros(1, 2, 64, 64, dtype=torch.float16),) * 3, causal=True)


def _tma_error(x):
    return kernel.tma_layout_error(x.shape, x.stride(), x.data_ptr(), x.element_size())


@pytest.mark.parametrize("hd", kernel.ROUTE_HEAD_DIMS["flash_attn_sm90"])
def test_tma_check_accepts_the_models_views(hd):
    """The model's (B,T,H,hd) q and (B,S,KV,hd) k, v, transposed to the
    kernel's (B,H,T,hd) as ops.flash_attention does, contiguous or cut from
    one fused qkv projection, at every head dim."""
    b, t, h, kv = 2, 100, 6, 2
    for x in (torch.zeros(b, t, h, hd, dtype=torch.bfloat16), torch.zeros(b, t, kv, hd, dtype=torch.bfloat16)):
        assert _tma_error(x.transpose(1, 2)) is None
    fused = torch.zeros(b, t, (h + 2 * kv) * hd, dtype=torch.bfloat16)
    for lo, hi in ((0, h * hd), (h * hd, (h + kv) * hd), ((h + kv) * hd, (h + 2 * kv) * hd)):
        assert _tma_error(fused[..., lo:hi].unflatten(-1, (-1, hd)).transpose(1, 2)) is None
    # one batch, one head: the strides of size-1 dims are never stepped over
    assert kernel.tma_layout_error((1, 1, t, hd), (7, 3, hd, 1), 0, 2) is None


@pytest.mark.parametrize(
    "case, shape, strides, ptr, why",
    [
        ("row_stride_odd", (1, 4, 128, 64), (128 * 257, 64, 257, 1), 0, "sequence stride of 514 bytes"),
        ("head_stride_4_elements", (1, 4, 128, 64), (4 * 128 * 64, 4, 256, 1), 0, "head stride of 8 bytes"),
        ("batch_stride_not_16", (2, 4, 128, 64), (4 * 128 * 64 + 1, 64, 256, 1), 0, "batch stride"),
        ("base_2_bytes_in", (1, 4, 128, 64), (4 * 128 * 64, 64, 256, 1), 2, "base address"),
        ("hd_not_contiguous", (1, 4, 128, 64), (4 * 128 * 128, 128, 512, 2), 0, "head dimension"),
        ("zero_stride", (1, 4, 128, 64), (0, 0, 64, 1), 0, "head stride of 0 bytes"),
    ],
)
def test_tma_check_refuses_what_tma_cannot_read(case, shape, strides, ptr, why):
    err = kernel.tma_layout_error(shape, strides, ptr, 2)
    assert err is not None and why in err, (case, err)


def test_cpu_calls_do_not_count_as_launches():
    before = ops.launches
    xs = _inputs(ATTN_SHAPES[0], seed=0)
    ops.flash_attention(*_to_torch(xs, "float32"))
    assert ops.launches == before
