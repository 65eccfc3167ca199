"""The port's RWKV-6 wkv scan (repro_torch.kernels.wkv and
repro_torch.models.linear_scan) against the JAX package's: the Pallas kernel
in interpret mode (which its wrapper picks by itself off-TPU), the chunked
scan and the single-token step.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's wrapper runs its plain version; the CUDA kernel is held to
that plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances are tests/test_kernels.py's: the two sides differ only in the
order of f32 sums (and the Pallas kernel's cumulative sums and masked
straddle levels), so the port is held to the JAX kernel with atol 5e-4 /
rtol 1e-3 in f32 (measured: at most 1.2e-4 on outputs up to 92, ~1e-6
relative, at the four shapes), to 1e-3 / 2e-3 across chunk sizes,
and to 2e-3 / 5e-3 under strong decay.  bf16 r/k/v are rounded the same way
on both sides and widened to f32 before any arithmetic, so the port's bf16
run is held to the JAX bf16 run at the f32 tolerance, and to the f32 step
recurrence at test_kernels.py's bf16 tolerance (5e-2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv.ops import wkv6 as jax_wkv6  # noqa: E402
from repro.models.linear_scan import wkv6_chunked as jax_wkv6_chunked  # noqa: E402
from repro.models.linear_scan import wkv6_step as jax_wkv6_step  # noqa: E402
from repro_torch.kernels.wkv import kernel, ops, ref  # noqa: E402
from repro_torch.models import linear_scan  # noqa: E402

# (B, T, H, K, V), as tests/test_kernels.py
WKV_SHAPES = [
    (2, 128, 3, 16, 16),
    (1, 64, 2, 32, 32),
    (1, 256, 1, 64, 64),  # RWKV-6 real head size
    (4, 32, 2, 8, 8),
]
F32_TOL = dict(atol=5e-4, rtol=1e-3)
CHUNK_TOL = dict(atol=1e-3, rtol=2e-3)
STRONG_TOL = dict(atol=2e-3, rtol=5e-3)
PORT_FNS = {"ops.wkv6": ops.wkv6, "linear_scan.wkv6_chunked": linear_scan.wkv6_chunked}


def _inputs(b, t, h, k, v_dim, seed=0, decay_scale=0.5):
    """r, k, v, w, u, s0 as f32 numpy arrays, distributed as test_kernels.py's."""
    rng = np.random.default_rng(seed)
    n = lambda *sh: rng.standard_normal(sh, dtype=np.float32)  # noqa: E731
    r, kk, vv = n(b, t, h, k), n(b, t, h, k), n(b, t, h, v_dim)
    w = np.exp(-np.exp(n(b, t, h, k) * decay_scale)).astype(np.float32)
    return r, kk, vv, w, n(h, k) * 0.1, n(b, h, k, v_dim) * 0.2


def _torch(xs, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in xs)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


def _jax(xs, dtype=jnp.float32):
    r, k, v, w, u, s0 = (jnp.asarray(x) for x in xs)
    return r.astype(dtype), k.astype(dtype), v.astype(dtype), w, u, s0


def _port(fn, xs, chunk, dtype=torch.float32):
    r, k, v, w, u, s0 = _torch(xs, dtype)
    if fn == "ops.wkv6":
        return ops.wkv6(r, k, v, w, u, s0, chunk=chunk)
    return linear_scan.wkv6_chunked(r, k, v, w, u, s0, chunk=min(chunk, r.shape[1]))


def _naive(xs):
    """The f32 step recurrence of the JAX package, token by token."""
    r, k, v, w, u, s = _jax(xs)
    ys = []
    for t in range(r.shape[1]):
        y, s = jax_wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, s)
        ys.append(y)
    return np.asarray(jnp.stack(ys, 1)), np.asarray(s)


def _close(port, ref_pair, tol):
    y, s = port
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert tuple(y.shape) == ref_pair[0].shape and tuple(s.shape) == ref_pair[1].shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_pair[0]), **tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_pair[1]), **tol)


@pytest.mark.parametrize("fn", list(PORT_FNS))
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
def test_wkv_matches_jax_kernel(shape, fn):
    xs = _inputs(*shape, seed=WKV_SHAPES.index(shape))
    pallas = jax_wkv6(*_jax(xs), chunk=32)
    _close(_port(fn, xs, 32), pallas, F32_TOL)
    _close(_port(fn, xs, 32), _naive(xs), F32_TOL)


@pytest.mark.parametrize("fn", list(PORT_FNS))
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_wkv_chunk_invariance_matches_jax(chunk, fn):
    xs = _inputs(2, 128, 2, 16, 16, seed=5)
    _close(_port(fn, xs, chunk), jax_wkv6(*_jax(xs), chunk=chunk), CHUNK_TOL)
    _close(_port(fn, xs, chunk), _naive(xs), CHUNK_TOL)


@pytest.mark.parametrize("fn", list(PORT_FNS))
def test_wkv_bf16_inputs_match_jax(fn):
    xs = _inputs(1, 64, 2, 16, 16, seed=6)
    y, s = _port(fn, xs, 32, dtype=torch.bfloat16)
    _close((y, s), jax_wkv6(*_jax(xs, jnp.bfloat16), chunk=32), F32_TOL)
    np.testing.assert_allclose(y.numpy(), _naive(xs)[0], atol=5e-2, rtol=0.05)


@pytest.mark.parametrize("fn", list(PORT_FNS))
def test_wkv_strong_decay_is_finite_and_matches_jax(fn):
    """decay_scale=1: log decays down to ~-20 a step, the regime where a
    single-reference factorisation overflows f32."""
    xs = _inputs(1, 128, 1, 8, 8, seed=7, decay_scale=1.0)
    _close(_port(fn, xs, 64), jax_wkv6(*_jax(xs), chunk=64), STRONG_TOL)
    _close(_port(fn, xs, 64), _naive(xs), STRONG_TOL)


@pytest.mark.parametrize("t", [16, 20, 24])
def test_ragged_prompt_runs_one_chunk_of_t(t):
    """chunk = min(32, T): a prompt shorter than the model's chunk is one
    chunk of T, also when T is not a power of two (the plain version clamps
    the straddle reference past the chunk's end, as JAX's gather does)."""
    xs = _inputs(2, t, 2, 16, 16, seed=t)
    _close(ops.wkv6(*_torch(xs), chunk=32), jax_wkv6(*_jax(xs), chunk=32), F32_TOL)
    _close(ops.wkv6(*_torch(xs), chunk=32),
           jax_wkv6_chunked(*_jax(xs), chunk=t), F32_TOL)


def test_s0_none_means_zeros():
    xs = _inputs(1, 64, 2, 16, 16, seed=8)
    r, k, v, w, u, _ = _torch(xs)
    none = ops.wkv6(r, k, v, w, u, None, chunk=32)
    zeros = ops.wkv6(r, k, v, w, u, torch.zeros(1, 2, 16, 16), chunk=32)
    for a, b in zip(none, zeros):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jr, jk, jv, jw, ju, _ = _jax(xs)
    _close(none, jax_wkv6(jr, jk, jv, jw, ju, None, chunk=32), F32_TOL)


def test_step_matches_jax_step():
    xs = _inputs(3, 1, 2, 16, 8, seed=9)
    r, k, v, w, u, s0 = _torch(xs)
    y, s = ref.wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    jr, jk, jv, jw, ju, js = _jax(xs)
    jy, jsn = jax_wkv6_step(jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], ju, js)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(jsn), rtol=1e-6, atol=1e-6)


def test_chunk_over_64_rejected():
    xs = _inputs(1, 128, 1, 8, 8)
    with pytest.raises(ValueError, match="chunk must be <= 64"):
        ops.wkv6(*_torch(xs), chunk=128)
    with pytest.raises(ValueError, match="chunk must be <= 64"):
        jax_wkv6(*_jax(xs), chunk=128)


def test_t_not_a_multiple_of_chunk_rejected():
    xs = _inputs(1, 48, 1, 8, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.wkv6(*_torch(xs), chunk=32)
    with pytest.raises(ValueError, match="not divisible"):
        linear_scan.wkv6_chunked(*_torch(xs), chunk=32)


@pytest.mark.parametrize("case", ["w_bf16", "float16", "mixed_dtypes", "k_128", "u_shape", "s0_shape",
                                  "strided_last_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    r, k, v, w, u, s0 = _torch(_inputs(1, 32, 2, 16, 16))
    if case == "w_bf16":
        w = w.to(torch.bfloat16)
    elif case == "float16":
        r, k, v = r.half(), k.half(), v.half()
    elif case == "mixed_dtypes":
        r = r.to(torch.bfloat16)
    elif case == "k_128":
        r, k, w = (torch.zeros(1, 32, 2, 128) for _ in range(3))
        u, s0 = torch.zeros(2, 128), torch.zeros(1, 2, 128, 16)
    elif case == "u_shape":
        u = u[:1]
    elif case == "s0_shape":
        s0 = s0[..., :8]
    elif case == "strided_last_dim":
        r = torch.zeros(1, 32, 2, 32)[..., ::2]
    with pytest.raises(ValueError):
        ops.wkv6(r, k, v, w, u, s0, chunk=32)


def test_kernel_binding_refuses_cpu_tensors():
    """The binding launches on CUDA tensors only; it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.wkv6_bthk(*_torch(_inputs(1, 32, 1, 8, 8)), chunk=32)


def test_cpu_calls_do_not_count_as_launches():
    before = ops.launches
    ops.wkv6(*_torch(_inputs(1, 32, 1, 8, 8)), chunk=32)
    assert ops.launches == before


# --- the kernel routes ----------------------------------------------------------

# (T, K, V, chunk asked for) -> the kernel that runs it on the card
ROUTE_CASES = [
    *[((t, k, v, 32), "wkv6_sm90" if k == v == 64 else "wkv6") for _, t, _, k, v in WKV_SHAPES],
    ((1024, 64, 64, 32), "wkv6_sm90"),  # rwkv6-3b's prefill scan
    ((128, 64, 64, 16), "wkv6_sm90"),
    ((192, 64, 64, 48), "wkv6_sm90"),
    ((128, 64, 64, 64), "wkv6_sm90"),
    ((16, 64, 64, 32), "wkv6"),  # ragged prompts: one chunk of T
    ((20, 64, 64, 32), "wkv6"),
    ((96, 64, 64, 24), "wkv6"),  # a chunk that is not a multiple of 16
    ((128, 64, 32, 32), "wkv6"),
]


@pytest.mark.parametrize("shape,expected", ROUTE_CASES, ids=str)
def test_route_picks_the_kernel_from_the_shapes(shape, expected):
    assert kernel.route(*shape) == expected


def test_rwkv_smoke_config_takes_the_tensor_core_route():
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("rwkv6-3b")
    hd = cfg.resolved_head_dim
    assert kernel.route(128, hd, hd, cfg.wkv_chunk) == "wkv6_sm90"


def test_cpu_calls_count_on_no_route():
    before, routes = ops.launches, dict(ops.route_launches)
    for shape in [(1, 64, 2, 64, 64), (1, 32, 1, 8, 8)]:
        ops.wkv6(*_torch(_inputs(*shape)), chunk=32)
    assert ops.launches == before and ops.route_launches == routes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_align_error_takes_the_models_views(dtype):
    dt = getattr(torch, dtype)
    x = torch.zeros(2, 64, 40, 64, dtype=dt)
    fused = torch.zeros(2, 64, 40, 4 * 64, dtype=dt)
    for view in (x, fused[..., :64], fused[..., 64:128], x[:1], x[:, 32:]):
        assert kernel.align_error(view) is None


@pytest.mark.parametrize("case", ["row_stride", "base_offset", "head_stride"])
def test_align_error_refuses_views_cp_async_cannot_copy(case):
    if case == "row_stride":  # rows of 65 f32: 260 bytes
        view = torch.zeros(1, 8, 1, 65)[..., :64]
    elif case == "base_offset":  # one bf16 element into the row
        view = torch.zeros(1, 8, 2, 72, dtype=torch.bfloat16)[..., 1:65]
    else:  # heads 66 bf16 apart: 132 bytes
        view = torch.zeros(1, 8, 2, 66, dtype=torch.bfloat16)[..., :64]
    assert kernel.align_error(view) is not None


# The tensor-core kernel's arithmetic, emulated in plain PyTorch (sub-chunks,
# decays as products, TF32 halves), against the Pallas kernel at K = V = 64:
# a wrong algorithm shows here before it runs on a card.
@pytest.mark.parametrize("chunk,decay_scale,dtype", [
    (16, 0.5, "float32"), (32, 0.5, "float32"), (64, 0.5, "float32"),
    (16, 1.0, "float32"), (32, 1.0, "float32"), (64, 1.0, "float32"),
    (32, 0.5, "bfloat16"), (64, 1.0, "bfloat16"),
])
def test_split_tf32_emulation_matches_jax_kernel(chunk, decay_scale, dtype):
    xs = _inputs(1, 128, 2, 64, 64, seed=chunk, decay_scale=decay_scale)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = ref.wkv6_split_tf32(*_torch(xs, tdt), chunk=chunk)
    tol = STRONG_TOL if decay_scale >= 1.0 else F32_TOL
    _close(out, jax_wkv6(*_jax(xs, jdt), chunk=chunk), tol)
