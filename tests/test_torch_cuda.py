"""The port's CUDA kernels (flash attention, wkv6) against their plain
PyTorch versions, the simulation engine against its CPU run and the
goldens, the sweep engine against its eager run and the looped engine, and
the async modes graph-replayed against eager, on the card.  Flash attention
has two routes, by dtype: f32 the scalar kernel, bf16 the wgmma + TMA
kernel; every attention case runs both.  wkv6 has two routes, by shape: K = V = 64 with whole chunks the
tensor-core kernel, every other shape the scalar one; each wkv case asserts
which ran.

Marked `cuda`: without an NVIDIA GPU every test here skips (a CUDA kernel has
no CPU mode).  This file imports nothing of JAX, so it runs on a GPU host
that has only PyTorch and nvcc:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import controller as ctl  # noqa: E402
from repro_torch.core import montecarlo as mc  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as strag  # noqa: E402
from repro_torch.core import sweep as sw  # noqa: E402
from repro_torch.core.aggregation import CommModel  # noqa: E402
from repro_torch.data import make_linreg_data  # noqa: E402
from repro_torch.kernels.attention import ops, ref  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkv_kernel  # noqa: E402
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
    # ragged T = S at every head dim: the bf16 route's 128 x 128 tiles end
    # inside the sequence, and TMA zero-fills the rest of the tile
    *[(1, t, t, 4, 2, hd, True, 0) for hd in (32, 64, 128) for t in (65, 100, 129, 200)],
    (2, 128, 200, 4, 2, 64, False, 0),  # non-causal, T != S, S ragged
    (1, 100, 65, 4, 1, 128, False, 0),  # non-causal, T > S, both ragged
    (1, 512, 512, 4, 2, 128, True, 96),  # a window that crosses tile boundaries
    (1, 512, 512, 4, 2, 32, True, 96),
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


def test_bf16_rows_that_see_no_key_are_zero_on_the_card(cuda_device):
    """Rows 191.. see no key (non-causal window, T > S); on the bf16 route the
    masked scores of a row that has seen no key must not count as exp(0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(1, 256, 2, 64, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(1, 128, 1, 64, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(1, 128, 1, 64, generator=gen, device=cuda_device).bfloat16()
    out = ops.flash_attention(q, k, v, causal=False, window=64)
    plain = ref.attention_ref(q, k, v, causal=False, window=64)
    torch.cuda.synchronize()
    assert not out[:, 191:].any() and bool(out[:, :191].float().abs().sum(-1).min() > 0)
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(), atol=2e-2, rtol=2e-2)


def _fused_qkv(b, t, h, kv, hd, *, width_pad=0, offset=0, dtype=torch.bfloat16, device):
    """q, k, v as column slices of one (B, T, (H + 2 KV) hd + pad) tensor,
    starting `offset` elements into each row."""
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(b, t, (h + 2 * kv) * hd + width_pad, generator=gen, device=device).to(dtype)
    cuts = [offset, offset + h * hd, offset + (h + kv) * hd, offset + (h + 2 * kv) * hd]
    return tuple(x[..., lo:hi].unflatten(-1, (-1, hd)) for lo, hi in zip(cuts, cuts[1:]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_reads_fused_qkv_slices(cuda_device, dtype):
    q, k, v = _fused_qkv(2, 200, 8, 2, 128, dtype=getattr(torch, dtype), device=cuda_device)
    assert q.stride(1) == (8 + 4) * 128 and not q.is_contiguous()
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    plain = ref.attention_ref(q, k, v, causal=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["row_stride_not_16_bytes", "base_not_16_bytes"])
def test_bf16_view_that_tma_refuses_raises_before_launch(cuda_device, case):
    if case == "row_stride_not_16_bytes":  # rows of (H + 2 KV) hd + 1 elements
        q, k, v = _fused_qkv(1, 128, 4, 2, 64, width_pad=1, device=cuda_device)
    else:  # every slice starts one element (2 bytes) into its row
        q, k, v = _fused_qkv(1, 128, 4, 2, 64, width_pad=8, offset=1, device=cuda_device)
    before = ops.launches
    with pytest.raises(ValueError, match="bf16 kernel cannot take this view"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.launches == before


# (B, T, H, K, V, chunk, decay_scale): tests/test_kernels.py's wkv shapes and
# chunk sizes, its strong-decay case, rwkv6-3b's prefill scan at batch 4 x
# 1024, and ragged prompts shorter than the model's chunk of 32 (one chunk of
# T, also when T is not a power of two).  K = V = 64 with whole chunks runs
# the tensor-core kernel (at every chunk it takes, and under strong decay);
# every other case the scalar one.
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
    (2, 128, 2, 64, 64, 16, 0.5),
    (2, 192, 2, 64, 64, 48, 0.5),
    (2, 128, 2, 64, 64, 64, 0.5),
    (1, 128, 2, 64, 64, 32, 1.0),
    (1, 128, 2, 64, 64, 64, 1.0),
]
# Kernel vs plain version, both f32 inside (bf16 r/k/v are widened before any
# arithmetic on both sides; the tensor-core kernel splits every f32 operand
# into two TF32 halves): tests/test_kernels.py's f32 tolerances, the looser
# ones under strong decay.
WKV_TOL = {0.5: dict(atol=5e-4, rtol=1e-3), 1.0: dict(atol=2e-3, rtol=5e-3)}


def _wkv_inputs(case, dtype, device):
    b, t, h, k, v, _, decay_scale = case
    rng = np.random.default_rng(sum(case[:5]))
    n = lambda *sh: rng.standard_normal(sh, dtype=np.float32)  # noqa: E731
    w = np.exp(-np.exp(n(b, t, h, k) * decay_scale)).astype(np.float32)
    f = lambda a, dt=torch.float32: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return (f(n(b, t, h, k), dtype), f(n(b, t, h, k), dtype), f(n(b, t, h, v), dtype), f(w),
            f(n(h, k) * 0.1), f(n(b, h, k, v) * 0.2))


def _expected_route(case):
    b, t, h, k, v, chunk, _ = case
    return "wkv6_sm90" if k == v == 64 and chunk <= t else "wkv6"


def _assert_wkv_close(out, plain, tol):
    (y, s), (py, ps) = out, plain
    assert y.dtype == s.dtype == torch.float32 and y.shape == py.shape and s.shape == ps.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **tol)
    np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_kernel_matches_plain_version(cuda_device, case, dtype):
    xs = _wkv_inputs(case, getattr(torch, dtype), cuda_device)
    chunk = case[5]
    route = _expected_route(case)
    before, before_route = wkv_ops.launches, wkv_ops.route_launches[route]
    y, s = wkv_ops.wkv6(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_ops.launches == before + 1 and wkv_ops.route_launches[route] == before_route + 1
    _assert_wkv_close((y, s), wkv_ref.wkv6_ref(*xs, chunk=min(chunk, case[1])), WKV_TOL[case[6]])


@pytest.mark.parametrize("k", [32, 64])
def test_wkv_kernel_reads_strided_views_and_zero_state(cuda_device, k):
    """r, k, v, w as views into wider tensors (the kernels read them through
    strides), and s0=None (zeros, not read); K = 64 takes the tensor-core
    kernel, K = 32 the scalar one."""
    b, t, h = 2, 64, 3
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    big = torch.randn(b, t, h, 4 * k, generator=gen, device=cuda_device)
    r, kk, v = big[..., :k], big[..., k:2 * k], big[..., 2 * k:3 * k]
    w = torch.exp(-torch.exp(big[..., 3 * k:] * 0.5))
    u = torch.randn(h, k, generator=gen, device=cuda_device) * 0.1
    route = "wkv6_sm90" if k == 64 else "wkv6"
    before = wkv_ops.route_launches[route]
    y, s = wkv_ops.wkv6(r, kk, v, w, u, None, chunk=32)
    py, ps = wkv_ref.wkv6_ref(r, kk, v, w, u, None, chunk=32)
    torch.cuda.synchronize()
    assert wkv_ops.route_launches[route] == before + 1
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **WKV_TOL[0.5])
    np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), **WKV_TOL[0.5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 32, 48, 64])
def test_wkv_sm90_every_chunk_matches_plain_version_under_strong_decay(cuda_device, chunk, dtype):
    case = (2, 192, 3, 64, 64, chunk, 1.0)
    xs = _wkv_inputs(case, getattr(torch, dtype), cuda_device)
    out = wkv_kernel.wkv6_bthk(*xs, chunk=chunk, kernel="wkv6_sm90")
    torch.cuda.synchronize()
    _assert_wkv_close(out, wkv_ref.wkv6_ref(*xs, chunk=chunk), WKV_TOL[1.0])


@pytest.mark.parametrize("case", ["row_stride_not_16_bytes", "u_base_not_8_bytes"])
def test_wkv_sm90_view_that_cp_async_refuses_raises_before_launch(cuda_device, case):
    xs = list(_wkv_inputs((1, 64, 2, 64, 64, 32, 0.5), torch.float32, cuda_device))
    if case == "row_stride_not_16_bytes":  # rows of 64 + 1 f32 elements
        xs[0] = torch.nn.functional.pad(xs[0], (0, 1))[..., :64]
        match = "cannot take this view"
    else:  # u one f32 element into its buffer
        xs[4] = torch.cat([torch.zeros(1, device=cuda_device), xs[4].flatten()])[1:].view(2, 64)
        match = "8 bytes"
    before = wkv_ops.launches
    with pytest.raises(ValueError, match=match):
        wkv_ops.wkv6(*xs, chunk=32)
    assert wkv_ops.launches == before


# ------------------------------------------------------------------ engine


def _sq(w, X, y):
    return (X @ w - y) ** 2


@pytest.mark.parametrize("partitionable", [True, False])
def test_prng_bits_on_the_card_equal_the_cpu_bits(cuda_device, partitionable):
    with prng.threefry_mode(partitionable):
        for dev_key in (prng.PRNGKey(42), prng.split(prng.PRNGKey(3), 4)):
            card = dev_key.to(cuda_device)
            for fn in (lambda k: prng.split(k, 3), lambda k: prng.fold_in(k, 7),
                       lambda k: prng.random_bits(k, (5, 7)), lambda k: prng.uniform(k, (33,)),
                       lambda k: prng.uniform(k, (9,), -2.0, 3.0), lambda k: prng.randint(k, (4, 6), 1, 101),
                       lambda k: prng.rademacher(k, (17,))):
                assert torch.equal(fn(card).cpu(), fn(dev_key))
            np.testing.assert_allclose(prng.normal(card, (64,)).cpu().numpy(),
                                       prng.normal(dev_key, (64,)).numpy(), rtol=1e-5, atol=1e-6)


GOLDEN_CONTROLLERS = {
    "fixed": dict(k=2),
    "pflug": dict(k0=1, step=1, thresh=3, burnin=5),
    "sketched_pflug": dict(k0=1, step=1, thresh=3, burnin=5, sketch_dim=8),
    "schedule": dict(switch_times=[2.0, 6.0], k0=1, step=2),
    "variance_ratio": dict(k0=1, step=2, burnin=10),
}


@pytest.mark.parametrize("name", list(GOLDEN_CONTROLLERS))
def test_sync_goldens_on_the_card(cuda_device, name):
    """tests/goldens/quadratic_mc.npz (the JAX package, legacy threefry): k
    exact, time within 1e-6 (log1p may differ by an ulp)."""
    from pathlib import Path

    gold = np.load(Path(__file__).parent / "goldens" / "quadratic_mc.npz")
    n, d = int(gold["n_workers"]), int(gold["d"])
    with prng.threefry_mode(False):
        data = make_linreg_data(prng.PRNGKey(int(gold["data_seed"])), m=int(gold["m"]), d=d, device=cuda_device)
        keys = prng.split(prng.PRNGKey(int(gold["key_seed"]), device=cuda_device), int(gold["n_replicas"]))
        res = mc.run_monte_carlo(_sq, torch.zeros(d, device=cuda_device), data.X, data.y, n_workers=n,
                                 controller=ctl.get_controller(name, n, **GOLDEN_CONTROLLERS[name]),
                                 straggler=strag.Exponential(1.0), eta=float(gold["eta"]),
                                 num_iters=int(gold["num_iters"]), keys=keys,
                                 eval_every=int(gold["eval_every"]), device=cuda_device)
    np.testing.assert_array_equal(res.k.cpu().numpy(), gold[f"{name}__sync__k"])
    np.testing.assert_allclose(res.time.cpu().numpy(), gold[f"{name}__sync__time"], rtol=1e-6)
    np.testing.assert_allclose(res.loss.cpu().numpy(), gold[f"{name}__sync__loss"], rtol=1e-4)


# 77 iterations in blocks of 20: graphs of 8, 4 and 1 iterations at unroll 8
@pytest.mark.parametrize("case,unroll", [("pflug", 8), ("pflug", 1), ("sketched_pflug", 8), ("schedule", 8),
                                         ("fleet", 8), ("fleet", 3)])
def test_graph_replayed_run_equals_eager_run_bitwise(cuda_device, case, unroll):
    n, d = 6, 4
    data = make_linreg_data(prng.PRNGKey(0), m=60, d=d, device=cuda_device)
    straggler = strag.Exponential(1.0)
    if case == "fleet":
        straggler = strag.WorkerFleet([strag.Exponential(1.0), strag.Pareto(1.0, 3.0), strag.Bimodal(1.0, 4.0, 0.3),
                                       strag.Deterministic(1.5), strag.ShiftedExponential(0.2, 1.0)],
                                      strag.RateSchedule((2.0, 5.0), (0.5, 2.0), mode="linear"))
        controller = ctl.PflugController(n_workers=5, k0=1, thresh=2, burnin=3)
    else:
        controller = ctl.get_controller(case, n, **GOLDEN_CONTROLLERS[case])
    runs = [mc.run_monte_carlo(_sq, torch.zeros(d, device=cuda_device), data.X, data.y, n_workers=n,
                               controller=controller, straggler=straggler, eta=0.005, num_iters=77, eval_every=20,
                               unroll=unroll, key=prng.PRNGKey(5), n_replicas=3, device=cuda_device,
                               capture=capture)
            for capture in (True, False, True)]
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f  # a replay of cached graphs


# ------------------------------------------------------------------- sweep


def _mixed_grid(eta=0.005, k_fixed=2):
    """Every controller kind, every family, a comm model and a fleet of 5
    active workers of 6 slots under a rate schedule."""
    n = 6
    fleet = strag.WorkerFleet([strag.Exponential(1.0), strag.Pareto(1.0, 3.0), strag.Bimodal(1.0, 4.0, 0.3),
                               strag.Deterministic(1.5), strag.ShiftedExponential(0.2, 1.0)],
                              strag.RateSchedule((2.0, 5.0), (0.5, 2.0), mode="linear"))
    return [
        sw.SweepCase(ctl.PflugController(n, k0=1, step=1, thresh=2, burnin=3), strag.Exponential(1.0), eta,
                     label="pflug"),
        sw.SweepCase(ctl.FixedKController(n, k=k_fixed), strag.Pareto(1.0, 3.0), eta * 0.8, label="fixed"),
        sw.SweepCase(ctl.VarianceRatioController(n, k0=1, step=2, burnin=10), strag.Bimodal(1.0, 4.0, 0.3), eta,
                     label="vr"),
        sw.SweepCase(ctl.ScheduleController(n, [2.0, 6.0], k0=1, step=2), strag.ShiftedExponential(0.2, 1.0), eta,
                     comm=CommModel(0.1, 0.05), label="schedule"),
        sw.SweepCase(ctl.SketchedPflugController(n, k0=1, step=1, thresh=3, burnin=5, sketch_dim=8),
                     strag.Exponential(0.5), eta, label="sketched"),
        sw.SweepCase(ctl.PflugController(5, k0=1, thresh=2, burnin=3), fleet, eta, label="fleet"),
    ]


def _sweep(device, cases, **kw):
    data = make_linreg_data(prng.PRNGKey(0), m=60, d=4, device=device)
    args = dict(n_workers=6, num_iters=77, eval_every=20, key=prng.PRNGKey(5), n_replicas=3, device=device)
    args.update(kw)
    return sw.run_sweep(_sq, torch.zeros(4, device=device), data.X, data.y, cases=cases, **args)


# 77 iterations in blocks of 20: graphs of 6, 2 and 1 iterations at unroll None (6), 3 and 2 at unroll 3
@pytest.mark.parametrize("unroll", [None, 3])
def test_sweep_graph_replayed_equals_eager_bitwise(cuda_device, unroll):
    cases = _mixed_grid()
    runs = [_sweep(cuda_device, cases, unroll=unroll, capture=capture) for capture in (True, False, True)]
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f  # a replay of cached graphs
    assert bool(torch.isfinite(runs[0].loss).all())


def test_sweep_matches_the_looped_engine_on_the_card(cuda_device):
    """Each cell against `run_monte_carlo` with the same keys: k equal, time
    within 1e-5 and loss within 1e-4 relative (the library's products and
    reductions may round differently at 18 lanes than at 3)."""
    cases = _mixed_grid()
    res = _sweep(cuda_device, cases)
    data = make_linreg_data(prng.PRNGKey(0), m=60, d=4, device=cuda_device)
    keys = prng.split(prng.PRNGKey(5, device=cuda_device), 3)
    for g, case in enumerate(cases):
        want = mc.run_monte_carlo(_sq, torch.zeros(4, device=cuda_device), data.X, data.y, n_workers=6,
                                  controller=case.controller, straggler=case.straggler, eta=case.eta, comm=case.comm,
                                  num_iters=77, eval_every=20, keys=keys, device=cuda_device)
        got = res.cell(g)
        assert torch.equal(got.k, want.k), case.label
        np.testing.assert_allclose(got.time.cpu().numpy(), want.time.cpu().numpy(), rtol=1e-5, err_msg=case.label)
        np.testing.assert_allclose(got.loss.cpu().numpy(), want.loss.cpu().numpy(), rtol=1e-4, err_msg=case.label)


def test_repopulated_sweep_replays_its_graphs(cuda_device):
    """A grid of the same signature and shapes with other eta and k loads
    into the captured buffers: no new capture, and the result of a fresh
    capture and of an eager run."""
    sw.clear_sweep_cache()
    try:
        _sweep(cuda_device, _mixed_grid())
        assert sw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        other = _mixed_grid(eta=0.003, k_fixed=4)
        got = _sweep(cuda_device, other)
        assert sw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        eager = _sweep(cuda_device, other, capture=False)
        sw.clear_sweep_cache()
        fresh = _sweep(cuda_device, other)
        for f in ("time", "loss", "k"):
            assert torch.equal(getattr(got, f), getattr(fresh, f)), f
            assert torch.equal(getattr(got, f), getattr(eager, f)), f
    finally:
        sw.clear_sweep_cache()


# ------------------------------------------------------------- async modes


def _async_fleet():
    """5 active workers of 6 slots under a rate schedule: every family."""
    return strag.WorkerFleet([strag.Exponential(1.0), strag.Pareto(1.0, 3.0), strag.Bimodal(1.0, 4.0, 0.3),
                              strag.Deterministic(1.5), strag.ShiftedExponential(0.2, 1.0)],
                             strag.RateSchedule((2.0, 5.0), (0.5, 2.0), mode="linear"))


# 37 iterations in blocks of 10: graphs of 4, 2 and 1 iterations at unroll 4, 3 and 1 at unroll 3
@pytest.mark.parametrize("case", ["exp", "fleet_comm"])
@pytest.mark.parametrize("unroll", [4, 3])
@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_async_graph_replayed_run_equals_eager_run_bitwise(cuda_device, mode, unroll, case):
    n, d = 6, 4
    data = make_linreg_data(prng.PRNGKey(0), m=60, d=d, device=cuda_device)
    kw = dict(controller=ctl.PflugController(n_workers=n, k0=1, thresh=2, burnin=3), straggler=strag.Exponential(1.0))
    if case == "fleet_comm":
        kw = dict(controller=ctl.FixedKController(n_workers=5, k=2), straggler=_async_fleet(),
                  comm=CommModel(0.1, 0.05))
    runs = [mc.run_monte_carlo(_sq, torch.zeros(d, device=cuda_device), data.X, data.y, n_workers=n, eta=0.005,
                               num_iters=37, eval_every=10, unroll=unroll, key=prng.PRNGKey(5), n_replicas=3,
                               mode=mode, device=cuda_device, capture=capture, **kw)
            for capture in (True, False, True)]
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f  # a replay of cached graphs
    assert bool(torch.isfinite(runs[0].loss).all()) and bool(torch.isfinite(runs[0].time).all())


def _mode_grid(eta=0.005, k_fixed=2):
    """Sync, kasync and kbatch cells over two controller kinds, a comm model
    and the fleet."""
    n = 6
    return [
        sw.SweepCase(ctl.PflugController(n, k0=1, step=1, thresh=2, burnin=3), strag.Exponential(1.0), eta,
                     label="sync"),
        sw.SweepCase(ctl.FixedKController(n, k=k_fixed), strag.Pareto(1.0, 3.0), eta, label="kasync", mode="kasync"),
        sw.SweepCase(ctl.PflugController(n, k0=1, step=1, thresh=2, burnin=3), strag.Exponential(1.0), eta,
                     comm=CommModel(0.1, 0.05), label="kbatch", mode="kbatch"),
        sw.SweepCase(ctl.FixedKController(5, k=2), _async_fleet(), eta, label="kasync_fleet", mode="kasync"),
    ]


def test_mixed_mode_sweep_graph_replayed_equals_eager_and_looped(cuda_device):
    """The mixed-mode grid graph-replayed against eager (bitwise), each cell
    against the looped engine with the same keys (k and time equal, loss
    within 1e-4 relative), and a repopulated grid with no new capture."""
    cases = _mode_grid()
    sw.clear_sweep_cache()
    try:
        runs = [_sweep(cuda_device, cases, num_iters=37, eval_every=10, capture=capture)
                for capture in (True, False, True)]
        for f in ("time", "loss", "k"):
            assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
            assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f
        data = make_linreg_data(prng.PRNGKey(0), m=60, d=4, device=cuda_device)
        keys = prng.split(prng.PRNGKey(5, device=cuda_device), 3)
        for g, case in enumerate(cases):
            want = mc.run_monte_carlo(_sq, torch.zeros(4, device=cuda_device), data.X, data.y, n_workers=6,
                                      controller=case.controller, straggler=case.straggler, eta=case.eta,
                                      comm=case.comm, num_iters=37, eval_every=10, keys=keys, mode=case.mode,
                                      device=cuda_device)
            got = runs[0].cell(g)
            assert torch.equal(got.k, want.k) and torch.equal(got.time, want.time), case.label
            np.testing.assert_allclose(got.loss.cpu().numpy(), want.loss.cpu().numpy(), rtol=1e-4, err_msg=case.label)
        captures = sw.sweep_cache_stats()["traces"]
        _sweep(cuda_device, _mode_grid(eta=0.003, k_fixed=3), num_iters=37, eval_every=10)
        assert sw.sweep_cache_stats()["traces"] == captures
    finally:
        sw.clear_sweep_cache()


@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_deterministic_ties_on_the_card_follow_the_cpu(cuda_device, mode):
    """Every clock tied: each event takes the lowest index first, on the
    card as on the CPU, so the times (sums of 1.0) and k are equal and the
    loss agrees to the rounding of the card's products."""
    data = {dev: make_linreg_data(prng.PRNGKey(0), m=60, d=4, device=dev) for dev in (cuda_device, "cpu")}
    runs = {dev: mc.run_monte_carlo(_sq, torch.zeros(4, device=dev), data[dev].X, data[dev].y, n_workers=6,
                                    controller=ctl.FixedKController(n_workers=6, k=1 if mode == "kasync" else 3),
                                    straggler=strag.Deterministic(1.0), eta=0.005, num_iters=40, eval_every=10,
                                    key=prng.PRNGKey(2), n_replicas=2, mode=mode, device=dev)
            for dev in (cuda_device, "cpu")}
    card, cpu = runs[cuda_device], runs["cpu"]
    assert torch.equal(card.time.cpu(), cpu.time) and torch.equal(card.k.cpu(), cpu.k)
    np.testing.assert_allclose(card.loss.cpu().numpy(), cpu.loss.numpy(), rtol=1e-5)


# --------------------------------------------------------- autograd guard


@pytest.mark.parametrize("kernel_name", ["flash_attention", "wkv6"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_refuse_grad_mode_and_run_without_it(cuda_device, kernel_name, dtype):
    dt = getattr(torch, dtype)
    if kernel_name == "flash_attention":
        xs = [torch.randn(sh, device=cuda_device).to(dt) for sh in ((1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64))]
        fn, counter = (lambda *a: ops.flash_attention(*a, causal=True)), ops
        plain = ref.attention_ref(*xs, causal=True)
    else:
        xs = list(_wkv_inputs((1, 64, 2, 64, 64, 32, 0.5), dt, cuda_device))
        fn, counter = (lambda *a: wkv_ops.wkv6(*a, chunk=32)), wkv_ops
        plain = wkv_ref.wkv6_ref(*xs, chunk=32)
    xs[0].requires_grad_(True)
    before = counter.launches
    with pytest.raises(RuntimeError, match="item 6"):
        fn(*xs)
    assert counter.launches == before
    with torch.no_grad():
        out = fn(*xs)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if kernel_name == "flash_attention":
        np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    else:
        _assert_wkv_close(out, plain, WKV_TOL[0.5])


def test_run_monte_carlo_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine rightly runs on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mc.run_monte_carlo(_sq, torch.zeros(4), torch.ones(12, 4), torch.ones(12), n_workers=3,
                           controller=ctl.FixedKController(n_workers=3, k=2), straggler=strag.Exponential(1.0),
                           eta=0.01, num_iters=4, key=prng.PRNGKey(0), n_replicas=2)
