"""The port's CUDA kernels (flash attention, wkv6) against their plain
PyTorch versions, the simulation engine against its CPU run and the
goldens, the sweep engine against its eager run and the looped engine, the
async modes graph-replayed against eager, faults and robust aggregation
(graph-replayed against eager, a forced grid against the looped engine, the
stable sort's signed zeros), and the LM training path (the train step
against its CPU run, no per-worker snapshots in a sync step, the kernels'
guard under `torch.func.grad`, `quickstart --setup lm` graph-replayed
against eager), the MoE and hybrid families (the kernel at their
prefill shapes, the MoE layer and the SSM scan against their CPU runs),
and the vlm, encdec and large dense archs (the kernel at head dims 192 and
256 and at their prefill shapes, serving and the train step against their
CPU runs), the experiment entry points (`train --simulate` and
fig_hetero's grid against their CPU runs), and distribution on a world of
one rank (both wrappers on DTensors against the mesh-free call, a mesh
sweep graph-replayed against eager, the vocab-parallel CE against the
mesh-free one), the flash kernel's head pieces of a 16-way model axis
joined against the whole call, and blocked attention against the naive
path, and the dry
run of one job per site of the sharded path that DTensor on the card
refused until the port ran it on local shards, on the card.  Flash attention
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
from repro_torch.core import faults  # noqa: E402
from repro_torch.core import montecarlo as mc  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as strag  # noqa: E402
from repro_torch.core import sweep as sw  # noqa: E402
from repro_torch.core.aggregation import CommModel  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.data import TokenStream, make_linreg_data  # noqa: E402
from repro_torch.kernels.attention import ops, ref  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv import ref as wkv_ref  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import optimizers as optim  # noqa: E402

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
    # the prefill attention of qwen3-moe-30b-a3b, granite-moe-1b-a400m (batch
    # 4, prompt 1024) and hymba-1.5b (prompt 2048, 25 heads over 5 kv heads,
    # its 1024-token window)
    (4, 1024, 1024, 32, 4, 64, True, 0),
    (4, 1024, 1024, 16, 8, 64, True, 0),
    (4, 2048, 2048, 25, 5, 64, True, 1024),
    # head dims 192 and 256 (the bf16 route's 64-key tiles): ragged T = S,
    # MQA, non-causal with S ragged, a window across tiles
    *[(1, t, t, 4, 2, hd, True, 0) for hd in (192, 256) for t in (65, 100, 129, 200)],
    *[(2, 256, 256, 8, 1, hd, True, 0) for hd in (192, 256)],
    *[(1, 128, 300, 4, 2, hd, False, 0) for hd in (192, 256)],
    *[(1, 512, 512, 4, 2, hd, True, 96) for hd in (192, 256)],
    # the prefill attention at batch 4 of seamless-m4t-medium's decoder
    # (prompt 1024), paligemma-3b (256 patches + prompt 1024, MQA, hd 256),
    # qwen1.5-110b (hd 128, 64 heads over 8) and nemotron-4-340b (hd 192, 96
    # heads over 8)
    (4, 1024, 1024, 16, 16, 64, True, 0),
    (4, 1280, 1280, 8, 1, 256, True, 0),
    (4, 1024, 1024, 64, 8, 128, True, 0),
    (4, 1024, 1024, 96, 8, 192, True, 0),
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


# ------------------------------------------------- faults and robust aggregation


# (mode, plan, aggregator): each family and each robust aggregator the mode takes
FAULT_CELLS = [
    ("sync", ("random_gauss", 0.25, 0.0, 2.0), "geomedian"),
    ("sync", ("sign_flip", 0.25, 0.0, 1.0), "median"),
    ("kasync", ("rescale", 0.25, 1.0, -4.0), "trimmed"),
    ("kasync", ("crash", 0.5, 2.0, 1.0), "mean"),
    ("kbatch", ("crash", 0.5, 2.0, 1.0), "mean"),
    ("kbatch", ("random_gauss", 0.25, 1.0, 2.0), "mean"),
]


def _fault_plan(n, spec):
    fam, frac, onset, param = spec
    return faults.byzantine_plan(n, frac, fam, onset=onset, param=param)


@pytest.mark.parametrize("cell", FAULT_CELLS, ids=lambda c: f"{c[0]}-{c[1][0]}-{c[2]}")
def test_faulty_looped_cell_graph_replayed_equals_eager_bitwise(cuda_device, cell):
    mode, spec, agg = cell
    n, d = 8, 4
    data = make_linreg_data(prng.PRNGKey(0), m=80, d=d, device=cuda_device)
    runs = [mc.run_monte_carlo(_sq, torch.zeros(d, device=cuda_device), data.X, data.y, n_workers=n,
                               controller=ctl.FixedKController(n_workers=n, k=3), straggler=strag.Exponential(1.0),
                               eta=0.005, num_iters=37, eval_every=10, key=prng.PRNGKey(5), n_replicas=3, mode=mode,
                               fault=_fault_plan(n, spec), agg=agg, agg_param=0.25, device=cuda_device,
                               capture=capture)
            for capture in (True, False, True)]
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f  # a replay of cached graphs
    assert bool(torch.isfinite(runs[0].loss).all())


def _forced_fault_grid(eta=0.005, frac=0.25):
    """Every fault family and robust aggregator, with a clean cell, over
    the three modes (the reference's forced grid, tests/test_faults.py)."""
    n, exp, c = 8, strag.Exponential(1.0), ctl.FixedKController(n_workers=8, k=3)
    plan = faults.byzantine_plan
    return [
        sw.SweepCase(c, exp, eta, label="clean"),
        sw.SweepCase(c, exp, eta, label="flip", fault=plan(n, frac, "sign_flip")),
        sw.SweepCase(c, exp, eta, label="gauss_gm", fault=plan(n, frac, "random_gauss", param=2.0), agg="geomedian"),
        sw.SweepCase(c, exp, eta, label="rescale_trim_ka", fault=plan(n, frac, "rescale", param=-4.0), agg="trimmed",
                     agg_param=0.25, mode="kasync"),
        sw.SweepCase(c, exp, eta, label="crash_ka", fault=plan(n, 2 * frac, "crash", onset=2.0), mode="kasync"),
        sw.SweepCase(c, exp, eta, label="crash_kb", fault=plan(n, 2 * frac, "crash", onset=2.0), mode="kbatch"),
        sw.SweepCase(c, exp, eta, label="flip_median", fault=plan(n, frac, "sign_flip"), agg="median"),
    ]


def test_forced_fault_grid_graph_replayed_equals_eager_and_looped(cuda_device):
    """The forced grid graph-replayed against eager (bitwise), each cell
    against the looped engine with the same keys (time and k equal, loss
    within 1e-4 relative), and a repopulated grid with no new capture."""
    cases = _forced_fault_grid()
    data = make_linreg_data(prng.PRNGKey(0), m=80, d=4, device=cuda_device)
    keys = prng.split(prng.PRNGKey(5, device=cuda_device), 3)

    def grid(cells, capture=True):
        return sw.run_sweep(_sq, torch.zeros(4, device=cuda_device), data.X, data.y, n_workers=8, cases=cells,
                            num_iters=37, eval_every=10, keys=keys, device=cuda_device, capture=capture)

    sw.clear_sweep_cache()
    try:
        runs = [grid(cases, capture) for capture in (True, False, True)]
        for f in ("time", "loss", "k"):
            assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
            assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f
        for g, case in enumerate(cases):
            want = mc.run_monte_carlo(_sq, torch.zeros(4, device=cuda_device), data.X, data.y, n_workers=8,
                                      controller=case.controller, straggler=case.straggler, eta=case.eta,
                                      num_iters=37, eval_every=10, keys=keys, mode=case.mode, fault=case.fault,
                                      agg=case.agg, agg_param=case.agg_param, device=cuda_device)
            got = runs[0].cell(g)
            assert torch.equal(got.k, want.k) and torch.equal(got.time, want.time), case.label
            np.testing.assert_allclose(got.loss.cpu().numpy(), want.loss.cpu().numpy(), rtol=1e-4, err_msg=case.label)
        captures = sw.sweep_cache_stats()["traces"]
        grid(_forced_fault_grid(eta=0.003, frac=0.375))
        assert sw.sweep_cache_stats()["traces"] == captures
    finally:
        sw.clear_sweep_cache()


def test_stable_sort_keeps_signed_zeros_on_the_card(cuda_device):
    """The coordinate median and the trimmed mean on the card equal the
    CPU's bit for bit, the sign of a median of zeros included: the stable
    sort keeps -0.0 and 0.0 in their order."""
    from repro_torch.core import aggregation

    rng = np.random.default_rng(0)
    mat = rng.normal(size=(20, 64)).astype(np.float32)
    mat[:, 0] = np.where(rng.random(20) < 0.5, -0.0, 0.0)
    mat[:, 1] = 1.5
    mask = (rng.random(20) < 0.7).astype(np.float32)
    k = torch.tensor(int(mask.sum()), dtype=torch.int32)
    cpu_args = (torch.from_numpy(mat), torch.from_numpy(mask), k)
    args = tuple(a.to(cuda_device) for a in cpu_args)
    got, want = aggregation.coordinate_median_rows(*args).cpu(), aggregation.coordinate_median_rows(*cpu_args)
    assert torch.equal(got, want) and torch.equal(torch.signbit(got), torch.signbit(want))
    vals = torch.where(args[1][:, None] > 0, args[0], float("inf"))
    order = torch.sort(vals, dim=0, stable=True).indices.cpu()
    assert torch.equal(order, torch.sort(vals.cpu(), dim=0, stable=True).indices)
    np.testing.assert_allclose(aggregation.trimmed_mean_rows(*args, 0.2).cpu().numpy(),
                               aggregation.trimmed_mean_rows(*cpu_args, 0.2).numpy(), rtol=1e-6, atol=1e-7)


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
    with pytest.raises(RuntimeError, match="no backward kernel"):
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


# --------------------------------------------------------- the training path


def _frontend_inputs(cfg, batch, seed, device):
    """Seeded random vlm patches or encdec frames ({} for the other
    families); never zeros, which would leave the cross-attention inert."""
    n = {"vlm": cfg.vlm_patches, "encdec": cfg.encoder_frames}.get(cfg.family)
    if n is None:
        return {}
    x = np.random.default_rng(1000 + seed).standard_normal((batch, n, cfg.d_model), dtype=np.float32)
    return {"patches" if cfg.family == "vlm" else "frames": torch.from_numpy(x).to(device)}


def _train_run(arch, mode, n_micro, device, seq, n_steps=3):
    """3 train steps of a smoke config (f32) from weights drawn on the CPU
    from seed 0 (vlm and encdec fed `_frontend_inputs`): [(k, sim_time, ce)]
    and the kernels' launches."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device)
    params = tree_map(lambda a: a.to(device), build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))
    opt, ctrl = optim.sgd(0.3, momentum=0.9), ctl.PflugController(n_workers=4, k0=1, step=1, thresh=0, burnin=0)
    step = steps.make_train_step(model, opt, ctrl, strag.Exponential(1.0), 4, CommModel(0.1, 0.05), n_micro=n_micro,
                                 mode=mode)
    state = steps.init_train_state(opt, ctrl, params)
    stream = TokenStream(cfg.vocab_size, seq, 8, seed=0, device=device)
    key = prng.PRNGKey(7, device=device)
    before = (ops.launches, wkv_ops.launches)
    out = []
    for i in range(n_steps):
        tokens, targets = stream.batch_at(i)
        key, sub = prng.split(key).unbind(0)
        state, m = step(state, {"tokens": tokens, "targets": targets, **_frontend_inputs(cfg, 8, i, device)}, sub)
        out.append((int(m["k"]), float(m["sim_time"]), float(m["ce"])))
    return out, (ops.launches - before[0], wkv_ops.launches - before[1])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b", "granite-moe-1b-a400m", "hymba-1.5b"])
@pytest.mark.parametrize("mode,n_micro", [("sync", 1), ("kasync", 1), ("kbatch", 1), ("sync", 2)])
def test_train_step_on_the_card_follows_the_cpu(cuda_device, arch, mode, n_micro):
    """k equal, sim_time within 1e-6 and ce within 1e-5 relative; at T = 128
    the eval forward of every step launches the kernels (one a layer), the
    gradients none."""
    card, launches = _train_run(arch, mode, n_micro, cuda_device, 128)
    cpu, _ = _train_run(arch, mode, n_micro, "cpu", 128)
    for (k, t, ce), (k0, t0, ce0) in zip(card, cpu):
        assert k == k0
        np.testing.assert_allclose(t, t0, rtol=1e-6)
        np.testing.assert_allclose(ce, ce0, rtol=1e-5)
    n_layers = get_smoke_config(arch).n_layers
    assert launches == ((0, 3 * n_layers) if arch == "rwkv6-3b" else (3 * n_layers, 0))


@pytest.mark.parametrize("mode", ["sync", "kasync"])
def test_sync_train_step_holds_no_worker_snapshots(cuda_device, mode):
    """A sync step's peak memory above its state stays below 3x the
    parameters (the gradient and one leaf's update temporaries), where
    n_workers = 8 snapshots would add 8x; a kasync step builds its 8."""
    cfg = get_smoke_config("llama3.2-3b").replace(n_layers=4, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
                                                   vocab_size=4096)
    model = build_model(cfg, cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    param_bytes = sum(a.numel() * a.element_size() for _, a in leaves_with_path(params))
    opt, ctrl = optim.sgd(0.1), ctl.FixedKController(n_workers=8, k=4)
    step = steps.make_train_step(model, opt, ctrl, strag.Exponential(1.0), 8, mode=mode)
    state = steps.init_train_state(opt, ctrl, params)
    tokens, targets = TokenStream(cfg.vocab_size, 16, 8, device=cuda_device).batch_at(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, {"tokens": tokens, "targets": targets}, prng.PRNGKey(0, device=cuda_device))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert bool(torch.isfinite(m["ce"]))
    if mode == "sync":
        assert extra < 3 * param_bytes, (extra, param_bytes)
    else:
        assert extra >= 8 * param_bytes, (extra, param_bytes)


@pytest.mark.parametrize("kernel_name", ["flash_attention", "wkv6"])
def test_kernels_refuse_torch_func_grad(cuda_device, kernel_name):
    """Under `torch.func.grad` the inputs are wrapped tensors that require
    grad: the wrappers raise before they launch."""
    if kernel_name == "flash_attention":
        xs = [torch.randn(sh, device=cuda_device) for sh in ((1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64))]
        fn, counter = (lambda q: ops.flash_attention(q, xs[1], xs[2], causal=True).sum()), ops
    else:
        xs = list(_wkv_inputs((1, 64, 2, 64, 64, 32, 0.5), torch.float32, cuda_device))
        fn, counter = (lambda r: wkv_ops.wkv6(r, *xs[1:], chunk=32)[0].sum()), wkv_ops
    before = counter.launches
    with pytest.raises(RuntimeError, match="no backward kernel"):
        torch.func.grad(fn)(xs[0])
    assert counter.launches == before


def test_setup_lm_graph_replayed_equals_eager(cuda_device):
    graph = quickstart.run_lm(iters=60, replicas=2, device=cuda_device, capture=True)
    eager = quickstart.run_lm(iters=60, replicas=2, device=cuda_device, capture=False)
    for label, r in graph["results"].items():
        e = eager["results"][label]
        assert torch.equal(r.time, e.time) and torch.equal(r.k, e.k) and torch.equal(r.loss, e.loss), label


# ------------------------------------------------- the MoE and hybrid families

# The MoE smoke configs' head dim 16 (the f32 route only), causal and windowed.
HD16_SHAPES = [(2, 128, 128, 8, 4, 16, True, 0), (2, 128, 128, 8, 2, 16, True, 32), (1, 100, 100, 4, 2, 16, True, 0)]


@pytest.mark.parametrize("shape", HD16_SHAPES, ids=str)
def test_f32_route_takes_head_dim_16(cuda_device, shape):
    test_flash_attention_kernel_matches_plain_version(cuda_device, shape, "float32")


def test_bf16_route_refuses_head_dim_16(cuda_device):
    q, k, v = (torch.zeros(sh, dtype=torch.bfloat16, device=cuda_device)
               for sh in ((1, 128, 4, 16), (1, 128, 2, 16), (1, 128, 2, 16)))
    before = ops.launches
    with pytest.raises(ValueError, match="head_dim 16"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.launches == before


def _moe_cases():
    small = get_smoke_config("granite-moe-1b-a400m")
    wide = small.replace(d_model=512, d_ff=256, n_experts=16, moe_top_k=4)
    return [(cfg, d, cf) for cfg in (small, wide) for d in ("einsum", "gather", "hybrid", "scatter")
            for cf in (0.5, 1.25)]


@pytest.mark.parametrize("cfg,dispatch,cf", _moe_cases(),
                         ids=lambda c: f"E{c.n_experts}" if hasattr(c, "n_experts") else str(c))
def test_moe_layer_on_the_card_follows_the_cpu(cuda_device, cfg, dispatch, cf):
    """f32 with TF32 off: the routing (experts, queue positions, kept flags)
    equal to the CPU's, y within 1e-5, the load-balance loss within 1e-6."""
    from repro_torch.models import moe

    cfg = cfg.replace(moe_dispatch=dispatch, capacity_factor=cf)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 64, cfg.d_model), dtype=np.float32) * 0.5)
    card = tree_map(lambda a: a.to(cuda_device), params)
    for got, want in zip(moe.route(card, cfg, x.to(cuda_device))[:3:2], moe.route(params, cfg, x)[:3:2]):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(moe.route(card, cfg, x.to(cuda_device))[1].cpu() > 0, moe.route(params, cfg, x)[1] > 0)
    y, aux = moe.moe_layer(card, cfg, x.to(cuda_device))
    y0, aux0 = moe.moe_layer(params, cfg, x)
    np.testing.assert_allclose(y.cpu().numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux0), rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssm_chunked_on_the_card_follows_the_cpu(cuda_device, chunk):
    """Within 1e-5 of the output's max |y|: the card's f32 products (TF32
    off) sum in another order than the CPU's, and at hymba's head width
    (P = 64, N = 16) |y| reaches ~10, so an element near zero differs by
    ~2e-5 absolute (seen) where the max differs by ~1e-6 relative."""
    from repro_torch.models import linear_scan

    rng = np.random.default_rng(chunk)
    b, t, h, p, n = 2, 256, 25, 64, 16
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))  # noqa: E731
    xs = (f(b, t, h, p), torch.nn.functional.softplus(f(b, t, h)), -torch.exp(f(h) * 0.5), f(b, t, h, n),
          f(b, t, h, n), f(b, h, n, p) * 0.3)
    y, s = linear_scan.ssm_chunked(*(a.to(cuda_device) for a in xs), chunk=chunk)
    y0, s0 = linear_scan.ssm_chunked(*xs, chunk=chunk)
    for got, want in ((y, y0), (s, s0)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ------------------------------------- the vlm, encdec and large dense archs

# nemotron-4-340b's smoke config's head dim 48 (the f32 route only)
HD48_SHAPES = [(2, 128, 128, 8, 2, 48, True, 0), (1, 100, 100, 4, 2, 48, True, 0), (1, 256, 256, 4, 2, 48, True, 64)]
NEW_ARCHS = ["seamless-m4t-medium", "paligemma-3b", "qwen1.5-110b", "nemotron-4-340b"]


@pytest.mark.parametrize("shape", HD48_SHAPES, ids=str)
def test_f32_route_takes_head_dim_48(cuda_device, shape):
    test_flash_attention_kernel_matches_plain_version(cuda_device, shape, "float32")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_serving_on_the_card_follows_the_cpu(cuda_device, arch):
    """The smoke config in f32 served on the card and on the CPU from the
    same weights, prompts and random patches or frames (paligemma at 112 +
    16 patches = 128 positions, the others at 128: every prefill layer's
    self-attention on the kernel): prefill logits within 1e-4, greedy tokens
    equal, one flash launch a decoder layer."""
    from repro_torch.launch import serve

    cfg = get_smoke_config(arch)
    t = 128 - (cfg.vlm_patches if cfg.family == "vlm" else 0)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, t)))
    runs = {}
    for dev in ("cpu", cuda_device):
        extra = _frontend_inputs(cfg, 2, 0, dev)
        before = ops.launches
        runs[str(dev)] = serve.generate(build_model(cfg, dev), tree_map(lambda a: a.to(dev), params), prompts.to(dev),
                                        8, **extra), ops.launches - before
    (cpu, _), (card, launches) = runs["cpu"], runs[str(cuda_device)]
    assert launches == cfg.n_layers
    np.testing.assert_allclose(card.prefill_logits.cpu().numpy(), cpu.prefill_logits.numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_train_step_on_the_card_follows_the_cpu(cuda_device, arch):
    """Sync (the async modes refuse patches and frames): k equal, sim_time
    within 1e-6 and ce within 1e-5 relative; one flash launch a decoder
    layer in each step's eval forward (paligemma's T = 112 + 16 patches)."""
    cfg = get_smoke_config(arch)
    seq = 128 - (cfg.vlm_patches if cfg.family == "vlm" else 0)
    card, launches = _train_run(arch, "sync", 1, cuda_device, seq)
    cpu, _ = _train_run(arch, "sync", 1, "cpu", seq)
    for (k, t, ce), (k0, t0, ce0) in zip(card, cpu):
        assert k == k0
        np.testing.assert_allclose(t, t0, rtol=1e-6)
        np.testing.assert_allclose(ce, ce0, rtol=1e-5)
    assert launches == (3 * cfg.n_layers, 0)


# ------------------------------------------------------------------- experiments

# The engine's card-against-CPU bounds (chip_smoke.py phases 8 and 14): k
# equal but in at most 2 replicas of a cell whose controller adapts from the
# gradients (a near-zero test statistic can flip on the card's rounding),
# `time` within 1e-5 and the loss within 1e-4 relative in the other replicas.
ADAPTIVE_CONTROLLERS = (ctl.PflugController, ctl.SketchedPflugController, ctl.VarianceRatioController)
SIM_GRIDS = {
    "controllers_x_stragglers": ["--sim-controllers", "pflug,fixed,variance_ratio,schedule,sketched_pflug",
                                 "--sim-stragglers", "exponential,pareto"],
    "mixed": ["--sim-mode", "sync,kasync", "--sim-fault", "none,sign_flip:0.1:0", "--sim-agg", "mean,geomedian",
              "--sim-n-grid", "10,20", "--k0", "4", "--fixed-k", "4"],
}


def _hold_cells(got: dict, want: dict, adaptive: set):
    """{label: MonteCarloResult} on the card against the CPU's."""
    for label, g in got.items():
        w = want[label]
        gk, wk = g.k.cpu().numpy(), w.k.numpy()
        forked = np.nonzero((gk != wk).any(axis=1))[0]
        assert len(forked) <= (2 if label in adaptive else 0), (label, forked.tolist())
        keep = np.setdiff1d(np.arange(gk.shape[0]), forked)
        np.testing.assert_allclose(g.time.cpu().numpy()[keep], w.time.numpy()[keep], rtol=1e-5, err_msg=label)
        np.testing.assert_allclose(g.loss.cpu().numpy()[keep], w.loss.numpy()[keep], rtol=1e-4, err_msg=label)


@pytest.mark.parametrize("grid", list(SIM_GRIDS))
def test_simulate_on_the_card_follows_the_cpu(cuda_device, grid):
    from repro_torch.launch import train

    argv = ["--simulate", "--steps", "300", "--replicas", "4", "--sim-eval-every", "100", "--n-workers", "20"]
    argv += SIM_GRIDS[grid]
    card = train.run_simulation(train.parse_args(argv + ["--device", "cuda"]))
    cpu = train.run_simulation(train.parse_args(argv + ["--device", "cpu"]), eta=card["eta"])
    assert card["header"]["devices"] == torch.cuda.device_count() and card["header"]["mesh_shape"] == [1, 1]
    labels = card["result"].labels
    assert labels == cpu["result"].labels
    adaptive = {c.label for c in card["cases"] if isinstance(c.controller, ADAPTIVE_CONTROLLERS)}
    _hold_cells({lb: card["result"].cell(g) for g, lb in enumerate(labels)},
                {lb: cpu["result"].cell(g) for g, lb in enumerate(labels)}, adaptive)


def test_fig_hetero_on_the_card_follows_the_cpu(cuda_device):
    from repro_torch.launch import figures

    card = figures.hetero_grid(iters=300, n_replicas=4, device="cuda")
    cpu = figures.hetero_grid(iters=300, n_replicas=4, device="cpu", eta=card["eta"], t1_times=card["t1_times"])
    own = figures.hetero_grid(iters=1, n_replicas=1, device="cpu", eta=card["eta"])["t1_times"]
    np.testing.assert_allclose(card["t1_times"], own, rtol=1e-5)  # the card's lstsq (gels) against the CPU's
    _hold_cells(card["results"], cpu["results"], {"adaptive", "adaptive_mixed"})


# ------------------------------------------------ distribution (world of 1)


@pytest.fixture
def world1(cuda_device, tmp_path):
    """A world of one NCCL rank (a FileStore under tmp_path) and its (1, 1)
    ("data", "model") mesh; the process group is destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_on_a_world1_mesh_equals_the_mesh_free_call(world1, dtype):
    """DTensor q, k, v (batch on "data", heads on "model"): the wrapper
    runs the kernel on the local shard, counts the launch, and returns the
    mesh-free call's bits."""
    from torch.distributed.tensor import Shard, distribute_tensor

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn(2, 256, 8, 128, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(2, 256, 4, 128, generator=g, device="cuda").to(dt) for _ in range(2))
    want = ops.flash_attention(q, k, v, causal=True)
    dq, dk, dv = (distribute_tensor(x, world1, (Shard(0), Shard(2)), src_data_rank=None) for x in (q, k, v))
    before = ops.launches
    got = ops.flash_attention(dq, dk, dv, causal=True)
    assert ops.launches == before + 1
    assert tuple(got.placements) == (Shard(0), Shard(2)) and torch.equal(got.full_tensor(), want)


def test_wkv6_on_a_world1_mesh_equals_the_mesh_free_call(world1):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    g = torch.Generator(device="cuda").manual_seed(29)
    r, k, v = (torch.randn(2, 128, 4, 64, generator=g, device="cuda") * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(2, 128, 4, 64, generator=g, device="cuda") * 0.5 - 1.0))
    u = torch.randn(4, 64, generator=g, device="cuda") * 0.1
    y0, s0 = wkv_ops.wkv6(r, k, v, w, u, chunk=64)
    # the head dim sharded on "model" (rwkv6-3b's PARAM_ALTS layout) is gathered first
    dr, dk, dv, dw = (distribute_tensor(x, world1, (Shard(0), Shard(3)), src_data_rank=None) for x in (r, k, v, w))
    before = wkv_ops.launches
    y, s = wkv_ops.wkv6(dr, dk, dv, dw, u, chunk=64)
    assert wkv_ops.launches == before + 1
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert torch.equal(y.full_tensor(), y0) and torch.equal(s.full_tensor(), s0)


def test_mesh_sweep_graph_replayed_equals_eager(world1):
    """fig2's grid at R = 4 on a (1, 1) ("cells", "replicas") mesh of the
    world: graph-replayed against eager, bitwise, and the mesh-free grid's
    bits."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("cells", "replicas"))
    data, keys = quickstart.inputs("fig2", replicas=4, device="cuda")
    grid = quickstart.cases("fig2", data, quickstart.step_size(data.X))

    def run(capture, m, partition="auto"):
        return sw.run_sweep(quickstart.squared_error, torch.zeros(data.X.shape[1], device="cuda"), data.X, data.y,
                            n_workers=quickstart.SETUPS["fig2"]["n"], cases=grid, num_iters=200, keys=keys,
                            eval_every=100, device="cuda", capture=capture, mesh=m, partition=partition)

    graph, eager, free = run(True, mesh), run(False, mesh), run(True, None, "none")
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
        assert torch.equal(getattr(graph, f), getattr(free, f)), f


# qwen3-moe-30b-a3b's and granite-moe-1b-a400m's full-width prefill heads
# (batch 4, prompt 1024) on a 16-way model axis: each rank's piece holds 2 q
# heads over 1 kv head, or 1 over 1
LAYOUT_PIECES = [(4, 1024, 32, 4, 64), (4, 1024, 16, 8, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LAYOUT_PIECES, ids=str)
def test_flash_head_pieces_of_a_16_way_model_axis_join_to_the_whole_call(cuda_device, shape, dtype):
    """`ops.flash_attention_piece` (the local tensors of one rank through
    the per-rank step that `_flash_attention_sharded` runs) for all 16 ranks on
    the one card, joined along the heads: the kernel on the whole tensor,
    within the kernel's own tolerance (each (batch, head) is computed alone,
    so it is expected bit for bit)."""
    b, t, h, kv, hd = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(cuda_device, getattr(torch, dtype))
               for sh in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    whole = ops.flash_attention(q, k, v, causal=True)
    before = ops.launches
    joined = torch.cat([ops.flash_attention_piece(q, k, v, r, 16) for r in range(16)], dim=2)
    torch.cuda.synchronize()
    assert ops.launches == before + 16
    tol = TOL[dtype]
    np.testing.assert_allclose(joined.float().cpu().numpy(), whole.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("blk", [64, 256])
def test_blocked_attention_on_the_card_matches_naive(cuda_device, dtype, tol, blk):
    """`layers._sdpa_blocked` against the naive path at llama3.2-3b smoke's
    layer, T = 512: max |d| / max |out| within the kernels' tolerances."""
    from repro_torch.models import layers

    cfg = get_smoke_config("llama3.2-3b").replace(use_kernels=False, param_dtype=dtype, compute_dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(31)
    p = layers.attention_init(g, cfg, "cuda")
    x = torch.randn(2, 512, cfg.d_model, generator=g, device="cuda").to(getattr(torch, dtype))
    pos = torch.arange(512, device="cuda")
    with torch.no_grad():
        naive = layers.attention_full(p, cfg, x, pos, window=96)
        blocked = layers.attention_full(p, cfg.replace(attention_impl="blocked", attention_block=blk), x, pos,
                                        window=96)
    assert ((blocked - naive).abs().max() / naive.abs().max()).item() < tol


# ------------------------------------------------- the kernels as custom ops


def _attn_inputs(dtype, shape=(2, 256, 256, 8, 2, 128)):
    b, t, s, h, kv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(41)
    mk = lambda *sh: torch.randn(sh, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(b, t, h, hd), mk(b, s, kv, hd), mk(b, s, kv, hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_custom_op_is_the_kernel_bit_for_bit(cuda_device, dtype):
    """`ops.flash_attention` (its direct launch) and the custom op
    `repro_torch::flash_attention` against the kernel's own binding on the
    same inputs: equal bits, one launch counted each."""
    from repro_torch.kernels.attention import kernel as attn_kernel

    q, k, v = _attn_inputs(getattr(torch, dtype))
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=True, window=64)
    via_op = torch.ops.repro_torch.flash_attention(q, k, v, True, 64)
    assert ops.launches == before + 2
    direct = torch.empty_like(q)
    attn_kernel.flash_attention_bhtd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                                     window=64, out=direct.transpose(1, 2))
    torch.cuda.synchronize()
    assert torch.equal(out, direct) and torch.equal(via_op, direct)


@pytest.mark.parametrize("case", [(2, 128, 3, 64, 64, 32, 0.5), (2, 128, 3, 16, 16, 32, 0.5)], ids=str)
def test_wkv6_custom_op_is_the_kernel_bit_for_bit(cuda_device, case):
    xs = _wkv_inputs(case, torch.bfloat16, cuda_device)
    route = _expected_route(case)
    before = wkv_ops.route_launches[route]
    y, s = wkv_ops.wkv6(*xs, chunk=case[5])
    oy, os_ = torch.ops.repro_torch.wkv6(*xs, case[5], route)
    assert wkv_ops.route_launches[route] == before + 2
    dy, ds = wkv_kernel.wkv6_bthk(*xs, chunk=case[5], kernel=route)
    torch.cuda.synchronize()
    assert torch.equal(y, dy) and torch.equal(s, ds) and torch.equal(oy, dy) and torch.equal(os_, ds)


def _meta(x):
    return tuple(x.shape), x.dtype, x.stride(), x.device.type


def test_the_fake_implementations_are_shaped_as_the_real_outputs(cuda_device):
    """Each custom op's fake output: the real output's shape, dtype, strides
    and device; and a trace on fake tensors counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline import analysis

    q, k, v = _attn_inputs(torch.bfloat16)
    wkv_case = (2, 128, 3, 64, 64, 32, 0.5)
    xs = _wkv_inputs(wkv_case, torch.bfloat16, cuda_device)
    real_attn = ops.flash_attention(q, k, v, causal=True)
    real_wkv = wkv_ops.wkv6(*xs, chunk=32)
    before = (ops.launches, wkv_ops.launches)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(x) for x in (q, k, v))
        fxs = [mode.from_tensor(x) for x in xs]
        fake_attn = ops.flash_attention(fq, fk, fv, causal=True)
        fake_wkv = wkv_ops.wkv6(*fxs, chunk=32)
        cost = analysis.count_step(lambda: (ops.flash_attention(fq, fk, fv, causal=True),
                                            wkv_ops.wkv6(*fxs, chunk=32)))
    assert _meta(fake_attn) == _meta(real_attn)
    assert [_meta(a) for a in fake_wkv] == [_meta(a) for a in real_wkv]
    assert (ops.launches, wkv_ops.launches) == before
    assert cost["kernel_calls"] == {"flash_attention": 1, "wkv6": 1}
    assert cost["flops"] == ops.flash_attention_flops(tuple(q.shape), tuple(k.shape), tuple(v.shape), True, 0) + \
        wkv_ops.wkv6_flops(*(tuple(x.shape) for x in xs[:5]), None, 32, "wkv6_sm90")


def test_dryrun_traces_the_cards_program(cuda_device, tmp_path):
    """`launch/dryrun.py` on its default device, in a process of its own:
    qwen1.5-0.5b train_4k at 2 layers on 256 fake ranks, the eval forward's
    attention through the custom op, no launch."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "r.json"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape",
                           "train_4k", "--override", "n_layers=2", "--out", str(out)], cwd=root, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(root / "src")), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(out.read_text())
    assert (r["device"], r["n_devices"]) == ("cuda", 256)
    assert r["kernel_calls"]["flash_attention"] == 2 and r["kernel_launches"] == {"flash_attention": 0, "wkv6": 0}
    assert r["roofline"]["flops"] > 0 and r["collectives"]["total"] > 0


# ----------------------------------- the sharded path's repairs (torch on the card)

# one dry-run job per repaired site (chip_smoke.py phase 16's)
REPAIRED_JOBS = [("qwen3-moe-30b-a3b", "train_4k", "base"), ("hymba-1.5b", "train_4k", "base"),
                 ("rwkv6-3b", "prefill_32k", "pod2"), ("hymba-1.5b", "decode_32k", "pod2")]


@pytest.fixture(scope="module")
def repaired_dry_runs(tmp_path_factory):
    """The four jobs of `REPAIRED_JOBS` on the card's program at 2 layers,
    each in a process of its own, all started at once."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dry run traces the card's program")
    from repro_torch.launch import dryrun_all

    root = Path(__file__).resolve().parents[1]
    tmp = tmp_path_factory.mktemp("repaired")
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for job in REPAIRED_JOBS:
        out = tmp / ("__".join(job) + ".json")
        cmd = dryrun_all.job_cmd(*job, str(out), "cuda") + ["--override", "n_layers=2"]
        procs[job] = (subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                       text=True), out)
    results = {}
    for job, (proc, out) in procs.items():
        _, err = proc.communicate(timeout=900)
        results[job] = (proc.returncode, err, json.loads(out.read_text()) if out.exists() else None)
    return results


@pytest.mark.parametrize("job", REPAIRED_JOBS, ids=["-".join(j) for j in REPAIRED_JOBS])
def test_repaired_dry_run_job_traces_the_cards_program(repaired_dry_runs, job):
    """Each job that torch's DTensor on the card refused (the MoE dispatch,
    the head-dim-sharded projection's backward, rwkv's decay LoRA on
    (2, 16, 16), the SSM's decode step) traces: counts > 0, no launch, the
    kernels' custom ops called where the step reaches them."""
    rc, err, r = repaired_dry_runs[job]
    assert rc == 0, err[-3000:]
    arch, shape, mode = job
    assert (r["device"], r["n_devices"]) == ("cuda", 512 if mode == "pod2" else 256)
    assert r["roofline"]["flops"] > 0 and r["roofline"]["bytes_accessed"] > 0 and r["collectives"]["total"] > 0
    assert r["kernel_launches"] == {"flash_attention": 0, "wkv6": 0}
    if shape != "decode_32k":
        kernel = "wkv6" if arch == "rwkv6-3b" else "flash_attention"
        assert r["kernel_calls"][kernel] > 0, r["kernel_calls"]


def test_vocab_parallel_nll_on_a_world1_mesh_follows_the_mesh_free_nll(world1):
    """`model._nll` of CUDA logits with the (padded) vocab on "model": the
    nll within 1e-6 relative of the mesh-free `_nll` on the same tensors,
    the gradient of a weighted sum within 1e-6 of its max, nothing
    gathered."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import model as model_lib
    from repro_torch.roofline import analysis

    g = torch.Generator(device="cuda").manual_seed(29)
    vocab, vpad = 1000, 1024
    logits = 3 * torch.randn(4, 64, vpad, generator=g, device="cuda")
    targets = torch.randint(0, vocab, (4, 64), generator=g, device="cuda")
    targets[0, :2] = torch.tensor([0, vocab - 1])
    w = torch.randn(4, 64, generator=g, device="cuda")
    lg = logits.clone().requires_grad_()
    want = model_lib._nll(lg, targets, vocab)
    (want * w).sum().backward()
    dl = distribute_tensor(logits, world1, (Shard(0), Shard(2)), src_data_rank=None).requires_grad_()
    dt = distribute_tensor(targets, world1, (Shard(0), Replicate()), src_data_rank=None)
    got = model_lib._nll(dl, dt, vocab)
    (got.full_tensor() * w).sum().backward()
    torch.testing.assert_close(got.full_tensor(), want.detach(), rtol=1e-6, atol=0)
    gmax = lg.grad.abs().max().item()
    torch.testing.assert_close(dl.grad.full_tensor(), lg.grad, rtol=0, atol=1e-6 * gmax)
    cost = analysis.count_step(lambda x: model_lib._nll(x, dt, vocab), dl.detach())
    assert cost["collectives"]["all-gather"] == 0 and cost["collectives"]["all-reduce"] == 3 * 4 * 64 * 4
