"""What a lane computes does not depend on how many lanes run beside it, on
the CPU, bit for bit.

- The sweep (repro_torch.core.sweep) maps its step and eval over (rows,
  replicas) with one vmap inside another, so each cell's products have the
  looped engine's width R: a cell alone in a grid of 1, the same cell in a
  grid of 4, and `run_monte_carlo` on that cell give the same time, k and
  loss, bit for bit, in the lean step and in the moded one.  (Mapped over
  one flat axis of G·R lanes, the CPU's GEMM blocked a width of G·R
  differently from R, and the parameters drifted by ~1e-6 relative.)
- `linear_scan.wkv6_chunked` computes every chunk's own terms at once and
  loops over the chunks carrying only the state.  `_wkv6_chunked_loop`
  below is the per-chunk loop it replaced, kept as the oracle: the forward
  is the loop's bit for bit; the gradients of k, v and s0 too, and those of
  r and w at B >= 2 (every input is used in the loop's order, so the
  backward sums in its order).  u's gradient is one sum over the batch and
  every chunk where the loop added chunk by chunk, and at B = 1 the CPU's
  GEMM takes one level product's operand with another stride: those stay
  within WKV_GRAD_GAP of the loop's, relative to the gradient's max.
- The synthetic regression's f* is the same in every call (least squares by
  QR: the CPU's default pivoted-QR routine changed its solution between
  calls in one process).
"""

from typing import Optional, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import montecarlo as tmc  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.core import sweep as tsw  # noqa: E402
from repro_torch.data import make_linreg_data  # noqa: E402
from repro_torch.models import linear_scan  # noqa: E402

N, M, D, R = 8, 80, 4, 3
ITERS, EVAL_EVERY = 30, 10
# max |grad - loop's grad| / max |loop's grad| over the inputs: measured at
# most 2.44e-7 (w at B = 1) and 2.0e-7 (u) over eleven shapes, 0 for k, v
# and s0 everywhere, and for r and w at B >= 2
WKV_GRAD_GAP = 3e-7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the port's CPU ops here are small, and tier-1 runs
    six test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- sweep


def torch_loss(w, X, y):
    return (X @ w - y) ** 2


PFLUG = dict(k0=1, step=2, thresh=2, burnin=3)
GRIDS = {
    # the lean step: sync, fault-free, mean-only
    "lean": [
        dict(ctrl=tctl.PflugController(N, **PFLUG), strag=tstr.Exponential(1.0), label="pflug"),
        dict(ctrl=tctl.FixedKController(N, k=3), strag=tstr.Pareto(1.0, 2.5), label="fixed"),
        dict(ctrl=tctl.VarianceRatioController(N, k0=1, step=2, burnin=8, decay=0.8, ratio_thresh=0.3),
             strag=tstr.Bimodal(1.0, 4.0, 0.2), label="vr"),
        dict(ctrl=tctl.SketchedPflugController(N, sketch_dim=4, **PFLUG), strag=tstr.Exponential(0.5),
             label="sketched"),
    ],
    # the moded step: every cell alone is moded too
    "moded": [
        dict(ctrl=tctl.PflugController(N, **PFLUG), strag=tstr.Exponential(1.0), label="kasync", mode="kasync"),
        dict(ctrl=tctl.FixedKController(N, k=2), strag=tstr.Exponential(1.0), label="kbatch", mode="kbatch"),
        dict(ctrl=tctl.FixedKController(N, k=3), strag=tstr.Exponential(1.0), label="flip_trimmed",
             fault=tfaults.byzantine_plan(N, 0.25, "sign_flip"), agg="trimmed"),
        dict(ctrl=tctl.FixedKController(N, k=2), strag=tstr.Pareto(1.0, 2.5), label="crash_kasync", mode="kasync",
             fault=tfaults.byzantine_plan(N, 0.25, "crash", onset=2.0)),
    ],
}


def _cases(grid, eta):
    return [tsw.SweepCase(s["ctrl"], s["strag"], eta=eta, label=s["label"], mode=s.get("mode", "sync"),
                          fault=s.get("fault"), agg=s.get("agg", "mean")) for s in GRIDS[grid]]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.integers(1, 11, (M, D)).astype(np.float32))
    y = X @ torch.from_numpy(rng.integers(1, 101, D).astype(np.float32)) + torch.from_numpy(
        rng.standard_normal(M, dtype=np.float32))
    eta = 0.5 / (2 * float(torch.linalg.eigvalsh(X.T @ X / M).max()))
    return X, y, eta, prng.split(prng.PRNGKey(7), R)


_RUNS = {}


def _sweep(problem, grid, cells):
    """The sweep of ``cells`` (indices into the grid), run once per module."""
    if (grid, cells) not in _RUNS:
        X, y, eta, keys = problem
        cases = [_cases(grid, eta)[c] for c in cells]
        _RUNS[grid, cells] = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, n_workers=N, cases=cases,
                                           num_iters=ITERS, eval_every=EVAL_EVERY, keys=keys, device="cpu")
    return _RUNS[grid, cells]


def _assert_bitwise(got, want, tag):
    for f in ("time", "k", "loss"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f"{f} {tag}"


CELLS = [(grid, c) for grid in GRIDS for c in range(len(GRIDS[grid]))]


@pytest.mark.parametrize("grid,c", CELLS, ids=[f"{g}-{s['label']}" for g in GRIDS for s in GRIDS[g]])
def test_a_cell_alone_matches_the_cell_in_a_grid_of_four(problem, grid, c):
    alone = _sweep(problem, grid, (c,))
    in_grid = _sweep(problem, grid, tuple(range(len(GRIDS[grid]))))
    assert in_grid.time.shape[0] == 4 and alone.time.shape[0] == 1
    _assert_bitwise(alone.cell(0), in_grid.cell(c), f"{grid}/{GRIDS[grid][c]['label']}")


@pytest.mark.parametrize("grid,c", CELLS, ids=[f"{g}-{s['label']}" for g in GRIDS for s in GRIDS[g]])
def test_a_cell_in_a_grid_of_four_matches_the_looped_engine(problem, grid, c):
    X, y, eta, keys = problem
    case = _cases(grid, eta)[c]
    looped = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N, controller=case.controller,
                                 straggler=case.straggler, eta=case.eta, num_iters=ITERS, eval_every=EVAL_EVERY,
                                 keys=keys, mode=case.mode, fault=case.fault, agg=case.agg, device="cpu")
    in_grid = _sweep(problem, grid, tuple(range(len(GRIDS[grid]))))
    _assert_bitwise(in_grid.cell(c), looped, f"{grid}/{case.label}")


# --------------------------------------------------------------------- wkv6


def _wkv6_chunked_loop(r, k, v, w, u, s0: Optional[torch.Tensor] = None,
                       chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """`linear_scan.wkv6_chunked` as it was: one Python iteration a chunk,
    every term of the chunk in it."""
    b, t, h, kdim = k.shape
    vdim = v.shape[-1]
    nc = t // chunk
    f32 = torch.float32
    r, k, v, w = (a.to(f32) for a in (r, k, v, w))
    u = u.to(f32)
    dev = k.device
    rs = r.reshape(b, nc, chunk, h, kdim)
    ks = k.reshape(b, nc, chunk, h, kdim)
    vs = v.reshape(b, nc, chunk, h, vdim)
    ws = w.reshape(b, nc, chunk, h, kdim)
    logw = torch.log(torch.clamp(ws, min=1e-20))
    lw_inc = torch.cumsum(logw, dim=2)
    lw_exc = lw_inc - logw
    s = torch.zeros((b, h, kdim, vdim), dtype=f32, device=dev) if s0 is None else s0.to(f32)
    levels = [
        (torch.from_numpy(is_q).to(dev)[None, :, None, None], torch.from_numpy(mref).to(dev),
         torch.from_numpy(pair_mask).to(dev))
        for is_q, mref, pair_mask in linear_scan._straddle_levels(chunk)
    ]
    neg_inf = torch.tensor(-torch.inf, dtype=f32, device=dev)
    ys = []
    for c in range(nc):
        rc, kc, vc = rs[:, c], ks[:, c], vs[:, c]
        lwi, lwe, lwt = lw_inc[:, c], lw_exc[:, c], lw_inc[:, c, -1]
        y_inter = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(lwe), s)
        scores = torch.zeros((b, h, chunk, chunk), dtype=f32, device=dev)
        for qsel, mref, pair_mask in levels:
            li_ref = lwi[:, mref]
            e_q = torch.where(qsel, torch.clamp(lwe - li_ref, max=0.0), neg_inf)
            e_k = torch.where(qsel, neg_inf, torch.clamp(li_ref - lwi, max=0.0))
            part = torch.einsum("bchk,bdhk->bhcd", rc * torch.exp(e_q), kc * torch.exp(e_k))
            scores = scores + torch.where(pair_mask, part, 0.0)
        bonus = torch.einsum("bchk,hk,bchk->bch", rc, u, kc)
        y_intra = torch.einsum("bhcd,bdhv->bchv", scores, vc) + bonus[..., None] * vc
        k_carry = kc * torch.exp(lwt[:, None] - lwi)
        s = torch.exp(lwt)[..., None] * s + torch.einsum("bchk,bchv->bhkv", k_carry, vc)
        ys.append(y_inter + y_intra)
    return torch.stack(ys, dim=1).reshape(b, t, h, vdim), s


# (B, T, H, K, V, chunk, with s0): T/C = 32; chunks that are not powers of two
WKV_CASES = [(2, 512, 2, 8, 8, 16, False), (2, 96, 3, 8, 12, 12, True), (1, 96, 2, 8, 8, 24, True),
             (2, 30, 2, 4, 4, 5, False)]


def _wkv_inputs(b, t, h, kd, vd, with_s0, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *sh: torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))  # noqa: E731
    r, k, v = n(b, t, h, kd), n(b, t, h, kd), n(b, t, h, vd)
    w = torch.exp(-torch.exp(n(b, t, h, kd) * 0.5 - 0.5))
    return r, k, v, w, n(h, kd) * 0.5, n(b, h, kd, vd) * 0.2 if with_s0 else None


@pytest.mark.parametrize("b,t,h,kd,vd,chunk,with_s0", WKV_CASES)
def test_wkv6_chunked_forward_is_the_loops_bit_for_bit(b, t, h, kd, vd, chunk, with_s0):
    xs = _wkv_inputs(b, t, h, kd, vd, with_s0)
    y, s = linear_scan.wkv6_chunked(*xs, chunk=chunk)
    y_loop, s_loop = _wkv6_chunked_loop(*xs, chunk=chunk)
    assert y.shape == (b, t, h, vd) and s.shape == (b, h, kd, vd)
    assert torch.equal(y, y_loop) and torch.equal(s, s_loop)


@pytest.mark.parametrize("b,t,h,kd,vd,chunk,with_s0", WKV_CASES)
def test_wkv6_chunked_gradient_stays_within_the_measured_gap(b, t, h, kd, vd, chunk, with_s0):
    xs = _wkv_inputs(b, t, h, kd, vd, with_s0)
    grads = []
    for fn in (linear_scan.wkv6_chunked, _wkv6_chunked_loop):
        leaves = [x.clone().requires_grad_(True) if x is not None else None for x in xs]
        y, s = fn(*leaves, chunk=chunk)
        (0.5 * y.square().sum() + (0.3 * s).sum()).backward()
        grads.append({name: x.grad for name, x in zip("rkvwus", leaves) if x is not None})
    got, want = grads
    for name in want:
        gap = float((got[name] - want[name]).abs().max() / want[name].abs().max())
        assert gap <= WKV_GRAD_GAP, (name, gap)
    bitwise = ["k", "v"] + (["s"] if with_s0 else []) + (["r", "w"] if b >= 2 else [])
    for name in bitwise:
        assert torch.equal(got[name], want[name]), name


# ------------------------------------------------------------------ f_star


def test_linreg_f_star_is_the_same_in_every_call():
    f_stars = {make_linreg_data(prng.PRNGKey(0), m=M, d=D, device="cpu").f_star for _ in range(100)}
    assert len(f_stars) == 1, sorted(f_stars)
