"""The port's fault axis and robust aggregation (repro_torch.core.faults, the
robust half of repro_torch.core.aggregation) against the JAX package on the
same numpy inputs, on the CPU, through the transforms, both engines and
fig_byzantine's grid.

Tolerances:
- packing, plans, `crash_times`, `fault_weights`, `apply_row_faults` and
  `coordinate_median_rows` (signed zeros included): bitwise;
- `gauss_rows`: the fold_in keys bitwise, the values within 64 ulp (torch's
  erfinv against XLA's, `prng.normal`);
- `trimmed_mean_rows` within 1e-6 relative (the sum of the kept values
  rounds in another order), `geometric_median_rows` within 1e-5 relative
  of the reference and of a float64 host Weiszfeld;
- trajectories against the reference per replica: k equal, `time` within
  1e-6 and loss within 1e-4 relative (tests/test_torch_execmode.py's); a
  Pflug cell may fork in k in at most 2 replicas;
- a grid cell against the port's looped engine: `time` and k bitwise, loss
  within 1e-6 relative (tests/test_torch_sweep.py's);
- cells that diverge by design (fig_byzantine's weighted mean under 30%
  sign flips): time and a fixed k held over the whole run, the loss and an
  adaptive k only while the reference's loss is finite and below the loss
  the run started from (the loss at w = 0, 2.3e7 here; the figure's 1e4
  bar on the excess would hold no point of a 50-iteration run).

The reference's engines run at unroll 1 (a third of the compile time), and
its sweep with ``partition="none"`` (its default raises under this JAX;
ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import montecarlo as jmc  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.core import sweep as jsw  # noqa: E402
from repro.data import make_linreg_data as jax_linreg  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import montecarlo as tmc  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.core import sweep as tsw  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402

TIME_RTOL, LOSS_RTOL, MAX_FORKS = 1e-6, 1e-4, 2
LOOPED_LOSS_RTOL = 1e-6
TRIMMED_RTOL, GEOMEDIAN_RTOL, NORMAL_ULPS = 1e-6, 1e-5, 64
N, M, D, R = 8, 160, 4, 3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_loss(w, X, y):
    return (X @ w - y) ** 2


def torch_loss(w, X, y):
    return (X @ w - y) ** 2


@pytest.fixture(scope="module")
def linreg():
    """The reference test's problem (tests/test_faults.py): m = 160, d = 4,
    8 workers, eta 0.05/L."""
    data = jax_linreg(jax.random.PRNGKey(0), m=M, d=D)
    eta = 0.05 / (2 * float(np.linalg.eigvalsh(np.asarray(data.X, np.float64).T @ np.asarray(data.X) / M).max()))
    return data, torch.from_numpy(np.array(data.X)), torch.from_numpy(np.array(data.y)), eta


def _plan(lib, spec):
    """A plan from ``(family, frac, onset, param)``, or a list of per-worker
    ``(family, onset, param)`` / None."""
    mod = jf if lib == "jax" else tf
    if spec is None:
        return None
    if isinstance(spec, list):
        return mod.FaultPlan([None if m is None else mod.FaultModel(*m) for m in spec])
    fam, frac, onset, param = spec
    return mod.byzantine_plan(N, frac, fam, onset=onset, param=param)


def _assert_as_reference(got, want, tag="", max_forks=0):
    """k equal (forks allowed), time and loss within the reference
    tolerances."""
    gk, wk = _np(got.k), np.asarray(want.k)
    forked = np.nonzero((gk != wk).any(axis=1))[0]
    assert len(forked) <= max_forks, f"k {tag}: replicas {forked.tolist()} forked"
    keep = np.setdiff1d(np.arange(gk.shape[0]), forked)
    np.testing.assert_allclose(_np(got.time)[keep], np.asarray(want.time)[keep], rtol=TIME_RTOL, err_msg=f"time {tag}")
    np.testing.assert_allclose(_np(got.loss)[keep], np.asarray(want.loss)[keep], rtol=LOSS_RTOL, err_msg=f"loss {tag}")
    np.testing.assert_array_equal(got.iteration, want.iteration)


def _assert_as_looped(got, want, tag=""):
    assert torch.equal(got.time, want.time) and torch.equal(got.k, want.k), tag
    np.testing.assert_allclose(_np(got.loss), _np(want.loss), rtol=LOOPED_LOSS_RTOL, err_msg=f"loss {tag}")


# ------------------------------------------------------------- plans, packing


PLANS = [
    None,
    ("sign_flip", 0.25, 0.0, 1.0),
    ("rescale", 0.5, 3.0, -4.0),
    ("random_gauss", 0.1, 1.5, 2.0),
    ("crash", 1.0, 0.0, 1.0),
    ("none", 0.5, 0.0, 1.0),
    [("crash", 2.0, 1.0), None, ("sign_flip", 0.0, 1.0), ("random_gauss", 0.5, 0.3), None, ("rescale", 1.0, 0.5)],
]


@pytest.mark.parametrize("spec", PLANS, ids=[str(i) for i in range(len(PLANS))])
def test_plans_pack_as_the_reference(spec):
    jp, tp = _plan("jax", spec), _plan("torch", spec)
    assert (jp is None) == (tp is None)
    assert tf.plan_kinds_present(tp) == jf.plan_kinds_present(jp)
    for n_slots in (N, N + 3):
        for got, want in zip(tf.pack_faults(tp, n_slots, N), jf.pack_faults(jp, n_slots, N)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_constants_and_refusals_match_the_reference():
    assert tf.FAULT_FAMILIES == jf.FAULT_FAMILIES and tf.GRAD_FAULTS == jf.GRAD_FAULTS
    assert tf._NOISE_TAG == jf._NOISE_TAG and tf.FaultFns._fields == jf.FaultFns._fields
    assert tagg.AGG_KINDS == jagg.AGG_KINDS and tagg.WEISZFELD_ITERS == jagg.WEISZFELD_ITERS
    assert tagg._WEISZFELD_EPS == jagg._WEISZFELD_EPS
    assert (tagg.AGG_MEAN, tagg.AGG_TRIMMED, tagg.AGG_MEDIAN, tagg.AGG_GEOMEDIAN) == (
        jagg.AGG_MEAN, jagg.AGG_TRIMMED, jagg.AGG_MEDIAN, jagg.AGG_GEOMEDIAN)
    with pytest.raises(ValueError, match="unknown fault family"):
        tf.FaultModel("nope")
    with pytest.raises(ValueError, match="FaultModel or None"):
        tf.FaultPlan([object()])
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        tf.byzantine_plan(N, 1.5, "crash")
    with pytest.raises(ValueError, match="active workers"):
        tf.pack_faults(tf.byzantine_plan(N, 0.5, "crash"), N, N - 1)
    assert tf.make_fault_fns(None, None, None, (), None, N) is None
    assert tagg.make_robust_select(None, None, (tagg.AGG_MEAN,)) is None


# ------------------------------------------------------- transforms on tensors


def _fault_rows(seed=0, n=N):
    """Random per-slot fault rows of every family, onsets around t = 1."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 5, n).astype(np.int32)
    onset = rng.choice([0.0, 0.5, 1.0, 2.0, np.inf], n).astype(np.float32)
    param = rng.normal(size=n).astype(np.float32)
    return kinds, onset, param


PRESENT = [(1,), (2,), (3,), (4,), (1, 2, 3), (1, 2, 3, 4)]


@pytest.mark.parametrize("present", PRESENT, ids=lambda p: "-".join(map(str, p)))
def test_time_and_weight_transforms_bitwise(present):
    kinds, onset, param = _fault_rows()
    times = np.random.default_rng(1).exponential(size=N).astype(np.float32)
    tk, to, tp = map(torch.from_numpy, (kinds, onset, param))
    for t in (0.0, 0.75, 1.0, 5.0):
        np.testing.assert_array_equal(_np(tf.crash_times(torch.from_numpy(times), tk, to, torch.tensor(t))),
                                      np.asarray(jf.crash_times(jnp.asarray(times), kinds, onset, t)))
        got = tf.fault_weights(tk, to, tp, torch.tensor(t), present)
        want = jf.fault_weights(jnp.asarray(kinds), jnp.asarray(onset), jnp.asarray(param), t, present)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("present", PRESENT, ids=lambda p: "-".join(map(str, p)))
def test_apply_row_faults_bitwise(present):
    kinds, onset, param = _fault_rows(2)
    rng = np.random.default_rng(3)
    rows = {"w": rng.normal(size=(N, 3, 2)).astype(np.float32), "b": rng.normal(size=(N,)).astype(np.float32)}
    z = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in rows.items()}
    for t in (0.0, 1.0, 3.0):
        want = jf.apply_row_faults(jax.tree.map(jnp.asarray, rows), jax.tree.map(jnp.asarray, z), kinds, onset,
                                   param, t, present)
        got = tf.apply_row_faults({k: torch.from_numpy(v) for k, v in rows.items()},
                                  {k: torch.from_numpy(v) for k, v in z.items()}, *map(torch.from_numpy,
                                                                                       (kinds, onset, param)),
                                  torch.tensor(t), present)
        for k in rows:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.fixture(params=[True, False], ids=["partitionable", "legacy"])
def threefry(request):
    """Both packages in one threefry mode for the test, restored after."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    try:
        with prng.threefry_mode(request.param):
            yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def test_gauss_rows_keys_bitwise_and_values_within_64_ulp(threefry):
    """Leaf j's key is fold_in(fold_in(key, _NOISE_TAG), j) in JAX's leaf
    order (a dict's keys sorted); the noise is prng.normal's."""
    kinds, onset, param = _fault_rows(4)
    kinds[:3] = tf.FAULT_GAUSS
    onset[:3] = 0.0
    params = {"w": np.zeros((3, 2), np.float32), "b": np.zeros((), np.float32), "a": np.zeros((4,), np.float32)}
    key = np.asarray(jax.random.PRNGKey(11))
    kz = jax.random.fold_in(jnp.asarray(key), jf._NOISE_TAG)
    tkz = prng.fold_in(prng.as_key(key), tf._NOISE_TAG)
    np.testing.assert_array_equal(_np(tkz), np.asarray(kz))
    for j in range(3):
        np.testing.assert_array_equal(_np(prng.fold_in(tkz, j)), np.asarray(jax.random.fold_in(kz, j)))
    want = jf.gauss_rows(jnp.asarray(key), kinds, onset, param, 1.0, jax.tree.map(jnp.asarray, params), N)
    got = tf.gauss_rows(prng.as_key(key), *map(torch.from_numpy, (kinds, onset, param)), torch.tensor(1.0),
                        {k: torch.from_numpy(v) for k, v in params.items()}, N)
    assert list(got) == list(params)  # the caller's key order
    gated = (kinds != tf.FAULT_GAUSS) | (onset > 1.0)
    assert gated.any() and not gated[:3].any()
    for k in params:
        assert tuple(got[k].shape) == (N,) + params[k].shape
        np.testing.assert_array_max_ulp(_np(got[k]), np.asarray(want[k]), maxulp=NORMAL_ULPS)
        assert not _np(got[k])[gated].any() and _np(got[k])[~gated].all()


# ------------------------------------------------------------ robust aggregators


def _cloud(seed, n=10, d=6, k=7):
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[rng.permutation(n)[:k]] = 1.0
    return mat, mask


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_coordinate_median_bitwise_with_signed_zeros(k):
    """A column of +-0.0 (sign flips of zero gradients make them common),
    one of ties, one with an outlier: the stable sort keeps the
    reference's order, so the median of zeros keeps its sign."""
    mat, mask = _cloud(5, n=9, d=5, k=k)
    mat[:, 0] = [-0.0, 0.0, -0.0, -0.0, 0.0, 0.0, -0.0, 0.0, -0.0]
    mat[:, 1] = 1.5
    mat[0, 2] = 1e30
    want = np.asarray(jagg.coordinate_median_rows(jnp.asarray(mat), jnp.asarray(mask), jnp.int32(k)))
    got = _np(tagg.coordinate_median_rows(torch.from_numpy(mat), torch.from_numpy(mask),
                                          torch.tensor(k, dtype=torch.int32)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("trim", [0.0, 0.1, 0.25, 0.49])
@pytest.mark.parametrize("k", [1, 4, 7])
def test_trimmed_mean_matches_the_reference(trim, k):
    mat, mask = _cloud(6, k=k)
    want = np.asarray(jagg.trimmed_mean_rows(jnp.asarray(mat), jnp.asarray(mask), jnp.int32(k), trim))
    got = tagg.trimmed_mean_rows(torch.from_numpy(mat), torch.from_numpy(mask), torch.tensor(k, dtype=torch.int32),
                                 trim)
    np.testing.assert_allclose(_np(got), want, rtol=TRIMMED_RTOL, atol=1e-7)


def _host_weiszfeld(mat, mask, n_iter=tagg.WEISZFELD_ITERS, eps=1e-12):
    """The float64 host Weiszfeld of the reference test (tests/test_faults.py)."""
    mat = np.asarray(mat, np.float64)
    m = np.asarray(mask, np.float64)
    y = (m @ mat) / m.sum()
    for _ in range(n_iter):
        d = np.sqrt(((mat - y[None, :]) ** 2).sum(axis=1))
        w = m / np.maximum(d, eps)
        y = (w @ mat) / w.sum()
    return y


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_geometric_median_matches_the_reference_and_the_host_weiszfeld(seed):
    mat, mask = _cloud(seed)
    k = int(mask.sum())
    want = np.asarray(jagg.geometric_median_rows(jnp.asarray(mat), jnp.asarray(mask), jnp.asarray(k, jnp.float32)))
    got = _np(tagg.geometric_median_rows(torch.from_numpy(mat), torch.from_numpy(mask), torch.tensor(float(k))))
    np.testing.assert_allclose(got, want, rtol=GEOMEDIAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(got, _host_weiszfeld(mat, mask), rtol=GEOMEDIAN_RTOL, atol=1e-6)
    moved = mat.copy()
    moved[mask == 0] += 100.0  # rows that did not arrive are invisible
    np.testing.assert_array_equal(_np(tagg.geometric_median_rows(torch.from_numpy(moved), torch.from_numpy(mask),
                                                                 torch.tensor(float(k)))), got)


def test_weiszfeld_exact_mean_degeneracy():
    """Every arrived row the same: the geometric median is that row."""
    row = np.asarray([1.5, -2.0, 0.25, 3.0], np.float32)
    got = tagg.geometric_median_rows(torch.from_numpy(np.tile(row, (6, 1))), torch.ones(6), torch.tensor(6.0))
    np.testing.assert_allclose(_np(got), row, rtol=1e-6)


def test_coordinate_median_ignores_outlier():
    mat = np.ones((5, 3), np.float32)
    mat[4] = 1e6
    got = tagg.coordinate_median_rows(torch.from_numpy(mat), torch.ones(5), torch.tensor(5, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), np.ones(3), rtol=1e-6)


def test_robust_select_per_lane_matches_the_reference():
    """The select over a params dict, mapped over four lanes (mean,
    trimmed, median, geomedian): a mean lane keeps its gradient bit for
    bit; the others within the geometric median's tolerance."""
    rng = np.random.default_rng(7)
    present = (0, 1, 2, 3)
    rows = {"w": rng.normal(size=(4, N, 3)).astype(np.float32), "b": rng.normal(size=(4, N)).astype(np.float32)}
    mean_g = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    masks = np.stack([_cloud(20 + i, n=N, d=1, k=5)[1] for i in range(4)])
    kinds, params = np.arange(4, dtype=np.int32), np.full(4, 0.2, np.float32)
    ks = np.full(4, 5, np.int32)

    def jsel(kind, ap, mg, rw, m, k):
        return jagg.make_robust_select(kind, ap, present)(mg, rw, m, k)

    def tsel(kind, ap, mg, rw, m, k):
        return tagg.make_robust_select(kind, ap, present)(mg, rw, m, k)

    want = jax.vmap(jsel)(*map(lambda a: jax.tree.map(jnp.asarray, a), (kinds, params, mean_g, rows, masks, ks)))
    got = torch.func.vmap(tsel)(*map(lambda a: {k: torch.from_numpy(v) for k, v in a.items()} if isinstance(a, dict)
                                     else torch.from_numpy(a), (kinds, params, mean_g, rows, masks, ks)))
    for k in rows:
        np.testing.assert_array_equal(_np(got[k][0]), mean_g[k][0])
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=GEOMEDIAN_RTOL, atol=1e-6, err_msg=k)


def test_fastest_k_iteration_matches_the_reference():
    """(weights, mask, time) of one draw: the mask and weights exact, the
    time within log1p's ulp."""
    key = jax.random.PRNGKey(3)
    for k in (1, 3, 6):
        jw, jm, jt = jagg.fastest_k_iteration(jstr.Exponential(1.0), key, 6, jnp.int32(k), 4,
                                              jagg.CommModel(0.1, 0.05))
        tw, tm, tt = tagg.fastest_k_iteration(tstr.Exponential(1.0), prng.as_key(np.asarray(key)), 6,
                                              torch.tensor(k, dtype=torch.int32), 4, tagg.CommModel(0.1, 0.05))
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        np.testing.assert_array_equal(_np(tw), np.asarray(jw))
        np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=TIME_RTOL)


# ---------------------------------------------------------- the looped engine


_REF = {}


def _reference(tag, fn):
    """A reference run, once per module."""
    if tag not in _REF:
        _REF[tag] = fn()
    return _REF[tag]


# (mode, controller, plan, aggregator): every family, every aggregator the
# mode takes, a Pflug cell
ENGINE_CASES = [
    ("sync", "fixed", ("sign_flip", 0.25, 0.0, 1.0), "mean"),
    ("sync", "pflug", ("random_gauss", 0.25, 0.0, 2.0), "geomedian"),
    ("sync", "fixed", [None, None, None, None, None, ("crash", 1.0, 1.0), ("rescale", 0.5, -3.0), None], "median"),
    ("sync", "fixed", None, "trimmed"),
    ("kasync", "fixed", ("rescale", 0.25, 0.0, -4.0), "trimmed"),
    ("kasync", "pflug", ("crash", 0.5, 2.0, 1.0), "mean"),
    ("kasync", "fixed", ("random_gauss", 0.25, 1.0, 0.5), "median"),
    ("kasync", "fixed", ("sign_flip", 0.25, 0.0, 1.0), "geomedian"),
    ("kbatch", "fixed", ("crash", 0.5, 2.0, 1.0), "mean"),
    ("kbatch", "pflug", ("random_gauss", 0.25, 1.0, 2.0), "mean"),
    ("kbatch", "fixed", ("sign_flip", 0.375, 0.5, 1.0), "mean"),
]
CONTROLLERS = {"fixed": dict(k=3), "pflug": dict(k0=1, step=1, thresh=3, burnin=5)}


@pytest.mark.parametrize("case", ENGINE_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}-{c[2] and 'plan'}")
def test_run_monte_carlo_with_faults_per_replica(case, linreg):
    mode, name, spec, agg = case
    data, X, y, eta = linreg
    keys = jax.random.split(jax.random.PRNGKey(5), R)
    common = dict(n_workers=N, eta=eta, num_iters=60, eval_every=20, mode=mode, agg=agg, agg_param=0.25)
    want = _reference(("mc",) + tuple(map(str, case)), lambda: jmc.run_monte_carlo(
        jax_loss, jnp.zeros((D,)), data.X, data.y, controller=jctl.get_controller(name, N, **CONTROLLERS[name]),
        straggler=jstr.Exponential(1.0), keys=keys, unroll=1, fault=_plan("jax", spec), **common))
    got = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y,
                              controller=tctl.get_controller(name, N, **CONTROLLERS[name]),
                              straggler=tstr.Exponential(1.0), keys=np.asarray(keys), device="cpu",
                              fault=_plan("torch", spec), **common)
    _assert_as_reference(got, want, str(case), MAX_FORKS if name == "pflug" else 0)
    assert bool(torch.isfinite(got.loss).all())


@pytest.mark.parametrize("mode", ["sync", "kasync"])
def test_crash_onset_zero_degenerates_to_static_inactive(mode, linreg):
    """The last two of 8 slots crashed from t = 0 give the statically
    inactive 6-of-8 fleet's clock: time and k bitwise (the loss is not
    compared: the crashed workers' shards stay in the eval objective)."""
    _, X, y, eta = linreg
    kw = dict(num_iters=80, keys=np.asarray(jax.random.split(jax.random.PRNGKey(9), 2)), eval_every=20, mode=mode,
              device="cpu")
    crashed = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N,
                                  controller=tctl.FixedKController(n_workers=N, k=2),
                                  straggler=tstr.WorkerFleet([tstr.Exponential(1.0)] * N), eta=eta,
                                  fault=tf.byzantine_plan(N, 0.25, "crash", onset=0.0), **kw)
    static = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N,
                                 controller=tctl.FixedKController(n_workers=6, k=2),
                                 straggler=tstr.WorkerFleet([tstr.Exponential(1.0)] * 6), eta=eta, **kw)
    assert torch.equal(crashed.time, static.time) and torch.equal(crashed.k, static.k)


@pytest.mark.parametrize("mode", ["sync", "kasync", "kbatch"])
def test_all_crashed_holds_params_inf_time(mode, linreg):
    """Every worker crashed: the clock saturates to +inf and the parameters
    hold, so the loss stays finite (no NaN anywhere)."""
    _, X, y, eta = linreg
    res = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N,
                              controller=tctl.FixedKController(n_workers=N, k=2), straggler=tstr.Exponential(1.0),
                              eta=eta, fault=tf.byzantine_plan(N, 1.0, "crash", onset=1.0), num_iters=60,
                              keys=np.asarray(jax.random.split(jax.random.PRNGKey(13), 2)), eval_every=15, mode=mode,
                              device="cpu")
    assert bool(torch.isinf(res.time[:, -1]).all()) and bool(torch.isfinite(res.loss).all())
    assert bool((res.loss[:, -1] == res.loss[:, -2]).all())  # held


@pytest.mark.parametrize("kw,match", [
    (dict(fault=object()), "FaultPlan"),
    (dict(fault=tf.byzantine_plan(N, 0.5, "crash"), straggler=tstr.WorkerFleet([tstr.Exponential()] * 3),
          controller=tctl.FixedKController(n_workers=3, k=1)), "only 3 active"),
    (dict(agg="geomedian", mode="kbatch", fault=tf.byzantine_plan(N, 0.25, "sign_flip")), "kbatch"),
    (dict(agg="trimmed", mode="kbatch"), "kbatch"),
    (dict(agg="krum"), "unknown aggregator"),
])
def test_engine_refuses_what_the_reference_refuses(kw, match, linreg):
    _, X, y, _ = linreg
    args = dict(n_workers=N, controller=tctl.FixedKController(n_workers=N, k=2), straggler=tstr.Exponential(1.0),
                eta=1e-3, num_iters=4, eval_every=2, key=prng.PRNGKey(0), n_replicas=1, device="cpu")
    args.update(kw)
    before = tmc.program_cache_stats()
    with pytest.raises(ValueError, match=match):
        tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, **args)
    assert tmc.program_cache_stats() == before


def test_each_plan_has_its_own_program(linreg):
    """The plan, the aggregator and its parameter are in the cache key: a
    second plan never replays the first one's rows."""
    _, X, y, eta = linreg
    kw = dict(n_workers=N, controller=tctl.FixedKController(n_workers=N, k=3), straggler=tstr.Exponential(1.0),
              eta=eta, num_iters=20, eval_every=10, key=prng.PRNGKey(2), n_replicas=2, device="cpu")
    tmc.clear_program_cache()
    try:
        runs = [tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, **kw, **extra) for extra in (
            dict(fault=tf.byzantine_plan(N, 0.25, "rescale", param=3.0)),
            dict(fault=tf.byzantine_plan(N, 0.25, "rescale", param=-3.0)),
            dict(fault=tf.byzantine_plan(N, 0.25, "rescale", param=3.0), agg="trimmed", agg_param=0.2),
            dict(fault=tf.byzantine_plan(N, 0.25, "rescale", param=3.0), agg="trimmed", agg_param=0.4))]
        assert tmc.program_cache_stats()["programs"] == 4
        for a in range(4):
            for b in range(a):
                assert not torch.equal(runs[a].loss, runs[b].loss), (a, b)
    finally:
        tmc.clear_program_cache()


# ------------------------------------------------------------------- the sweep


def _forced_cases(lib, eta):
    """The reference test's seven forced cells (tests/test_faults.py:81)."""
    ctl, st, sw = (jctl, jstr, jsw) if lib == "jax" else (tctl, tstr, tsw)
    plan = lambda *a, **kw: _plan(lib, (a[0], a[1], kw.get("onset", 0.0), kw.get("param", 1.0)))  # noqa: E731
    exp, c = st.Exponential(rate=1.0), ctl.FixedKController(n_workers=N, k=3)
    return [
        sw.SweepCase(c, exp, eta, label="clean"),
        sw.SweepCase(c, exp, eta, label="flip", fault=plan("sign_flip", 0.25)),
        sw.SweepCase(c, exp, eta, label="gauss_gm", fault=plan("random_gauss", 0.25, param=2.0), agg="geomedian"),
        sw.SweepCase(c, exp, eta, label="rescale_trim_ka", fault=plan("rescale", 0.25, param=-4.0), agg="trimmed",
                     agg_param=0.25, mode="kasync"),
        sw.SweepCase(c, exp, eta, label="crash_ka", fault=plan("crash", 0.5, onset=2.0), mode="kasync"),
        sw.SweepCase(c, exp, eta, label="crash_kb", fault=plan("crash", 0.5, onset=2.0), mode="kbatch"),
        sw.SweepCase(c, exp, eta, label="flip_median", fault=plan("sign_flip", 0.25), agg="median"),
    ]


def _forced(linreg):
    data, X, y, eta = linreg
    keys = jax.random.split(jax.random.PRNGKey(5), R)
    common = dict(n_workers=N, num_iters=100, eval_every=25)
    want = _reference(("forced",), lambda: jsw.run_sweep(jax_loss, jnp.zeros((D,)), data.X, data.y,
                                                        cases=_forced_cases("jax", eta), keys=keys, unroll=1,
                                                        partition="none", **common))
    tcases = _forced_cases("torch", eta)
    got = _reference(("forced_torch",), lambda: tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=tcases,
                                                              keys=np.asarray(keys), device="cpu", **common))
    return want, got, tcases


@pytest.mark.parametrize("cell", range(7))
def test_forced_fault_cells_match_the_reference_sweep(cell, linreg):
    want, got, tcases = _forced(linreg)
    assert got.labels == want.labels
    _assert_as_reference(got.cell(cell), want.cell(cell), got.labels[cell])


@pytest.mark.parametrize("cell", range(7))
def test_forced_fault_cells_match_the_looped_engine(cell, linreg):
    _, X, y, _ = linreg
    _, got, tcases = _forced(linreg)
    c = tcases[cell]
    want = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N, controller=c.controller,
                               straggler=c.straggler, eta=c.eta, num_iters=100, eval_every=25,
                               keys=np.asarray(jax.random.split(jax.random.PRNGKey(5), R)), mode=c.mode,
                               fault=c.fault, agg=c.agg, agg_param=c.agg_param, device="cpu")
    _assert_as_looped(got.cell(cell), want, c.label)


def test_forced_grid_signature_matches_the_reference(linreg):
    eta = linreg[3]
    got, want = tsw.grid_signature(_forced_cases("torch", eta), N), jsw.grid_signature(_forced_cases("jax", eta), N)
    assert tuple(got) == tuple(want) and got.fault_kinds == (1, 2, 3, 4) and got.agg_kinds == (0, 1, 2, 3)
    assert tuple(tsw._full_signature(_forced_cases("torch", eta))) == tuple(
        jsw._full_signature(_forced_cases("jax", eta)))


def test_a_gauss_cell_leaves_a_clean_cell_bitwise(linreg):
    """A clean cell beside a gauss cell (a faulty program) against the same
    clean cell beside another clean one (the fault-free program): the noise
    key is folded in, so no split of the clean cell's chain moves."""
    _, X, y, eta = linreg
    ctrl, exp = tctl.FixedKController(n_workers=N, k=3), tstr.Exponential(1.0)
    clean = tsw.SweepCase(ctrl, exp, eta, label="clean")
    kw = dict(n_workers=N, num_iters=60, eval_every=20, key=prng.PRNGKey(8), n_replicas=R, device="cpu")
    plain = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=[clean, tsw.SweepCase(ctrl, exp, eta, label="b")],
                          **kw)
    gauss = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=[clean, tsw.SweepCase(
        ctrl, exp, eta, label="b", fault=tf.byzantine_plan(N, 0.25, "random_gauss", param=2.0))], **kw)
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(plain.cell(0), f), getattr(gauss.cell(0), f)), f
    assert not torch.equal(plain.loss[1], gauss.loss[1])


def test_fault_grid_repopulation_reuses_its_program(linreg):
    """Same families, aggregators and modes, other fractions, onsets,
    params, rates and trim fractions: the fault rows are leaves, so the
    program is reused (the reference's never-retraces test)."""
    _, X, y, eta = linreg

    def grid(frac, onset, param, rate, agg_param):
        ctrl, exp = tctl.FixedKController(n_workers=N, k=2), tstr.Exponential(rate=rate)
        return [
            tsw.SweepCase(ctrl, exp, eta, label="flip", fault=tf.byzantine_plan(N, frac, "sign_flip")),
            tsw.SweepCase(ctrl, exp, eta, label="crash_gm", fault=tf.byzantine_plan(N, frac, "crash", onset=onset),
                          agg="geomedian"),
            tsw.SweepCase(ctrl, exp, eta, label="rescale_ka", agg="trimmed", agg_param=agg_param, mode="kasync",
                          fault=tf.byzantine_plan(N, frac, "rescale", param=param)),
        ]

    kw = dict(n_workers=N, num_iters=40, eval_every=20, key=prng.PRNGKey(17), n_replicas=2, device="cpu")
    tsw.clear_sweep_cache()
    try:
        a = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=grid(0.25, 1.0, 2.0, 1.0, 0.2), **kw)
        assert tsw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        b = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=grid(0.5, 3.0, -1.5, 0.5, 0.3), **kw)
        assert tsw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        assert not torch.equal(a.loss, b.loss)
    finally:
        tsw.clear_sweep_cache()


# ------------------------------------------------------------ fig_byzantine


BYZ_R, BYZ_ITERS, BYZ_EVAL = 2, 50, 10


def _jax_twin(case):
    """The reference's SweepCase of a port case (fig_byzantine's cells)."""
    c = case.controller
    ctrl = (jctl.PflugController(n_workers=c.n_workers, k0=c.k0, step=c.step, thresh=c.thresh, burnin=c.burnin,
                                 k_max=c.k_max) if isinstance(c, tctl.PflugController)
            else jctl.FixedKController(n_workers=c.n_workers, k=c.k))
    fleet = jstr.WorkerFleet([jstr.Exponential(rate=m.rate) for m in case.straggler.models])
    fault = None if case.fault is None else jf.FaultPlan(
        [None if m is None else jf.FaultModel(m.family, m.onset, m.param) for m in case.fault.models])
    return jsw.SweepCase(ctrl, fleet, case.eta, label=case.label, fault=fault, agg=case.agg,
                         agg_param=case.agg_param)


def test_fig_byzantine_grid_matches_the_reference():
    """fig_byzantine's 18 cells (quickstart --setup byzantine) at R = 2 and
    50 iterations, against the reference's sweep on the same data: k of
    the fixed cells and time over the whole run, the loss and an adaptive
    k while the reference's loss is finite and below the initial loss."""
    cfg = quickstart.SETUPS["byzantine"]
    data = jax_linreg(jax.random.PRNGKey(0), m=cfg["m"], d=cfg["d"])
    X, y = torch.from_numpy(np.array(data.X)), torch.from_numpy(np.array(data.y))
    eta = quickstart.step_size(X, cfg["edge_fraction"])
    tcases = quickstart.cases("byzantine", eta=eta)
    assert len(tcases) == 18 and len({c.label for c in tcases}) == 18
    keys = jax.random.split(jax.random.PRNGKey(1), BYZ_R)
    common = dict(n_workers=cfg["n"], num_iters=BYZ_ITERS, eval_every=BYZ_EVAL)
    want = jsw.run_sweep(jax_loss, jnp.zeros((cfg["d"],)), data.X, data.y, cases=[_jax_twin(c) for c in tcases],
                         keys=keys, unroll=1, partition="none", **common)
    got = tsw.run_sweep(torch_loss, torch.zeros(cfg["d"]), X, y, cases=tcases, keys=np.asarray(keys), device="cpu",
                        **common)
    assert got.labels == want.labels
    initial = float(np.mean(np.asarray(data.y, np.float64) ** 2))  # the loss at w = 0
    n_held = 0
    for g, c in enumerate(tcases):
        w, t = want.cell(g), got.cell(g)
        wl = np.asarray(w.loss)
        held = np.isfinite(wl) & (wl < initial)
        n_held += int(held.sum())
        np.testing.assert_allclose(_np(t.time), np.asarray(w.time), rtol=TIME_RTOL, err_msg=c.label)
        if isinstance(c.controller, tctl.FixedKController):
            np.testing.assert_array_equal(_np(t.k), np.asarray(w.k), err_msg=c.label)
        else:
            np.testing.assert_array_equal(_np(t.k)[held], np.asarray(w.k)[held], err_msg=c.label)
        np.testing.assert_allclose(_np(t.loss)[held], wl[held], rtol=LOSS_RTOL, err_msg=c.label)
    assert n_held >= 0.9 * got.loss.numel()
    # the attack bites: the weighted mean at k = 16 and 30% ends above its clean twin
    assert float(got.loss[tcases.index(next(c for c in tcases if c.label == "k16|mean|byz30")), :, -1].mean()) > \
        float(got.loss[tcases.index(next(c for c in tcases if c.label == "k16|mean|byz0")), :, -1].mean())
