"""The port's simulation engine (repro_torch.core, repro_torch.data) against
the JAX package on the same inputs, on the CPU.

Tolerances, by layer (torch 2.13 against XLA CPU under JAX 0.9.0):
- threefry bits, uniforms, ranks, masks and selects are exact;
- `log1p` differs by at most 1 ulp, so a log1p family's times are within 2
  ulp (Pareto, through `exp` as well, within 4);
- trajectories: k equal, `time` within 1e-5 and loss within 1e-4
  relative.  The reference disagrees with itself by 1.7e-5 in loss
  (`run_monte_carlo` against `simulate_fastest_k`), and matmul and
  reduction orders differ between the libraries.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import async_sim as jasync  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core import montecarlo as jmc  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.core import theory as jth  # noqa: E402
from repro.data import make_linreg_data as jax_linreg  # noqa: E402
from repro_torch.checkpoint import convert  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import async_sim as tasync  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import montecarlo as tmc  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.core import theory as tth  # noqa: E402
from repro_torch.core.gradsource import PerExampleSource  # noqa: E402
from repro_torch.data import make_linreg_data as torch_linreg  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402

TIME_RTOL, LOSS_RTOL = 1e-5, 1e-4
N, M, D = 6, 60, 4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ulps(got, want):
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.array_equal(got[~finite], want[~finite])
    return float(np.max(np.abs(got[finite] - want[finite]) / np.spacing(np.abs(want[finite])), initial=0.0))


def jax_loss(w, X, y):
    return (X @ w - y) ** 2


def torch_loss(w, X, y):
    return (X @ w - y) ** 2


def _twin(jmodel):
    """The port's model with the reference model's fields."""
    return getattr(tstr, type(jmodel).__name__)(**dataclasses.asdict(jmodel))


FAMILIES = [
    jstr.Exponential(rate=1.0),
    jstr.Exponential(rate=0.3),
    jstr.ShiftedExponential(shift=0.5, rate=2.0),
    jstr.Pareto(x_m=1.0, alpha=2.5),
    jstr.Bimodal(fast_mean=1.0, slow_mean=10.0, p_slow=0.2),
    jstr.Deterministic(value=1.5),
]
ULP_BOUND = {"Exponential": 2, "ShiftedExponential": 2, "Pareto": 4, "Bimodal": 2, "Deterministic": 0}


# ---------------------------------------------------------------- straggler


@pytest.mark.parametrize("model", FAMILIES, ids=repr)
def test_family_sample(model):
    key = jax.random.PRNGKey(17)
    want = model.sample(key, 500)
    got = _twin(model).sample(prng.as_key(np.asarray(key)), 500)
    assert _ulps(got, want) <= ULP_BOUND[type(model).__name__]
    if isinstance(model, jstr.Bimodal):  # the mode select is exact: same v, same slow set
        jbase = jstr._base_draws(key, 500, True)
        tbase = tstr._base_draws(prng.as_key(np.asarray(key)), 500, True)
        np.testing.assert_array_equal(_np(tbase.u), np.asarray(jbase.u))
        np.testing.assert_array_equal(_np(tbase.v) < model.p_slow, np.asarray(jbase.v) < model.p_slow)


def test_fleet_sample_with_schedule_and_inactive_slots():
    models = [jstr.Exponential(1.0), jstr.Pareto(1.0, 3.0), jstr.Bimodal(1.0, 5.0, 0.3),
              jstr.ShiftedExponential(0.2, 1.5), jstr.Deterministic(2.0)]
    pmat, kinds, _ = jstr.pack_params_per_worker(jstr.WorkerFleet(models), 8)
    tpmat, tkinds, _ = tstr.pack_params_per_worker(tstr.WorkerFleet([_twin(m) for m in models]), 8)
    np.testing.assert_array_equal(pmat, tpmat)
    np.testing.assert_array_equal(kinds, tkinds)
    for mode, times, scales in (("step", (1.0, 3.0), (0.5, 2.0)), ("linear", (0.0, 4.0), (1.0, 0.25))):
        sched = jstr.pack_schedule(jstr.RateSchedule(times, scales, mode=mode, leaf=0), 8)
        tsched = tstr.pack_schedule(tstr.RateSchedule(times, scales, mode=mode, leaf=0), 8)
        for t in (0.0, 0.5, 1.0, 2.0, 3.5, 10.0):
            want = jstr.apply_rate_schedule(jnp.asarray(pmat), *(jnp.asarray(a) for a in sched), t)
            got = tstr.apply_rate_schedule(torch.from_numpy(tpmat), *(torch.as_tensor(a) for a in tsched),
                                           torch.tensor(t, dtype=torch.float32))
            np.testing.assert_array_equal(_np(got), np.asarray(want))
            key = jax.random.fold_in(jax.random.PRNGKey(3), int(t * 10))
            jt = jstr.sample_times_per_worker(jnp.asarray(kinds), want, key)
            tt = tstr.sample_times_per_worker(torch.from_numpy(tkinds), got, prng.as_key(np.asarray(key)))
            assert _ulps(tt, jt) <= 4
            assert np.all(np.isinf(_np(tt)[5:]))


def test_host_analytics():
    for model in FAMILIES[:5]:
        twin = _twin(model)
        u = np.linspace(0.01, 0.99, 7)
        np.testing.assert_allclose(twin.quantile(u), model.quantile(u), rtol=1e-12)
        np.testing.assert_allclose(twin.cdf(u * 3), model.cdf(u * 3), rtol=1e-12)
        for k in (1, 3, 5):
            np.testing.assert_allclose(twin.mean_order_statistic(k, 5), model.mean_order_statistic(k, 5), rtol=1e-12)
            np.testing.assert_allclose(twin.var_order_statistic(k, 5), model.var_order_statistic(k, 5), rtol=1e-12)


# -------------------------------------------------------------- aggregation


def _times_with_ties(n, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, max(2, n // 3), size=n).astype(np.float32)  # many ties
    t[rng.choice(n, size=max(1, n // 5), replace=False)] = np.inf  # inactive slots
    return t


@pytest.mark.parametrize("n", [1, 7, 50, 191, 192, 300])
def test_worker_ranks_both_paths(n):
    t = _times_with_ties(n, n)
    want = np.asarray(jagg.worker_ranks(jnp.asarray(t)))
    np.testing.assert_array_equal(want, np.argsort(np.argsort(t, kind="stable"), kind="stable"))
    for method in ("auto", "pairwise", "sort"):
        np.testing.assert_array_equal(_np(tagg.worker_ranks(torch.from_numpy(t), method)), want)


@pytest.mark.parametrize("n", [6, 191, 192])
def test_fastest_k_mask_time(n):
    t = _times_with_ties(n, 2 * n)
    active = int(np.isfinite(t).sum())
    for k in sorted({1, 2, active // 2 + 1, active}):
        jm, jt = jagg.fastest_k_mask_time(jnp.asarray(t), jnp.int32(k))
        tm, tt = tagg.fastest_k_mask_time(torch.from_numpy(t), torch.tensor(k, dtype=torch.int32))
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    with pytest.raises(ValueError, match="rank method"):
        tagg.worker_ranks(torch.from_numpy(t), "topk")


def test_weighted_losses_and_comm():
    rng = np.random.default_rng(0)
    losses = rng.random(60).astype(np.float32)
    mask = (rng.random(6) < 0.5).astype(np.float32)
    k = int(mask.sum()) or 1
    jk, tk = jnp.int32(k), torch.tensor(k, dtype=torch.int32)
    np.testing.assert_allclose(_np(tagg.fastest_k_weighted_loss(torch.from_numpy(losses), torch.from_numpy(mask), tk, 10)),
                               np.asarray(jagg.fastest_k_weighted_loss(jnp.asarray(losses), jnp.asarray(mask), jk, 10)),
                               rtol=1e-6)
    np.testing.assert_array_equal(_np(tagg.per_example_weights(torch.from_numpy(mask), tk, 10)),
                                  np.asarray(jagg.per_example_weights(jnp.asarray(mask), jk, 10)))
    for n_active in (0, 3, 6):
        np.testing.assert_allclose(
            _np(tagg.active_worker_mean_loss(torch.from_numpy(losses), n_active, 6, 10)),
            np.asarray(jagg.active_worker_mean_loss(jnp.asarray(losses), jnp.int32(n_active), 6, 10)), rtol=1e-6)
    comm = (jagg.CommModel(0.25, 0.1), tagg.CommModel(0.25, 0.1))
    np.testing.assert_array_equal(_np(comm[1].time(tk)), np.asarray(comm[0].time(jk)))


# --------------------------------------------------------------- controller


def _controller_pair(name):
    kw = {
        "pflug": dict(k0=1, step=1, thresh=2, burnin=3),
        "sketched_pflug": dict(k0=1, step=2, thresh=2, burnin=3, sketch_dim=4),
        "fixed": dict(k=3),
        "schedule": dict(switch_times=[0.5, 1.5, 2.5], k0=1, step=2),
        "variance_ratio": dict(k0=1, step=1, burnin=4, decay=0.8, ratio_thresh=0.3),
    }[name]
    return jctl.get_controller(name, 8, **kw), tctl.get_controller(name, 8, **kw)


@pytest.mark.parametrize("tree", ["tensor", "dict"])
@pytest.mark.parametrize("name", ["pflug", "sketched_pflug", "fixed", "schedule", "variance_ratio"])
def test_controller_update_on_a_gradient_sequence(name, tree):
    jc, tc = _controller_pair(name)
    rng = np.random.default_rng(5)
    base, flip = rng.standard_normal((2, 6)).astype(np.float32)
    # aligned gradients first (the transient), then noisy sign flips (the stationary phase)
    grads = [base * (1.0 + 0.1 * i) if i < 6 else
             (flip * (-1) ** i + 0.3 * rng.standard_normal(6)).astype(np.float32) for i in range(40)]
    as_tree = (lambda g, lib: g) if tree == "tensor" else (lambda g, lib: {"w": g[:4], "b": g[4:]})
    p0 = np.zeros(6, np.float32)
    js = jc.init(as_tree(jnp.asarray(p0), jnp))
    ts = tc.init(as_tree(torch.from_numpy(p0), torch))
    for i, g in enumerate(grads):
        t = np.float32(0.1 * (i + 1))
        js, jk = jc.update(js, as_tree(jnp.asarray(g), jnp), jnp.float32(t))
        ts, tk = tc.update(ts, as_tree(torch.from_numpy(g), torch), torch.tensor(t))
        assert int(tk) == int(jk), (i, int(tk), int(jk))
        for f in ("count_negative", "count_iter", "n_switches"):
            if hasattr(js, f):
                assert int(getattr(ts, f)) == int(getattr(js, f)), (i, f)
    if name != "fixed":
        assert int(tk) > 1  # the sequence made the controller switch


def test_sketch_paths_match_jax_keystr():
    from repro_torch.core.tree import leaves_with_path

    tree = {"w": torch.zeros(2), "b": {"x": torch.zeros(1)}, "t": (torch.zeros(1), [torch.zeros(1)])}
    jtree = jax.tree.map(lambda a: jnp.asarray(_np(a)), tree, is_leaf=lambda a: isinstance(a, torch.Tensor))
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [p for p, _ in leaves_with_path(tree)] == want
    assert [p for p, _ in leaves_with_path(torch.zeros(3))] == [""]


# ------------------------------------------------------------------- theory


def test_theory_matches_reference():
    js, ts = jth.example1_system(), tth.example1_system()
    t = np.linspace(0.0, 50.0, 11)
    np.testing.assert_allclose(tth.switching_times(ts), jth.switching_times(js), rtol=1e-12)
    np.testing.assert_allclose(tth.switching_times(ts, step=2), jth.switching_times(js, step=2), rtol=1e-12)
    for k in (1, 3, 5):
        np.testing.assert_allclose(tth.error_bound(ts, k, t), jth.error_bound(js, k, t), rtol=1e-12)
    np.testing.assert_allclose(tth.adaptive_bound_curve(ts, t), jth.adaptive_bound_curve(js, t), rtol=1e-12)
    models = [jstr.Exponential(1.0), jstr.Pareto(1.0, 3.0), jstr.ShiftedExponential(0.5, 2.0)]
    for k in (1, 2, 3):
        np.testing.assert_allclose(tth.hetero_order_stat_moments([_twin(m) for m in models], k),
                                   jth.hetero_order_stat_moments(models, k), rtol=1e-12)
    fleet = tstr.WorkerFleet([_twin(m) for m in models])
    jfleet = jstr.WorkerFleet(models)
    sys_t = dataclasses.replace(ts, n=3, straggler=fleet)
    sys_j = dataclasses.replace(js, n=3, straggler=jfleet)
    np.testing.assert_allclose(tth.switching_times(sys_t), jth.switching_times(sys_j), rtol=1e-12)


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("partitionable", [True, False])
def test_make_linreg_data(partitionable):
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        want = jax_linreg(jax.random.PRNGKey(0), m=200, d=10)
        with prng.threefry_mode(partitionable):
            got = torch_linreg(prng.PRNGKey(0), m=200, d=10, device="cpu")
    finally:
        jax.config.update("jax_threefry_partitionable", before)
    np.testing.assert_array_equal(_np(got.X), np.asarray(want.X))
    # y = X w_bar (exact integers) + unit noise through erfinv: <= 64 ulp of the noise
    np.testing.assert_allclose(_np(got.y), np.asarray(want.y), rtol=1e-6)
    np.testing.assert_allclose(got.f_star, want.f_star, rtol=1e-2)


# ------------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def linreg():
    data = jax_linreg(jax.random.PRNGKey(0), m=M, d=D)
    return data, torch.from_numpy(np.array(data.X)), torch.from_numpy(np.array(data.y))


def _assert_trajectories(got, want, tag=""):
    np.testing.assert_array_equal(_np(got.k), np.asarray(want.k), err_msg=f"k {tag}")
    np.testing.assert_allclose(_np(got.time), np.asarray(want.time), rtol=TIME_RTOL, err_msg=f"time {tag}")
    np.testing.assert_allclose(_np(got.loss), np.asarray(want.loss), rtol=LOSS_RTOL, err_msg=f"loss {tag}")
    np.testing.assert_array_equal(got.iteration, want.iteration)


ENGINE_CONTROLLERS = {
    "fixed": dict(k=2),
    "pflug": dict(k0=1, step=1, thresh=3, burnin=5),
    "sketched_pflug": dict(k0=1, step=1, thresh=3, burnin=5, sketch_dim=8),
    "schedule": dict(switch_times=[2.0, 6.0], k0=1, step=2),
    "variance_ratio": dict(k0=1, step=2, burnin=10),
}


@pytest.mark.parametrize("name", list(ENGINE_CONTROLLERS))
def test_run_monte_carlo_per_replica(name, linreg):
    data, X, y = linreg
    jkeys = jax.random.split(jax.random.PRNGKey(7), 3)
    common = dict(n_workers=N, eta=0.005, num_iters=90, eval_every=20)
    want = jmc.run_monte_carlo(jax_loss, jnp.zeros((D,)), data.X, data.y,
                               controller=jctl.get_controller(name, N, **ENGINE_CONTROLLERS[name]),
                               straggler=jstr.Exponential(1.0), keys=jkeys, **common)
    got = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y,
                              controller=tctl.get_controller(name, N, **ENGINE_CONTROLLERS[name]),
                              straggler=tstr.Exponential(1.0), keys=np.asarray(jkeys), device="cpu", **common)
    assert got.time.shape == (3, 5) and got.k.dtype == torch.int32
    _assert_trajectories(got, want, name)


def test_run_monte_carlo_fleet_with_schedule_and_comm(linreg):
    data, X, y = linreg
    models = [jstr.Exponential(1.0), jstr.Pareto(1.0, 3.0), jstr.Bimodal(1.0, 4.0, 0.25),
              jstr.ShiftedExponential(0.3, 2.0), jstr.Exponential(0.5)]  # 5 active of 6 slots
    sched = dict(times=(2.0, 5.0), scales=(0.5, 2.0), mode="linear", leaf=0)
    jfleet = jstr.WorkerFleet(models, jstr.RateSchedule(**sched))
    tfleet = tstr.WorkerFleet([_twin(m) for m in models], tstr.RateSchedule(**sched))
    jkeys = jax.random.split(jax.random.PRNGKey(11), 2)
    common = dict(n_workers=N, eta=0.005, num_iters=70, eval_every=25)
    want = jmc.run_monte_carlo(jax_loss, jnp.zeros((D,)), data.X, data.y, keys=jkeys, straggler=jfleet,
                               controller=jctl.PflugController(n_workers=5, k0=1, thresh=2, burnin=3),
                               comm=jagg.CommModel(0.1, 0.05), **common)
    got = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, keys=np.asarray(jkeys), straggler=tfleet,
                              controller=tctl.PflugController(n_workers=5, k0=1, thresh=2, burnin=3),
                              comm=tagg.CommModel(0.1, 0.05), device="cpu", **common)
    _assert_trajectories(got, want, "fleet")


def test_run_monte_carlo_comm_model_and_key_split(linreg):
    data, X, y = linreg
    common = dict(n_workers=N, eta=0.005, num_iters=40, eval_every=15, n_replicas=2)
    want = jmc.run_monte_carlo(jax_loss, jnp.zeros((D,)), data.X, data.y, key=jax.random.PRNGKey(4),
                               controller=jctl.FixedKController(n_workers=N, k=3),
                               straggler=jstr.ShiftedExponential(0.5, 1.0), comm=jagg.CommModel(0.2, 0.1), **common)
    got = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, key=np.asarray(jax.random.PRNGKey(4)),
                              controller=tctl.FixedKController(n_workers=N, k=3),
                              straggler=tstr.ShiftedExponential(0.5, 1.0), comm=tagg.CommModel(0.2, 0.1),
                              device="cpu", **common)
    _assert_trajectories(got, want, "comm")
    s_t, s_j = tmc.summarize(got), jmc.summarize(want)
    assert s_t["n_replicas"] == s_j["n_replicas"] == 2
    for f in ("time_mean", "time_ci95", "k_mean"):
        np.testing.assert_allclose(s_t[f], s_j[f], rtol=TIME_RTOL)
    np.testing.assert_allclose(s_t["loss_mean"], s_j["loss_mean"], rtol=LOSS_RTOL)


def test_simulate_fastest_k(linreg):
    data, X, y = linreg
    key = jax.random.PRNGKey(9)
    kw = dict(n_workers=N, eta=0.005, num_iters=50, eval_every=10)
    want = jsim.simulate_fastest_k(jax_loss, jnp.zeros((D,)), data.X, data.y, key=key,
                                   controller=jctl.PflugController(n_workers=N, thresh=2, burnin=2),
                                   straggler=jstr.Exponential(1.0), **kw)
    got = tsim.simulate_fastest_k(torch_loss, torch.zeros(D), X, y, key=np.asarray(key),
                                  controller=tctl.PflugController(n_workers=N, thresh=2, burnin=2),
                                  straggler=tstr.Exponential(1.0), device="cpu", **kw)
    assert got["k"] == want["k"]
    np.testing.assert_allclose(got["time"], want["time"], rtol=TIME_RTOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


def test_simulate_async_sgd(linreg):
    data, X, y = linreg
    s = M // N

    def jgrad(w, i):
        return jax.grad(lambda w: jnp.mean(jax_loss(w, data.X[i * s:(i + 1) * s], data.y[i * s:(i + 1) * s])))(w)

    def tgrad(w, i):
        return torch.func.grad(lambda w: torch_loss(w, X[i * s:(i + 1) * s], y[i * s:(i + 1) * s]).mean())(w)

    key = jax.random.PRNGKey(2)
    kw = dict(n_workers=N, eta=0.005, total_time=12.0, eval_every=5)
    want = jasync.simulate_async_sgd(jgrad, lambda w: jnp.mean(jax_loss(w, data.X, data.y)), jnp.zeros((D,)),
                                     straggler=jstr.Exponential(1.0), key=key, **kw)
    got = tasync.simulate_async_sgd(tgrad, lambda w: torch_loss(w, X, y).mean(), torch.zeros(D),
                                    straggler=tstr.Exponential(1.0), key=np.asarray(key), device="cpu", **kw)
    assert got["updates"] == want["updates"] and len(got["updates"]) > 5
    np.testing.assert_allclose(got["time"], want["time"], rtol=TIME_RTOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


# tests/goldens/quadratic_mc.npz was made by the JAX package with its legacy
# threefry (tests/goldens/gen_quadratic_goldens.py).  The port reproduces
# `k` exactly and, for this input, `time` bit for bit (measured gap 0.0:
# the 1-ulp log1p differences did not land on these draws); a 1-ulp log1p
# gap would move `time` by ~1e-7 relative, inside the 1e-6 held here.  The
# loss differs by up to 1.1e-5 relative (matmul and reduction order; the
# reference itself is 2.6e-6 off the goldens on this JAX).
GOLDEN_TIME_RTOL, GOLDEN_LOSS_RTOL = 1e-6, 1e-4


@pytest.mark.parametrize("name", list(ENGINE_CONTROLLERS))
def test_sync_goldens_in_legacy_mode(name):
    from pathlib import Path

    gold = np.load(Path(__file__).parent / "goldens" / "quadratic_mc.npz")
    with prng.threefry_mode(False):
        data = torch_linreg(prng.PRNGKey(int(gold["data_seed"])), m=int(gold["m"]), d=int(gold["d"]), device="cpu")
        keys = prng.split(prng.PRNGKey(int(gold["key_seed"])), int(gold["n_replicas"]))
        ctrl = tctl.get_controller(name, int(gold["n_workers"]), **ENGINE_CONTROLLERS[name])
        got = tmc.run_monte_carlo(torch_loss, torch.zeros(int(gold["d"])), data.X, data.y,
                                  n_workers=int(gold["n_workers"]), controller=ctrl,
                                  straggler=tstr.Exponential(1.0), eta=float(gold["eta"]),
                                  num_iters=int(gold["num_iters"]), keys=keys, eval_every=int(gold["eval_every"]),
                                  device="cpu")
    np.testing.assert_array_equal(_np(got.k), gold[f"{name}__sync__k"])
    np.testing.assert_allclose(_np(got.time), gold[f"{name}__sync__time"], rtol=GOLDEN_TIME_RTOL)
    np.testing.assert_allclose(_np(got.loss), gold[f"{name}__sync__loss"], rtol=GOLDEN_LOSS_RTOL)


def test_quickstart_cells_match_looped_reference():
    """The slice as a whole: the quickstart's two cases (adaptive and fixed
    k) against the reference's run_monte_carlo on the same data and eta."""
    setup = quickstart.SETUPS["quickstart"]
    data = jax_linreg(jax.random.PRNGKey(0), m=setup["m"], d=setup["d"])
    eta = 0.5 / (2 * float(jnp.linalg.eigvalsh(data.X.T @ data.X / setup["m"]).max()))
    out = quickstart.run("quickstart", iters=200, replicas=2, device="cpu", eta=eta)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    jcases = {"adaptive": jctl.PflugController(n_workers=setup["n"], **setup["adaptive"]),
              "fixed_k2": jctl.FixedKController(n_workers=setup["n"], k=2)}
    assert set(out["results"]) == set(jcases)
    for label, ctrl in jcases.items():
        want = jmc.run_monte_carlo(jax_loss, jnp.zeros((setup["d"],)), data.X, data.y, n_workers=setup["n"],
                                   controller=ctrl, straggler=jstr.Exponential(1.0), eta=eta, num_iters=200,
                                   keys=keys, eval_every=setup["eval_every"])
        _assert_trajectories(out["results"][label], want, label)
    np.testing.assert_allclose(out["f_star"], data.f_star, rtol=1e-2)


@pytest.mark.parametrize("setup", ["quickstart", "ablation"])
def test_quickstart_grid_matches_its_looped_path(setup):
    """One `run_sweep` grid against one `run_monte_carlo` call per case
    (``--looped``): time and k bitwise, the eval loss within 1e-6 relative
    (the CPU's reduction of lane-minor losses rounds differently for another
    lane count; tests/test_torch_sweep.py)."""
    grid = quickstart.run(setup, iters=60, replicas=2, device="cpu")
    looped = quickstart.run(setup, iters=60, replicas=2, device="cpu", looped=True)
    assert list(grid["results"]) == list(looped["results"]) == [c.label for c in quickstart.cases(
        setup, quickstart.inputs(setup, 2, "cpu")[0], grid["eta"])]
    for label, got in grid["results"].items():
        want = looped["results"][label]
        assert torch.equal(got.time, want.time) and torch.equal(got.k, want.k), label
        np.testing.assert_allclose(_np(got.loss), _np(want.loss), rtol=1e-6, err_msg=label)


def test_quickstart_main_runs_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu", "--iters", "40", "--replicas", "2"])
    text = capsys.readouterr().out
    assert "adaptive" in text and "fixed_k2" in text and "2 cases (as one grid)" in text
    quickstart.main(["--device", "cpu", "--iters", "40", "--replicas", "2", "--looped"])
    assert "2 cases (looped, a program each)" in capsys.readouterr().out


def test_engine_inputs_from_jax_arrays(linreg):
    data, X, y = linreg
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    params = {"w": jnp.ones((D,)), "b": jnp.zeros(())}
    tkeys, tparams, (tX, ty) = convert.engine_inputs(np.asarray(keys), jax.tree.map(np.asarray, params),
                                                     np.asarray(data.X), np.asarray(data.y), device="cpu")
    np.testing.assert_array_equal(_np(tkeys), np.asarray(keys))
    assert tkeys.dtype == torch.int64 and tparams["w"].dtype == torch.float32
    np.testing.assert_array_equal(_np(tX), np.asarray(data.X))
    np.testing.assert_array_equal(_np(tparams["b"]), 0.0)


# -------------------------------------------------------- cache, validation


def _small_run(X, y, **kw):
    args = dict(n_workers=N, controller=tctl.FixedKController(n_workers=N, k=2), straggler=tstr.Exponential(1.0),
                eta=0.005, num_iters=10, eval_every=5, key=prng.PRNGKey(0), n_replicas=2, device="cpu")
    args.update(kw)
    return tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, **args)


def test_program_cache_hits_and_evicts(linreg):
    _, X, y = linreg
    tmc.clear_program_cache()
    size = tmc.program_cache_size()
    try:
        a = _small_run(X, y)
        assert tmc.program_cache_stats() == {"programs": 1, "traces": 1}
        b = _small_run(X, y)
        assert tmc.program_cache_stats() == {"programs": 1, "traces": 1}
        assert torch.equal(a.loss, b.loss)
        _small_run(X[:30], y[:30])  # new input shapes: the program builds again
        assert tmc.program_cache_stats() == {"programs": 1, "traces": 2}
        tmc.set_program_cache_size(1)
        _small_run(X, y, eta=0.004)  # evicts the first configuration
        assert tmc.program_cache_stats() == {"programs": 1, "traces": 3}
        _small_run(X, y)  # re-entry builds exactly once
        assert tmc.program_cache_stats() == {"programs": 1, "traces": 4}
        with pytest.raises(ValueError):
            tmc.set_program_cache_size(0)
    finally:
        tmc.set_program_cache_size(size)
        tmc.clear_program_cache()


@pytest.mark.parametrize("kw,err,match", [
    (dict(mode="nope"), ValueError, "unknown mode"),
    (dict(agg="nope"), ValueError, "unknown aggregator"),
    (dict(agg="median", mode="kbatch"), ValueError, "kbatch"),
    (dict(eval_every=0), ValueError, "eval_every"),
    (dict(num_iters=0), ValueError, "num_iters"),
    (dict(n_workers=7), ValueError, "not divisible"),
    (dict(key=None), ValueError, "keys="),
    (dict(straggler=tstr.WorkerFleet([tstr.Exponential()] * 4)), ValueError, "fleet has 4 models"),
    (dict(mode="kasync", agg="trimmed"), NotImplementedError, "item 10"),
    (dict(mode="kbatch", fault=object()), NotImplementedError, "item 10"),
    (dict(agg="trimmed"), NotImplementedError, "item 10"),
    (dict(fault=object()), NotImplementedError, "item 10"),
])
def test_validation_errors(linreg, kw, err, match):
    _, X, y = linreg
    with pytest.raises(err, match=match):
        _small_run(X, y, **kw)


def test_build_stale_names_the_roadmap_item(linreg):
    """`build_stale` gives the async modes' closures over the worker-major
    shards; the mode tails built on them refuse faults, naming ROADMAP
    Queue 1 item 10."""
    from repro_torch.core import execmode

    _, X, y = linreg
    stale_grad, shard_grad_at = PerExampleSource(torch_loss).build_stale((X, y), N)
    s = M // N
    w = torch.arange(N * D, dtype=torch.float32).reshape(N, D) / 10
    want = torch.func.grad(lambda p: torch_loss(p, X[2 * s:3 * s], y[2 * s:3 * s]).mean())(w[2])
    torch.testing.assert_close(shard_grad_at(w, torch.tensor(2)), want)
    mask = torch.zeros(N)
    mask[2] = 1.0
    torch.testing.assert_close(stale_grad(w, mask, torch.tensor(1, dtype=torch.int32)), want)
    with pytest.raises(NotImplementedError, match="item 10"):
        execmode.make_mode_steps(n_slots=N, draw=None, sync_grad=None, stale_grad=stale_grad,
                                 shard_grad_at=shard_grad_at, comm_time=None, eta=0.1, ctrl_update=None,
                                 faults=object())
