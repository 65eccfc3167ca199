"""The port's execution modes (repro_torch.core.execmode) on the CPU: K-async
and K-batch-async through both engines, against the JAX package on the same
inputs, against the port's own host loop, and a mixed-mode grid against the
looped engine.

Tolerances:
- against the reference: k equal; `time` within 1e-6 relative, measured up
  to 3.9e-7 on these inputs (torch's log1p differs from XLA's by an ulp on
  some draws, and the clock sums every event's time); loss within 1e-4
  relative.  A Pflug cell may fork in k in at most 2 replicas (a near-zero
  inner product of consecutive gradients flips its sign event);
- the module's functions on the same inputs: masks, clocks and counters
  exact, gradients within 1e-5 relative;
- against the port's looped engine, a grid cell: `time` and k bitwise, the
  eval loss within 1e-6 relative (tests/test_torch_sweep.py);
- K = 1 kasync on a Deterministic fleet against the port's host loop
  (`async_sim`): update times bitwise, loss within 2e-5 relative (the host
  loop's shard mean and the engine's eq.-(2) weighting round differently).

The reference's engines run at unroll 1 here: it compiles in a third of the
time, and on this JAX unroll moves its results by an ulp at most.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core import execmode as jem  # noqa: E402
from repro.core import montecarlo as jmc  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.core import sweep as jsw  # noqa: E402
from repro.data import make_linreg_data as jax_linreg  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import async_sim as tasync  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import execmode as tem  # noqa: E402
from repro_torch.core import montecarlo as tmc  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.core import sweep as tsw  # noqa: E402
from repro_torch.core.gradsource import PerExampleSource  # noqa: E402
from repro_torch.data import make_linreg_data as torch_linreg  # noqa: E402

TIME_RTOL, LOSS_RTOL, MAX_FORKS = 1e-6, 1e-4, 2
LOOPED_LOSS_RTOL = 1e-6
N, M, D, R = 8, 160, 4, 3
ITERS, EVAL_EVERY = 40, 20


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_loss(w, X, y):
    return (X @ w - y) ** 2


def torch_loss(w, X, y):
    return (X @ w - y) ** 2


@pytest.fixture(scope="module")
def linreg():
    """The reference test's problem: m = 160, d = 4, 8 workers, and its
    async-stable step 0.05/L (stale K = 1 updates diverge at 0.5/L)."""
    data = jax_linreg(jax.random.PRNGKey(0), m=M, d=D)
    eta = 0.05 / (2 * float(np.linalg.eigvalsh(np.asarray(data.X, np.float64).T @ np.asarray(data.X) / M).max()))
    return data, torch.from_numpy(np.array(data.X)), torch.from_numpy(np.array(data.y)), eta


def _assert_as_reference(got, want, tag="", max_forks=0):
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


# ------------------------------------------------------------ the module


def test_renewal_remaining_matches_the_reference():
    rng = np.random.default_rng(0)
    fresh = rng.exponential(size=(3, 9)).astype(np.float32)
    fresh[:, -2:] = np.inf  # inactive slots draw +inf
    remaining = rng.exponential(size=(3, 9)).astype(np.float32)
    pending = rng.random((3, 9)) < 0.5
    want = np.asarray(jstr.renewal_remaining(jnp.asarray(fresh), jnp.asarray(pending), jnp.asarray(remaining)))
    got = tstr.renewal_remaining(torch.from_numpy(fresh), torch.from_numpy(pending), torch.from_numpy(remaining))
    np.testing.assert_array_equal(_np(got), want)


def test_init_exec_carry_matches_the_reference():
    params = {"w": np.arange(4, dtype=np.float32), "b": np.float32(0.5)}
    key = np.asarray(jax.random.PRNGKey(3))
    want = jem.init_exec_carry(jax.tree.map(jnp.asarray, params), 5, (jnp.int32(2),), jnp.asarray(key))
    got = tem.init_exec_carry({k: torch.as_tensor(v) for k, v in params.items()}, 5,
                              (torch.tensor(2, dtype=torch.int32),), prng.as_key(key))
    assert got._fields == want._fields and got.opt_state is None and want.opt_state is None
    for name in ("remaining", "staleness", "pending", "sim_time", "key"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(_np(g).astype(w.dtype), w, err_msg=name)
    assert (got.remaining.dtype, got.staleness.dtype, got.pending.dtype) == (torch.float32, torch.int32, torch.bool)
    for k in params:
        np.testing.assert_array_equal(_np(got.worker_params[k]), np.asarray(want.worker_params[k]))


def _snapshots(n=N, s=M // N, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, s, D)).astype(np.float32)
    y = rng.normal(size=(n, s)).astype(np.float32)
    wp = rng.normal(size=(n, D)).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[[1, 4, 6]] = 1.0
    return X, y, wp, mask


def test_stale_grad_fns_match_the_reference():
    """stale_grad (each slot's losses at its own snapshot, eq. (2), summed
    over the slots) and shard_grad_at for every slot, on the same snapshots."""
    X, y, wp, mask = _snapshots()
    j_stale, j_shard = map(jax.jit, jem.make_stale_grad_fns(jax_loss, jnp.asarray(X), jnp.asarray(y), N))
    t_stale, t_shard = tem.make_stale_grad_fns(torch_loss, torch.from_numpy(X), torch.from_numpy(y), N)
    for k in (1, 3):
        want = np.asarray(j_stale(jnp.asarray(wp), jnp.asarray(mask), jnp.int32(k)))
        got = t_stale(torch.from_numpy(wp), torch.from_numpy(mask), torch.tensor(k, dtype=torch.int32))
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)
    for i in range(N):
        want = np.asarray(j_shard(jnp.asarray(wp), jnp.int32(i)))
        got = t_shard(torch.from_numpy(wp), torch.tensor(i))
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


def test_stale_grad_fns_under_vmap_pick_each_lanes_slot():
    """Mapped over lanes with a different index each, shard_grad_at is each
    lane's unmapped call (the one-hot select reads no host value), to the
    rounding of the batched product."""
    X, y, wp, _ = _snapshots()
    _, shard = tem.make_stale_grad_fns(torch_loss, torch.from_numpy(X), torch.from_numpy(y), N)
    wps = torch.from_numpy(np.stack([wp, wp[::-1].copy(), wp * 2]))
    idx = torch.tensor([0, 5, 7])
    got = torch.func.vmap(shard)(wps, idx)
    for lane in range(3):
        np.testing.assert_allclose(_np(got[lane]), _np(shard(wps[lane], idx[lane])), rtol=1e-6)


@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_mode_steps_match_the_reference_step_by_step(mode):
    """Each field of one replica's carry after every step of
    `make_mode_steps`, both packages from the same carry and key: the
    clocks, staleness, pending flags, simulated time, key and k exactly,
    the parameters and snapshots within 1e-5."""
    X, y, _, _ = _snapshots()
    n, k = N, 3
    j_stale, j_shard = jem.make_stale_grad_fns(jax_loss, jnp.asarray(X), jnp.asarray(y), n)
    t_stale, t_shard = tem.make_stale_grad_fns(torch_loss, torch.from_numpy(X), torch.from_numpy(y), n)
    # uniform bits are exact in both packages, so every clock is too
    jdraw = lambda sub, t: 0.5 + jax.random.uniform(sub, (n,))  # noqa: E731
    tdraw = lambda sub, t: 0.5 + prng.uniform(sub, (n,))  # noqa: E731
    common = dict(n_slots=n, comm_time=None, eta=0.01, ctrl_update=lambda s, g, t, st: (s, s.k))
    jsteps = jem.make_mode_steps(draw=jdraw, sync_grad=None, stale_grad=j_stale, shard_grad_at=j_shard, **common)
    tsteps = tem.make_mode_steps(draw=tdraw, sync_grad=None, stale_grad=t_stale, shard_grad_at=t_shard, **common)
    state = tctl.FixedState(k=torch.tensor(k, dtype=torch.int32))
    key = jax.random.PRNGKey(4)
    jc = jem.init_exec_carry(jnp.zeros((D,)), n, jctl.FixedState(k=jnp.int32(k)), key)
    tc = tem.init_exec_carry(torch.zeros(D), n, state, prng.as_key(np.asarray(key)))
    jstep, tstep = jsteps[jem.MODES[mode]], tsteps[tem.MODES[mode]]
    for _ in range(6):
        jc, jk = jstep(jc)
        tc, tk = tstep(tc)
        assert int(tk) == int(jk)
        for name in ("remaining", "staleness", "pending", "sim_time", "key"):
            np.testing.assert_array_equal(_np(getattr(tc, name)), np.asarray(getattr(jc, name)).astype(
                _np(getattr(tc, name)).dtype), err_msg=name)
        np.testing.assert_allclose(_np(tc.params), np.asarray(jc.params), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(_np(tc.worker_params), np.asarray(jc.worker_params), rtol=1e-5, atol=1e-7)
    assert int(tc.staleness.max()) > 0  # the run made stale gradients


def test_mode_tails_refuse_faults_and_robust_aggregation():
    common = dict(n_slots=2, draw=None, sync_grad=None, stale_grad=None, shard_grad_at=None, comm_time=None, eta=0.1,
                  ctrl_update=None)
    for kw in (dict(faults=object()), dict(robust_agg=lambda *a: a)):
        with pytest.raises(NotImplementedError, match="item 10"):
            tem.make_mode_prelude_and_tails(**common, **kw)
    assert tem.MODES == jem.MODES and tem.ExecStats._fields == jem.ExecStats._fields


# ------------------------------------------------------- the looped engine


_REF = {}


def _reference(tag, fn):
    """A reference run, once per module."""
    if tag not in _REF:
        _REF[tag] = fn()
    return _REF[tag]


ASYNC_CONTROLLERS = {"fixed": dict(k=3), "pflug": dict(k0=1, step=1, thresh=3, burnin=5)}


@pytest.mark.parametrize("name", list(ASYNC_CONTROLLERS))
@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_run_monte_carlo_per_replica(mode, name, linreg):
    data, X, y, eta = linreg
    keys = jax.random.split(jax.random.PRNGKey(7), R)
    common = dict(n_workers=N, eta=eta, num_iters=ITERS, eval_every=EVAL_EVERY, mode=mode)
    want = _reference(("mc", mode, name), lambda: jmc.run_monte_carlo(
        jax_loss, jnp.zeros((D,)), data.X, data.y, controller=jctl.get_controller(name, N, **ASYNC_CONTROLLERS[name]),
        straggler=jstr.Exponential(1.0), keys=keys, unroll=1, **common))
    got = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y,
                              controller=tctl.get_controller(name, N, **ASYNC_CONTROLLERS[name]),
                              straggler=tstr.Exponential(1.0), keys=np.asarray(keys), device="cpu", **common)
    assert got.time.shape == (R, ITERS // EVAL_EVERY) and got.k.dtype == torch.int32
    _assert_as_reference(got, want, f"{mode}/{name}", MAX_FORKS if name == "pflug" else 0)


@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_run_monte_carlo_fleet_with_schedule_and_comm(mode, linreg):
    """A fleet of 6 active workers of 8 slots under a rate schedule, with a
    comm model: the receive window ages the carried clocks."""
    data, X, y, eta = linreg
    models = [("Exponential", dict(rate=1.0)), ("Pareto", dict(x_m=0.5, alpha=2.0)),
              ("ShiftedExponential", dict(shift=0.3, rate=2.0)), ("Deterministic", dict(value=1.2)),
              ("Exponential", dict(rate=0.25)), ("Bimodal", dict(fast_mean=1.0, slow_mean=4.0, p_slow=0.25))]
    sched = dict(times=(3.0, 8.0), scales=(0.5, 2.0), mode="linear", leaf=0)
    keys = jax.random.split(jax.random.PRNGKey(11), R)

    def fleet(mod):
        return mod.WorkerFleet([getattr(mod, name)(**kw) for name, kw in models], mod.RateSchedule(**sched))

    common = dict(n_workers=N, eta=eta, num_iters=20, eval_every=10, mode=mode)
    want = _reference(("fleet", mode), lambda: jmc.run_monte_carlo(
        jax_loss, jnp.zeros((D,)), data.X, data.y, controller=jctl.FixedKController(n_workers=6, k=2),
        straggler=fleet(jstr), comm=jagg.CommModel(0.1, 0.05), keys=keys, unroll=1, **common))
    got = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, controller=tctl.FixedKController(n_workers=6, k=2),
                              straggler=fleet(tstr), comm=tagg.CommModel(0.1, 0.05), keys=np.asarray(keys),
                              device="cpu", **common)
    _assert_as_reference(got, want, f"fleet/{mode}")


@pytest.mark.parametrize("entry", ["simulate_fastest_k", "run_monte_carlo_source"])
def test_other_entry_points_run_the_modes(entry, linreg):
    """`simulate_fastest_k` passes the mode to the engine (against the
    reference's); `run_monte_carlo_source` over a PerExampleSource is
    `run_monte_carlo`, bit for bit."""
    data, X, y, eta = linreg
    key = jax.random.PRNGKey(9)
    kw = dict(n_workers=N, eta=eta, num_iters=40, eval_every=10, mode="kasync")
    if entry == "simulate_fastest_k":
        want = _reference(("sim",), lambda: jsim.simulate_fastest_k(
            jax_loss, jnp.zeros((D,)), data.X, data.y, key=key, controller=jctl.FixedKController(n_workers=N, k=2),
            straggler=jstr.Exponential(1.0), **kw))
        got = tsim.simulate_fastest_k(torch_loss, torch.zeros(D), X, y, key=np.asarray(key),
                                      controller=tctl.FixedKController(n_workers=N, k=2),
                                      straggler=tstr.Exponential(1.0), device="cpu", **kw)
        assert got["k"] == want["k"]
        np.testing.assert_allclose(got["time"], want["time"], rtol=TIME_RTOL)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        return
    kw.update(mode="kbatch", num_iters=20, controller=tctl.FixedKController(n_workers=N, k=2),
              straggler=tstr.Exponential(1.0),
              key=np.asarray(key), n_replicas=2, device="cpu")
    got = tmc.run_monte_carlo_source(PerExampleSource(torch_loss), torch.zeros(D), (X, y), **kw)
    want = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, **kw)
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _host_loop(X, y, eta, straggler, key, total_time, eval_every):
    """The port's event-driven host loop with the engines' gradient: the
    mean loss over the worker's contiguous shard."""
    s = M // N

    def grad_fn(w, i):
        return torch.func.grad(lambda p: torch_loss(p, X[i * s:(i + 1) * s], y[i * s:(i + 1) * s]).mean())(w)

    return tasync.simulate_async_sgd(grad_fn, lambda w: torch_loss(w, X, y).mean(), torch.zeros(D), n_workers=N,
                                     eta=eta, straggler=straggler, total_time=total_time, key=key,
                                     eval_every=eval_every, device="cpu")


@pytest.mark.parametrize("capture_sweep", [False, True], ids=["looped", "as a grid cell"])
def test_kasync_k1_on_a_deterministic_fleet_is_the_host_loop(capture_sweep, linreg):
    """K = 1 with every clock tied: the engine takes the lowest index first,
    as the host loop's heap does, so the update times are the host loop's
    bit for bit (the twin of the reference's test)."""
    _, X, y, eta = linreg
    key = np.asarray(jax.random.PRNGKey(3))
    case = tsw.SweepCase(tctl.FixedKController(n_workers=N, k=1), tstr.Deterministic(1.0), eta, mode="kasync")
    kw = dict(num_iters=64, eval_every=4, keys=key[None], device="cpu")
    if capture_sweep:
        res = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, n_workers=N, cases=[case], **kw).cell(0)
    else:
        res = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N, controller=case.controller,
                                  straggler=case.straggler, eta=eta, mode="kasync", **kw)
    h = _host_loop(X, y, eta, tstr.Deterministic(1.0), key, float(res.time[0, -1]), 4)
    ne = min(len(h["time"]), res.time.shape[1])
    assert ne >= 64 // 4 - 1
    np.testing.assert_array_equal(_np(res.time[0, :ne]), np.asarray(h["time"][:ne], np.float32))
    np.testing.assert_allclose(_np(res.loss[0, :ne]), np.asarray(h["loss"][:ne]), rtol=2e-5, atol=1e-7)


def test_kbatch_ties_on_a_deterministic_fleet_match_the_reference(linreg):
    """Every clock tied, K = 3: each inner event takes the lowest index of
    the minima (the reference's argmin), so the order of completions, the
    redispatches and every clock follow the reference's."""
    data, X, y, eta = linreg
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    common = dict(n_workers=N, eta=eta, num_iters=30, eval_every=10, mode="kbatch")
    want = jmc.run_monte_carlo(jax_loss, jnp.zeros((D,)), data.X, data.y, keys=keys,
                               controller=jctl.FixedKController(n_workers=N, k=3), straggler=jstr.Deterministic(1.0),
                               unroll=1, **common)
    got = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, keys=np.asarray(keys),
                              controller=tctl.FixedKController(n_workers=N, k=3), straggler=tstr.Deterministic(1.0),
                              device="cpu", **common)
    np.testing.assert_array_equal(_np(got.time), np.asarray(want.time))
    _assert_as_reference(got, want, "deterministic kbatch")


def test_kasync_with_k_equal_to_n_is_the_sync_engine(linreg):
    """K = n: every worker completes in every event, no snapshot goes stale,
    and the step is the k = n sync step (the reference's twin)."""
    _, X, y, eta = linreg
    kw = dict(n_workers=N, controller=tctl.FixedKController(n_workers=N, k=N), straggler=tstr.Exponential(1.0),
              eta=eta, num_iters=80, key=prng.PRNGKey(5), n_replicas=3, eval_every=20, device="cpu")
    sync = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, mode="sync", **kw)
    kasync = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, mode="kasync", **kw)
    assert torch.equal(sync.time, kasync.time) and torch.equal(sync.k, kasync.k)
    np.testing.assert_allclose(_np(kasync.loss), _np(sync.loss), rtol=1e-5)


class _ProbeState(NamedTuple):
    k: torch.Tensor
    stale_seen: torch.Tensor


class _StalenessProbe:
    """k = 1 until a stale gradient is applied, then 2."""

    n_workers = N

    def init(self, params_like):
        return _ProbeState(k=torch.tensor(1, dtype=torch.int32), stale_seen=torch.tensor(False))

    def update(self, state, grads, sim_time, stats=None):
        stale = torch.tensor(0, dtype=torch.int32) if stats is None else stats.max_staleness
        seen = state.stale_seen | (stale > 0)
        k = torch.where(seen, 2, 1).to(torch.int32)
        return _ProbeState(k=k, stale_seen=seen), k


class _ThreeArgumentController(_StalenessProbe):
    """A user controller written before ExecStats: ``update`` takes three."""

    def update(self, state, grads, sim_time):
        return state, state.k


def test_exec_stats_reach_the_controller(linreg):
    """kasync at k = 1 applies stale gradients, so the probe moves to k = 2;
    sync never does; a three-argument controller is called without them."""
    _, X, y, eta = linreg
    kw = dict(n_workers=N, straggler=tstr.Exponential(1.0), eta=eta, num_iters=40, eval_every=40,
              keys=np.asarray(jax.random.PRNGKey(2))[None], device="cpu")
    ka = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, controller=_StalenessProbe(), mode="kasync", **kw)
    assert int(ka.k[0, -1]) == 2
    sync = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, controller=_StalenessProbe(), mode="sync", **kw)
    assert int(sync.k[0, -1]) == 1
    old = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, controller=_ThreeArgumentController(), mode="kbatch",
                              **kw)
    assert int(old.k[0, -1]) == 1 and bool(torch.isfinite(old.loss).all())


def test_kbatch_lets_a_fast_worker_fill_the_batch(linreg):
    """One fast worker of eight: kbatch redispatches it at once and lets it
    fill the batch, so its clock runs far ahead of kasync's, which needs K
    distinct workers."""
    _, X, y, eta = linreg
    fleet = tstr.WorkerFleet([tstr.Exponential(rate=50.0)] + [tstr.Exponential(rate=0.02)] * (N - 1))
    kw = dict(n_workers=N, controller=tctl.FixedKController(n_workers=N, k=2), straggler=fleet, eta=eta,
              num_iters=20, key=prng.PRNGKey(9), n_replicas=4, eval_every=10, device="cpu")
    kb = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, mode="kbatch", **kw)
    ka = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, mode="kasync", **kw)
    assert float(kb.time[:, -1].mean()) < 0.1 * float(ka.time[:, -1].mean())


@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_inactive_slots_of_a_fleet_are_never_dispatched(mode, linreg):
    """5 active workers of 8 slots: an inactive (+inf) slot dispatched into
    an arrival set would make every later time +inf."""
    _, X, y, eta = linreg
    fleet = tstr.WorkerFleet([tstr.Exponential(rate=1.0)] * 3 + [tstr.Exponential(rate=0.3)] * 2)
    res = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N,
                              controller=tctl.FixedKController(n_workers=5, k=2), straggler=fleet, eta=eta,
                              num_iters=40, key=prng.PRNGKey(4), n_replicas=3, eval_every=10, mode=mode,
                              device="cpu")
    t, loss = _np(res.time), _np(res.loss)
    assert np.isfinite(t).all() and np.isfinite(loss).all()
    assert (np.diff(t, axis=1) > 0).all()
    assert loss[:, -1].mean() < loss[:, 0].mean()


# the controllers of tests/goldens/gen_quadratic_goldens.py
GOLDEN_CONTROLLERS = {
    "fixed": dict(k=2),
    "pflug": dict(k0=1, step=1, thresh=3, burnin=5),
    "sketched_pflug": dict(k0=1, step=1, thresh=3, burnin=5, sketch_dim=8),
    "schedule": dict(switch_times=[2.0, 6.0], k0=1, step=2),
    "variance_ratio": dict(k0=1, step=2, burnin=10),
}


@pytest.mark.parametrize("name", list(GOLDEN_CONTROLLERS))
@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_async_goldens_in_legacy_mode(mode, name):
    """tests/goldens/quadratic_mc.npz holds the reference's async runs too
    (legacy threefry): k exact, time within 1e-6 and loss within 1e-4, as
    the sync goldens are held (tests/test_torch_engine.py)."""
    from pathlib import Path

    gold = np.load(Path(__file__).parent / "goldens" / "quadratic_mc.npz")
    n, d = int(gold["n_workers"]), int(gold["d"])
    with prng.threefry_mode(False):
        data = torch_linreg(prng.PRNGKey(int(gold["data_seed"])), m=int(gold["m"]), d=d, device="cpu")
        keys = prng.split(prng.PRNGKey(int(gold["key_seed"])), int(gold["n_replicas"]))
        got = tmc.run_monte_carlo(torch_loss, torch.zeros(d), data.X, data.y, n_workers=n,
                                  controller=tctl.get_controller(name, n, **GOLDEN_CONTROLLERS[name]),
                                  straggler=tstr.Exponential(1.0), eta=float(gold["eta"]),
                                  num_iters=int(gold["num_iters"]), keys=keys, eval_every=int(gold["eval_every"]),
                                  mode=mode, device="cpu")
    np.testing.assert_array_equal(_np(got.k), gold[f"{name}__{mode}__k"])
    np.testing.assert_allclose(_np(got.time), gold[f"{name}__{mode}__time"], rtol=1e-6)
    np.testing.assert_allclose(_np(got.loss), gold[f"{name}__{mode}__loss"], rtol=1e-4)


# ---------------------------------------------------------- the mode axis


def _grid(lib, eta):
    """Sync, kasync and kbatch cells: a Pflug cell of each async mode, a
    Pareto kbatch cell with a comm model, a fleet of 6 active workers under
    a rate schedule (the reference test's grid and more)."""
    ctl, st, sw, ag = (jctl, jstr, jsw, jagg) if lib == "jax" else (tctl, tstr, tsw, tagg)
    fleet = st.WorkerFleet([st.Exponential(rate=1.0)] * 4 + [st.Exponential(rate=0.25)] * 2,
                           st.RateSchedule(times=(5.0,), scales=(0.5,)))
    pflug = dict(k0=1, step=1, thresh=3, burnin=5)
    return [
        sw.SweepCase(ctl.PflugController(n_workers=N, k0=2, step=2, thresh=5, burnin=10), st.Exponential(rate=1.0),
                     eta, label="sync_pflug"),
        sw.SweepCase(ctl.FixedKController(n_workers=N, k=2), st.Exponential(rate=1.0), eta, label="kasync_k2",
                     mode="kasync"),
        sw.SweepCase(ctl.PflugController(n_workers=N, **pflug), st.Exponential(rate=1.0), eta,
                     label="kasync_pflug", mode="kasync"),
        sw.SweepCase(ctl.FixedKController(n_workers=N, k=3), st.Pareto(x_m=0.5, alpha=1.5), eta,
                     comm=ag.CommModel(alpha=0.1, beta=0.02), label="kbatch_k3_comm", mode="kbatch"),
        sw.SweepCase(ctl.PflugController(n_workers=N, **pflug), st.Exponential(rate=1.0), eta, label="kbatch_pflug",
                     mode="kbatch"),
        sw.SweepCase(ctl.FixedKController(n_workers=6, k=2), fleet, eta, label="kasync_hetero_n6", mode="kasync"),
    ]


GRID_ITERS, GRID_EVAL = 20, 10


def _grid_runs(linreg):
    """(reference sweep, port sweep, port cases), once per module."""
    data, X, y, eta = linreg

    def run():
        keys = jax.random.split(jax.random.PRNGKey(7), R)
        common = dict(n_workers=N, num_iters=GRID_ITERS, eval_every=GRID_EVAL)
        want = jsw.run_sweep(jax_loss, jnp.zeros((D,)), data.X, data.y, cases=_grid("jax", eta), keys=keys,
                             partition="none", unroll=1, **common)
        tcases = _grid("torch", eta)
        got = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=tcases, keys=np.asarray(keys), device="cpu",
                            **common)
        return want, got, tcases

    return _reference(("grid",), run)


def test_mixed_grid_matches_the_reference_sweep(linreg):
    want, got, tcases = _grid_runs(linreg)
    assert got.labels == want.labels and got.time.shape == (len(tcases), R, GRID_ITERS // GRID_EVAL)
    for g, case in enumerate(tcases):
        adapts = isinstance(case.controller, tctl.PflugController)
        _assert_as_reference(got.cell(g), want.cell(g), case.label, MAX_FORKS if adapts else 0)


def test_mixed_grid_matches_the_looped_engine(linreg):
    _, got, tcases = _grid_runs(linreg)
    _, X, y, _ = linreg
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), R))
    for g, case in enumerate(tcases):
        want = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N, controller=case.controller,
                                   straggler=case.straggler, eta=case.eta, comm=case.comm, num_iters=GRID_ITERS,
                                   eval_every=GRID_EVAL, keys=keys, mode=case.mode, device="cpu")
        _assert_as_looped(got.cell(g), want, case.label)


def test_repopulated_mixed_grid_builds_nothing_new(linreg):
    """Another grid of the same signature and shapes (other modes per cell,
    k, eta and families) loads into the same program; its cells are still
    the looped engine's."""
    _, X, y, eta = linreg
    a = _grid("torch", eta)
    b = [dataclasses.replace(a[0], mode="kbatch", controller=tctl.PflugController(N, k0=2, step=1, thresh=2)),
         dataclasses.replace(a[1], mode="sync", straggler=tstr.Pareto(1.0, 2.5)),
         dataclasses.replace(a[2], eta=eta / 2), dataclasses.replace(a[3], mode="kasync"),
         dataclasses.replace(a[4], controller=tctl.PflugController(N, k0=3, step=1, thresh=3, burnin=5)), a[5]]

    def run(cases):
        return tsw.run_sweep(torch_loss, torch.zeros(D), X, y, n_workers=N, cases=cases, num_iters=10, eval_every=5,
                             key=prng.PRNGKey(3), n_replicas=2, device="cpu")

    tsw.clear_sweep_cache()
    try:
        run(a)
        assert tsw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        got = run(b)
        assert tsw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        keys = prng.split(prng.PRNGKey(3), 2)
        for g in (0, 1, 3):
            c = b[g]
            want = tmc.run_monte_carlo(torch_loss, torch.zeros(D), X, y, n_workers=N, controller=c.controller,
                                       straggler=c.straggler, eta=c.eta, comm=c.comm, num_iters=10, eval_every=5,
                                       keys=keys, mode=c.mode, device="cpu")
            _assert_as_looped(got.cell(g), want, c.label)
    finally:
        tsw.clear_sweep_cache()


def test_moded_grid_step_keeps_the_carry_dtypes(linreg):
    """Through two steps of a mixed-mode grid, every leaf of the ExecCarry
    keeps its dtype and shape (no int64 promotion of k, staleness or the
    counters under `torch.where`), and the empty opt_state stays None."""
    _, X, y, eta = linreg
    cases = _grid("torch", eta)
    sig = tsw.grid_signature(cases, N)
    cells = tsw._stack_cells([tsw._cell_of(c, N, 1, 1, 1, torch.zeros(D)) for c in cases], torch.device("cpu"))
    keys = prng.split(prng.PRNGKey(0), len(cases))
    inputs = tsw._Inputs(torch.zeros(D), (X, y), keys, tsw._lanes_of(cells, sig.modes))
    engine = tsw._GridEngine(PerExampleSource(torch_loss), N, 1, sig)
    carry = engine.initial(inputs)
    step, evaluate = engine.build(inputs)
    after, k = step(step(carry)[0])
    leaves = torch.utils._pytree.tree_leaves
    assert [(x.dtype, tuple(x.shape)) for x in leaves(after) if x is not None] == \
        [(x.dtype, tuple(x.shape)) for x in leaves(carry) if x is not None]
    assert after.opt_state is None and k.dtype == torch.int32
    assert (after.staleness.dtype, after.pending.dtype) == (torch.int32, torch.bool)
    assert evaluate(after.params).shape == (len(cases),)


def test_all_sync_grid_keeps_the_lean_program(linreg):
    """A grid without an async cell builds the lean step over the sync
    carry, under a cache entry of its own; the same cell as kasync builds
    the moded program."""
    _, X, y, eta = linreg
    kw = dict(n_workers=N, num_iters=20, eval_every=10, key=prng.PRNGKey(1), n_replicas=2, device="cpu")
    sync = [tsw.SweepCase(tctl.FixedKController(N, k=2), tstr.Exponential(), eta, label="x")]
    tsw.clear_sweep_cache()
    try:
        tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=sync, **kw)
        tsw.run_sweep(torch_loss, torch.zeros(D), X, y, cases=[dataclasses.replace(sync[0], mode="kasync")], **kw)
        assert tsw.sweep_cache_stats() == {"programs": 2, "traces": 2}
        engines = [p.engine for p in tsw._PROGRAM_CACHE._entries.values()]
        assert [e.moded for e in engines] == [False, True]
        cells = tsw._stack_cells([tsw._cell_of(sync[0], N, 1, 1, 1, torch.zeros(D))], torch.device("cpu"))
        inputs = tsw._Inputs(torch.zeros(D), (X, y), prng.split(prng.PRNGKey(0), 1), tsw._lanes_of(cells))
        assert isinstance(engines[0].initial(inputs), tsw._SweepCarry)
        assert isinstance(engines[1].initial(inputs), tem.ExecCarry)
    finally:
        tsw.clear_sweep_cache()


# ------------------------------------------------------ the slice as a whole


ASYNC_ITERS = 10  # one eval point of `quickstart --setup async`


def test_quickstart_async_setup_matches_the_reference_sweep():
    """fig_async's five arms (a two-speed fleet, n = 20, m = 400, d = 20) as
    one grid, against the reference's `run_sweep(partition="none")` of the
    same cells on the same data, eta and keys."""
    from repro_torch.launch import quickstart

    cfg = quickstart.SETUPS["async"]
    data = jax_linreg(jax.random.PRNGKey(0), m=cfg["m"], d=cfg["d"])
    eta = 0.5 / (2 * float(jnp.linalg.eigvalsh(data.X.T @ data.X / cfg["m"]).max()))
    out = quickstart.run("async", iters=ASYNC_ITERS, replicas=2, device="cpu", eta=eta)
    fleet = jstr.WorkerFleet((jstr.Exponential(rate=1.0),) * cfg["n_fast"]
                             + (jstr.Exponential(rate=1.0 / cfg["slow_factor"]),) * cfg["n_slow"])
    adaptive = dict(cfg["adaptive"])
    cases = [jsw.SweepCase(jctl.PflugController(n_workers=cfg["n"], **adaptive), fleet, eta, label="adaptive"),
             jsw.SweepCase(jctl.FixedKController(n_workers=cfg["n"], k=16), fleet, eta, label="sync_k16"),
             jsw.SweepCase(jctl.FixedKController(n_workers=cfg["n"], k=4), fleet, eta, label="kasync_k4",
                           mode="kasync"),
             jsw.SweepCase(jctl.FixedKController(n_workers=cfg["n"], k=4), fleet, eta, label="kbatch_k4",
                           mode="kbatch"),
             jsw.SweepCase(jctl.PflugController(n_workers=cfg["n"], **adaptive), fleet, eta,
                           label="kasync_adaptive", mode="kasync")]
    want = jsw.run_sweep(jax_loss, jnp.zeros((cfg["d"],)), data.X, data.y, n_workers=cfg["n"], cases=cases,
                         num_iters=ASYNC_ITERS, keys=jax.random.split(jax.random.PRNGKey(1), 2),
                         eval_every=cfg["eval_every"], partition="none", unroll=1)
    assert list(out["results"]) == list(want.labels)
    for g, label in enumerate(want.labels):
        _assert_as_reference(out["results"][label], want.cell(g), label, MAX_FORKS if "adaptive" in label else 0)
    np.testing.assert_allclose(out["f_star"], data.f_star, rtol=1e-2)


def test_quickstart_async_grid_is_its_looped_path(capsys):
    """`--setup async` as one grid against `--looped` (five programs): time
    and k bitwise, the eval loss within 1e-6; and its report's
    time-to-target line."""
    from repro_torch.launch import quickstart

    grid = quickstart.run("async", iters=6, replicas=2, device="cpu")
    looped = quickstart.run("async", iters=6, replicas=2, device="cpu", looped=True)
    assert list(grid["results"]) == ["adaptive", "sync_k16", "kasync_k4", "kbatch_k4", "kasync_adaptive"]
    for label, got in grid["results"].items():
        _assert_as_looped(got, looped["results"][label], label)
    quickstart.report(grid)
    text = capsys.readouterr().out
    assert "simulated time to 1e-3 of the initial excess" in text and "kbatch_k4" in text
    assert set(quickstart.time_to_target(grid)) == set(grid["results"])
