"""The port's sweep engine (repro_torch.core.sweep) on the CPU: every cell of
a grid against the reference's `run_sweep(partition="none")`, and against
the port's looped `run_monte_carlo` with the same keys.

Tolerances:
- against the reference, those of tests/test_torch_engine.py: k equal,
  `time` within 1e-5 and loss within 1e-4 relative (torch's log1p and
  matmul sums differ from XLA's in the last ulps);
- against the port's looped engine: `time` and k bitwise (the sweep runs
  the looped step's arithmetic, op for op, over G·R lanes instead of R,
  and every carry stays bitwise), the eval loss within 1e-6 relative.  The
  eval reduces per-example losses that vmap lays out lane-minor, and the
  CPU's reduction over that layout rounds differently for another lane
  count: measured up to 3 ulp (2.1e-7 relative) on these grids, 0 on
  others (PERF.md §6).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import straggler as jstr  # noqa: E402
from repro.core import sweep as jsw  # noqa: E402
from repro.data import make_linreg_data as jax_linreg  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import montecarlo as tmc  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.core import sweep as tsw  # noqa: E402
from repro_torch.core.gradsource import PerExampleSource  # noqa: E402
from repro_torch.launch.mesh import HostMesh  # noqa: E402

TIME_RTOL, LOSS_RTOL = 1e-5, 1e-4
LOOPED_LOSS_RTOL = 1e-6
N, M, D, R = 10, 200, 10, 3
ITERS, EVAL_EVERY = 70, 20


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trajectories(got, want, tag=""):
    np.testing.assert_array_equal(_np(got.k), np.asarray(want.k), err_msg=f"k {tag}")
    np.testing.assert_allclose(_np(got.time), np.asarray(want.time), rtol=TIME_RTOL, err_msg=f"time {tag}")
    np.testing.assert_allclose(_np(got.loss), np.asarray(want.loss), rtol=LOSS_RTOL, err_msg=f"loss {tag}")
    np.testing.assert_array_equal(got.iteration, want.iteration)


def _assert_bitwise(got, want, tag=""):
    for f in ("time", "loss", "k"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f"{f} {tag}"


def _assert_as_looped(got, want, tag=""):
    assert torch.equal(got.time, want.time) and torch.equal(got.k, want.k), tag
    np.testing.assert_allclose(_np(got.loss), _np(want.loss), rtol=LOOPED_LOSS_RTOL, err_msg=f"loss {tag}")


# ------------------------------------------------------- grids, both packages


def _straggler(spec, lib):
    mod = jstr if lib == "jax" else tstr
    if spec[0] == "fleet":
        _, models, sched = spec
        return mod.WorkerFleet([getattr(mod, name)(**kw) for name, kw in models],
                               mod.RateSchedule(**sched) if sched is not None else None)
    name, kw = spec
    return getattr(mod, name)(**kw)


def _case(spec, lib, eta):
    ctl, agg, sw, fm = (jctl, jagg, jsw, jfaults) if lib == "jax" else (tctl, tagg, tsw, tfaults)
    name, kw, n_active = spec["ctrl"]
    comm = agg.CommModel(*spec["comm"]) if spec.get("comm") is not None else None
    fault = fm.byzantine_plan(n_active, *spec["fault"][:2], **spec["fault"][2]) if "fault" in spec else None
    return sw.SweepCase(ctl.get_controller(name, n_active, **kw), _straggler(spec["strag"], lib),
                        eta=eta * spec.get("eta", 1.0), comm=comm, label=spec["label"],
                        mode=spec.get("mode", "sync"), fault=fault, agg=spec.get("agg", "mean"))


EXP = ("Exponential", dict(rate=1.0))
PFLUG = dict(k0=1, step=2, thresh=2, burnin=3)
FLEET = ("fleet", [("Exponential", dict(rate=1.0)), ("Pareto", dict(x_m=1.0, alpha=3.0)),
                   ("Bimodal", dict(fast_mean=1.0, slow_mean=4.0, p_slow=0.25)),
                   ("ShiftedExponential", dict(shift=0.3, rate=2.0)), ("Deterministic", dict(value=1.2)),
                   ("Exponential", dict(rate=0.5)), ("Exponential", dict(rate=2.0)), ("Pareto", dict(x_m=0.5, alpha=2.0))],
         dict(times=(2.0, 5.0), scales=(0.5, 2.0), mode="linear", leaf=0))

GRIDS = {
    # every controller kind, one family each
    "five_kinds": [
        dict(ctrl=("pflug", PFLUG, N), strag=EXP, label="pflug"),
        dict(ctrl=("fixed", dict(k=3), N), strag=("Pareto", dict(x_m=1.0, alpha=2.5)), label="fixed"),
        dict(ctrl=("variance_ratio", dict(k0=1, step=2, burnin=8, decay=0.8, ratio_thresh=0.3), N),
             strag=("Bimodal", dict(fast_mean=1.0, slow_mean=4.0, p_slow=0.2)), label="vr"),
        dict(ctrl=("schedule", dict(switch_times=[2.0, 6.0, 9.0], k0=1, step=3), N),
             strag=("ShiftedExponential", dict(shift=0.5, rate=2.0)), label="schedule", eta=0.8),
        dict(ctrl=("sketched_pflug", dict(PFLUG, sketch_dim=4), N), strag=("Exponential", dict(rate=0.5)),
             label="sketched"),
    ],
    # mixed families, n as a grid axis: cells of 6 and 7 active workers of 10 slots
    "mixed_families_n_active": [
        dict(ctrl=("pflug", PFLUG, N), strag=("Deterministic", dict(value=1.5)), label="pflug/det"),
        dict(ctrl=("fixed", dict(k=2), 6), strag=("Pareto", dict(x_m=1.0, alpha=2.0)), label="fixed/pareto/n6"),
        dict(ctrl=("pflug", dict(PFLUG, k_max=5), 7), strag=("Bimodal", dict(fast_mean=1.0, slow_mean=5.0,
                                                                           p_slow=0.3)), label="pflug/bimodal/n7"),
        dict(ctrl=("fixed", dict(k=5), N), strag=EXP, label="fixed/exp", eta=0.5),
    ],
    # a fleet under a rate schedule, and cells with a comm model
    "fleet_schedule_comm": [
        dict(ctrl=("pflug", PFLUG, 8), strag=FLEET, label="pflug/fleet"),
        dict(ctrl=("fixed", dict(k=4), N), strag=EXP, comm=(0.1, 0.05), label="fixed/comm"),
        dict(ctrl=("schedule", dict(switch_times=[3.0, 8.0], k0=2, step=2), N), strag=EXP, comm=(0.2, 0.0),
             label="schedule/comm"),
    ],
    # sketched Pflug alone (every select folds), over a dict of parameters
    "sketched": [
        dict(ctrl=("sketched_pflug", dict(PFLUG, sketch_dim=4), N), strag=EXP, label="sketched/a"),
        dict(ctrl=("sketched_pflug", dict(PFLUG, sketch_dim=4, seed=7), N),
             strag=("Pareto", dict(x_m=1.0, alpha=2.5)), label="sketched/b"),
    ],
}


def jax_loss(w, X, y):
    return (X @ w - y) ** 2


def torch_loss(w, X, y):
    return (X @ w - y) ** 2


def jax_dict_loss(p, X, y):
    return (X @ p["w"] + p["b"] - y) ** 2


def torch_dict_loss(p, X, y):
    return (X @ p["w"] + p["b"] - y) ** 2


@pytest.fixture(scope="module")
def linreg():
    data = jax_linreg(jax.random.PRNGKey(0), m=M, d=D)
    eta = 0.9 / (2 * float(np.linalg.eigvalsh(np.asarray(data.X, np.float64).T @ np.asarray(data.X) / M).max()))
    return data, torch.from_numpy(np.array(data.X)), torch.from_numpy(np.array(data.y)), eta


def _problem(grid):
    """(jax loss, torch loss, jax params0, torch params0) of a grid."""
    if grid == "sketched":
        return (jax_dict_loss, torch_dict_loss, {"w": jnp.zeros((D,)), "b": jnp.zeros(())},
                {"w": torch.zeros(D), "b": torch.zeros(())})
    return jax_loss, torch_loss, jnp.zeros((D,)), torch.zeros(D)


_RUNS = {}


def _run(grid, linreg):
    """(reference result, port result, port cases) of a grid, run once per module."""
    if grid not in _RUNS:
        data, X, y, eta = linreg
        jl, tl, jp, tp = _problem(grid)
        keys = jax.random.split(jax.random.PRNGKey(7), R)
        common = dict(n_workers=N, num_iters=ITERS, eval_every=EVAL_EVERY)
        want = jsw.run_sweep(jl, jp, data.X, data.y, cases=[_case(s, "jax", eta) for s in GRIDS[grid]], keys=keys,
                             partition="none", **common)
        tcases = [_case(s, "torch", eta) for s in GRIDS[grid]]
        got = tsw.run_sweep(tl, tp, X, y, cases=tcases, keys=np.asarray(keys), device="cpu", **common)
        _RUNS[grid] = want, got, tcases
    return _RUNS[grid]


def _looped(case, grid, linreg, keys):
    """The port's looped engine on one cell; a cell of fewer active workers
    than slots is the fleet of its model repeated."""
    _, X, y, _ = linreg
    _, tl, _, tp = _problem(grid)
    straggler = case.straggler
    if case.controller.n_workers < N and not isinstance(straggler, tstr.WorkerFleet):
        straggler = tstr.WorkerFleet([straggler] * case.controller.n_workers)
    return tmc.run_monte_carlo(tl, tp, X, y, n_workers=N, controller=case.controller, straggler=straggler,
                               eta=case.eta, comm=case.comm, num_iters=ITERS, eval_every=EVAL_EVERY, keys=keys,
                               device="cpu")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_every_cell_matches_the_reference_sweep(grid, linreg):
    want, got, tcases = _run(grid, linreg)
    g, e = len(GRIDS[grid]), -(-ITERS // EVAL_EVERY)
    assert got.time.shape == (g, R, e) and got.k.dtype == torch.int32 and got.labels == want.labels
    for c in range(g):
        _assert_trajectories(got.cell(c), want.cell(c), f"{grid}/{got.labels[c]}")
    # the grids exercise the controllers: some cell moves off its first k
    k_first = torch.tensor([getattr(c.controller, "k0", getattr(c.controller, "k", 0)) for c in tcases])
    assert bool((got.k[:, :, -1] != k_first[:, None]).any())


@pytest.mark.parametrize("grid", list(GRIDS))
def test_every_cell_matches_the_looped_engine(grid, linreg):
    _, got, tcases = _run(grid, linreg)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), R))
    for c, case in enumerate(tcases):
        _assert_as_looped(got.cell(c), _looped(case, grid, linreg, keys), f"{grid}/{case.label}")


def test_summarize_cells_matches_the_reference(linreg):
    want, got, _ = _run("five_kinds", linreg)
    s_t, s_j = tsw.summarize_cells(got), jsw.summarize_cells(want)
    assert list(s_t) == list(s_j) == [s["label"] for s in GRIDS["five_kinds"]]
    for label in s_t:
        assert s_t[label]["n_replicas"] == s_j[label]["n_replicas"] == R
        np.testing.assert_array_equal(s_t[label]["iteration"], s_j[label]["iteration"])
        for f in ("time_mean", "time_ci95", "k_mean", "k_ci95"):
            np.testing.assert_allclose(s_t[label][f], s_j[label][f], rtol=TIME_RTOL, atol=1e-12, err_msg=label)
        np.testing.assert_allclose(s_t[label]["loss_mean"], s_j[label]["loss_mean"], rtol=LOSS_RTOL)


# ------------------------------------------------------------ program family


@pytest.mark.parametrize("specialize,unroll", [(False, None), (True, 1), (True, 4), (False, 7)])
def test_specialize_and_unroll_never_change_the_results(specialize, unroll, linreg):
    _, got, tcases = _run("five_kinds", linreg)
    _, X, y, _ = linreg
    other = tsw.run_sweep(torch_loss, torch.zeros(D), X, y, n_workers=N, cases=tcases, num_iters=ITERS,
                          eval_every=EVAL_EVERY, keys=np.asarray(jax.random.split(jax.random.PRNGKey(7), R)),
                          specialize=specialize, unroll=unroll, device="cpu")
    for c in range(len(tcases)):
        _assert_bitwise(other.cell(c), got.cell(c), tcases[c].label)


def test_repopulated_grid_reuses_its_program(linreg):
    _, X, y, eta = linreg
    a = [_case(s, "torch", eta) for s in GRIDS["five_kinds"]]
    # same kinds and shapes, other eta, k, thresholds and families
    b = [dataclasses.replace(a[0], controller=tctl.PflugController(N, k0=2, step=1, thresh=1, burnin=2), eta=eta / 2),
         dataclasses.replace(a[1], controller=tctl.FixedKController(N, k=7), straggler=tstr.Exponential(2.0)),
         dataclasses.replace(a[2], straggler=tstr.Pareto(1.0, 1.5)), a[3],
         dataclasses.replace(a[4], controller=tctl.SketchedPflugController(N, k0=3, thresh=1, sketch_dim=4, seed=3))]

    def run(cases, r=R):
        return tsw.run_sweep(torch_loss, torch.zeros(D), X, y, n_workers=N, cases=cases, num_iters=30,
                             eval_every=10, key=prng.PRNGKey(3), n_replicas=r, device="cpu")

    tsw.clear_sweep_cache()
    try:
        run(a)
        assert tsw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        got_b = run(b)
        assert tsw.sweep_cache_stats() == {"programs": 1, "traces": 1}
        run(a[:2])  # another signature: a second program
        assert tsw.sweep_cache_stats() == {"programs": 2, "traces": 2}
        run(a, r=2)  # another grid shape under the first program
        assert tsw.sweep_cache_stats() == {"programs": 2, "traces": 3}
        tsw.clear_sweep_cache()
        fresh_b = run(b)
        for c in range(len(b)):
            _assert_bitwise(got_b.cell(c), fresh_b.cell(c), b[c].label)
    finally:
        tsw.clear_sweep_cache()


def test_carry_keeps_the_reference_dtypes(linreg):
    """k and the counters stay int32 through a step (no int64 promotion
    under torch.where), under the specialized and the full signature."""
    _, X, y, eta = linreg
    cases = [_case(s, "torch", eta) for s in GRIDS["five_kinds"]]
    cells = tsw._stack_cells([tsw._cell_of(c, N, 3, 1, 4, torch.zeros(D)) for c in cases], torch.device("cpu"))
    cells = tsw._CellParams(*(tuple(x.repeat_interleave(2, 0) for x in f) if isinstance(f, tuple)
                              else f.repeat_interleave(2, 0) for f in cells))
    keys = prng.split(prng.PRNGKey(0), 2 * len(cases))
    inputs = tsw._Inputs(torch.zeros(D), (X, y), keys, tsw._lanes_of(cells))
    for sig in (tsw.grid_signature(cases, N), tsw._full_signature(cases)):
        engine = tsw._GridEngine(PerExampleSource(torch_loss), N, 4, sig)
        carry = engine.initial(inputs)
        step, evaluate = engine.build(inputs)
        after, k = step(step(carry)[0])
        want = [(x.dtype, tuple(x.shape)) for x in torch.utils._pytree.tree_leaves(carry)]
        assert [(x.dtype, tuple(x.shape)) for x in torch.utils._pytree.tree_leaves(after)] == want
        assert carry.ctrl_state.k.dtype == k.dtype == torch.int32
        assert evaluate(after.params).shape == (2 * len(cases),)


# ------------------------------------------------------------------ signature


SIGNATURE_GRIDS = {
    "five_kinds": GRIDS["five_kinds"],
    "fixed_only": [dict(ctrl=("fixed", dict(k=k), N), strag=EXP, label=f"k{k}") for k in (1, 4)],
    "fig2": [dict(ctrl=("pflug", PFLUG, N), strag=EXP, label="adaptive"),
             dict(ctrl=("fixed", dict(k=4), N), strag=EXP, label="fixed")],
    "fleet_schedule_comm": GRIDS["fleet_schedule_comm"],
    "fleet_without_knots": [dict(ctrl=("pflug", PFLUG, 8), label="a",
                                 strag=("fleet", FLEET[1], dict(times=(), scales=())))],
    "zero_comm": [dict(ctrl=("fixed", dict(k=2), N), strag=EXP, comm=(0.0, 0.0), label="a")],
    "modes": [dict(ctrl=("fixed", dict(k=2), N), strag=EXP, label="sync"),
              dict(ctrl=("pflug", PFLUG, N), strag=EXP, label="kasync", mode="kasync"),
              dict(ctrl=("fixed", dict(k=2), N), strag=EXP, label="kbatch", mode="kbatch")],
    "robust_agg": [dict(ctrl=("fixed", dict(k=2), N), strag=EXP, label="mean"),
                   dict(ctrl=("fixed", dict(k=2), N), strag=EXP, label="trimmed", agg="trimmed")],
    "faults": [dict(ctrl=("fixed", dict(k=2), N), strag=EXP, label="clean"),
               dict(ctrl=("fixed", dict(k=2), N), strag=EXP, label="flip", fault=(0.3, "sign_flip", {})),
               dict(ctrl=("pflug", PFLUG, 8), strag=EXP, label="crash_gm", agg="geomedian",
                    fault=(0.25, "crash", dict(onset=2.0))),
               dict(ctrl=("fixed", dict(k=2), N), strag=EXP, label="gauss_ka", mode="kasync",
                    fault=(0.2, "random_gauss", dict(param=0.5)))],
}


@pytest.mark.parametrize("grid", list(SIGNATURE_GRIDS))
def test_grid_signature_matches_the_reference(grid):
    jcases = [_case(s, "jax", 0.01) for s in SIGNATURE_GRIDS[grid]]
    tcases = [_case(s, "torch", 0.01) for s in SIGNATURE_GRIDS[grid]]
    for fn in ("grid_signature", "_full_signature"):
        args = (N,) if fn == "grid_signature" else ()
        got, want = getattr(tsw, fn)(tcases, *args), getattr(jsw, fn)(jcases, *args)
        assert tuple(got) == tuple(want), fn
        assert got._fields == want._fields
        # the port captures a grid with kbatch one iteration a graph (montecarlo.default_unroll)
        assert tsw._auto_unroll(got) == (1 if 2 in got.modes else jsw._auto_unroll(want))
        np.testing.assert_array_equal(tsw._static_remap(got.modes, 3), jsw._static_remap(want.modes, 3))
    assert [c.name() for c in tcases] == [c.name() for c in jcases]


def test_product_cases_and_case_defaults_match_the_reference():
    jt = jsw.product_cases({"p": jctl.PflugController(4), "f": jctl.FixedKController(4, k=2)},
                           {"e": jstr.Exponential(), "b": jstr.Bimodal()}, eta=0.1)
    tt = tsw.product_cases({"p": tctl.PflugController(4), "f": tctl.FixedKController(4, k=2)},
                           {"e": tstr.Exponential(), "b": tstr.Bimodal()}, eta=0.1)
    assert [c.label for c in tt] == [c.label for c in jt]
    fields = [(f.name, f.default) for f in dataclasses.fields(tsw.SweepCase)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(jsw.SweepCase)]
    assert tsw.SweepCase(tctl.FixedKController(4), tstr.Pareto(), eta=0.1).name() == "FixedKController/Pareto"


# ----------------------------------------------------------------- validation


class _NotAController:
    n_workers = N


def _small_sweep(X, y, **kw):
    args = dict(n_workers=N, cases=[tsw.SweepCase(tctl.FixedKController(N, k=2), tstr.Exponential(), eta=1e-4)],
                num_iters=10, eval_every=5, key=prng.PRNGKey(0), n_replicas=2, device="cpu")
    args.update(kw)
    return tsw.run_sweep(torch_loss, torch.zeros(D), X, y, **args)


def _cells(**kw):
    return [tsw.SweepCase(tctl.FixedKController(N, k=2), tstr.Exponential(), eta=1e-4, **kw)]


@pytest.mark.parametrize("kw,err,match", [
    (dict(cases=[]), ValueError, "non-empty"),
    (dict(cases=_cells() * 2), ValueError, "duplicate cell labels"),
    (dict(cases=[tsw.SweepCase(tctl.SketchedPflugController(N, sketch_dim=4), tstr.Exponential(), 1e-4, label="a"),
                 tsw.SweepCase(tctl.SketchedPflugController(N, sketch_dim=8), tstr.Exponential(), 1e-4, label="b")]),
     ValueError, "sketch_dim"),
    (dict(cases=[tsw.SweepCase(_NotAController(), tstr.Exponential(), 1e-4)]), ValueError, "not sweepable"),
    (dict(cases=[tsw.SweepCase(tctl.FixedKController(N + 1), tstr.Exponential(), 1e-4)]), ValueError, "exceeds"),
    (dict(cases=[tsw.SweepCase(tctl.FixedKController(4), tstr.WorkerFleet([tstr.Exponential()] * 3), 1e-4)]),
     ValueError, "fleet has 3 models"),
    (dict(cases=_cells(mode="nope")), ValueError, "unknown mode"),
    (dict(cases=_cells(agg="nope")), ValueError, "unknown aggregator"),
    (dict(cases=_cells(agg="median", mode="kbatch")), ValueError, "kbatch"),
    (dict(key=None), ValueError, "keys="),
    (dict(eval_every=0), ValueError, "eval_every"),
    (dict(num_iters=0), ValueError, "num_iters"),
    (dict(n_workers=7), ValueError, "not divisible"),
    (dict(partition="nope"), ValueError, "unknown partition"),
    (dict(cases=_cells(fault=tfaults.FaultPlan([None] * (N + 1)))), ValueError, "11 entries but only 10 active"),
    (dict(cases=_cells(mode="kbatch"), mesh=HostMesh(("data", "model"))), ValueError, "'cells', 'replicas'"),
    (dict(cases=[tsw.SweepCase(tctl.FixedKController(6, k=2), tstr.Exponential(), 1e-4,
                               fault=tfaults.byzantine_plan(8, 0.5, "crash"))]), ValueError, "only 6 active"),
    (dict(cases=_cells(fault=object())), ValueError, "FaultPlan"),
    (dict(mesh=HostMesh(("cells",))), ValueError, "'cells', 'replicas'"),
])
def test_validation_errors_raise_before_any_program_is_built(linreg, kw, err, match):
    _, X, y, _ = linreg
    before = tsw.sweep_cache_stats()
    with pytest.raises(err, match=match):
        _small_sweep(X, y, **kw)
    assert tsw.sweep_cache_stats() == before


@pytest.mark.parametrize("partition", ["auto", "shard_map", "none"])
def test_every_partition_runs_the_same_program_on_one_device(partition, linreg):
    _, X, y, _ = linreg
    want = _small_sweep(X, y, partition="none")
    got = _small_sweep(X, y, partition=partition)
    _assert_bitwise(got.cell(0), want.cell(0), partition)
