"""The port's figure functions (repro_torch.launch.figures) on the CPU against
the reference's figure scripts, loaded by path from `benchmarks/` (not on
the path) with their `run_sweep` patched to `partition="none"` (the
default `"auto"` fails under this JAX), at reduced iterations and replicas.
Each port figure runs at the reference's eta (and fig_hetero at its
Theorem-1 times): the packages' eigensolvers and least-squares solvers
differ in the last ulps.

Tolerances:
- fig1 is numpy in both: curves and switch times within 1e-12 relative.
- a grid's cells: those of tests/test_torch_sweep.py, k equal in every
  replica, `time` within 1e-5 and the loss within 1e-4 relative;
- fig_hetero's Theorem-1 times computed by the port (its own lstsq and
  eigvalsh) within 1e-5 relative of the reference's;
- fig3's host loop under a Deterministic straggler (every clock tied, so
  the order of events is fixed): times and update counts exact, the loss
  within 1e-4;
- a CSV: its header, labels and iterations equal, its numbers within
  1e-4 relative (plus the last printed digit of a fixed-point column;
  a 95% CI within 1e-4 of the mean it belongs to, being a difference of
  replicas), since each package subtracts its own f* (they differ by
  ~2.4e-5 at fig2's data);
- fig_lm runs the reference's weights (`LMSource.params_from_jax`): the
  port's own init from key 0 draws other bits.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import straggler as jstr  # noqa: E402
from repro.core.async_sim import simulate_async_sgd as jax_async  # noqa: E402
from repro.data import make_linreg_data as jax_linreg  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import straggler as tstr  # noqa: E402
from repro_torch.data import make_linreg_data  # noqa: E402
from repro_torch.launch import figures  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIME_RTOL, LOSS_RTOL = 1e-5, 1e-4
CSV_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the port's CPU ops here are small, and tier-1 runs
    six test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def reference(monkeypatch):
    """load(name) -> the module ``benchmarks/<name>.py`` with its sweep
    entries run at partition="none"; ``seen`` collects each call's cases
    and result."""
    monkeypatch.syspath_prepend(str(ROOT))  # the scripts import their siblings as benchmarks.*
    seen = []

    def load(name):
        spec = importlib.util.spec_from_file_location(f"reference_{name}", ROOT / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for entry in ("run_sweep", "run_sweep_source"):
            if hasattr(mod, entry):
                monkeypatch.setattr(mod, entry, _recording(getattr(mod, entry), seen))
        return mod

    load.seen = seen
    return load


def _recording(fn, seen):
    def run(*a, **kw):
        res = functools.partial(fn, partition="none")(*a, **kw)
        seen.append((kw["cases"], res))
        return res

    return run


def _eta(m, d, edge):
    data = jax_linreg(jax.random.PRNGKey(0), m=m, d=d)
    return edge / (2 * float(jnp.linalg.eigvalsh(data.X.T @ data.X / m).max()))


def _derived_keys(row):
    return [part.split("=")[0].split(":")[0] for part in row["derived"].split(";")]


def _assert_cells(got: dict, want, tag=""):
    """Port results {label: MonteCarloResult} against a reference SweepResult."""
    assert list(got) == list(want.labels), tag
    for g, label in enumerate(want.labels):
        r = got[label]
        np.testing.assert_array_equal(_np(r.k), np.asarray(want.k[g]), err_msg=f"k {tag} {label}")
        np.testing.assert_allclose(_np(r.time), np.asarray(want.time[g]), rtol=TIME_RTOL, err_msg=f"{tag} {label}")
        np.testing.assert_allclose(_np(r.loss), np.asarray(want.loss[g]), rtol=LOSS_RTOL, err_msg=f"{tag} {label}")


def _assert_csv(got_path, want_path, text_cols, decimals=None):
    """Header and the ``text_cols`` equal; every other column within
    CSV_RTOL, plus its last printed digit where ``decimals`` gives a
    fixed-point column's decimals.  A 95% CI is a difference of replicas,
    so it is held to CSV_RTOL of the mean it follows (the column before)."""
    decimals = decimals or {}
    got = [line.split(",") for line in Path(got_path).read_text().splitlines()]
    want = [line.split(",") for line in Path(want_path).read_text().splitlines()]
    assert got[0] == want[0] and len(got) == len(want) > 1
    cols = list(zip(*got[1:])), list(zip(*want[1:]))
    for j, name in enumerate(want[0]):
        a, b = cols[0][j], cols[1][j]
        if j in text_cols:
            assert a == b, name
            continue
        assert [x == "None" for x in a] == [x == "None" for x in b], name
        fa, fb = (np.array([float(x) for x in c if x != "None"]) for c in (a, b))
        atol = 10.0 ** -decimals[j] if j in decimals else 0.0
        if name.endswith("_ci95"):
            atol += CSV_RTOL * np.abs([float(x) for x in cols[1][j - 1] if x != "None"]).max()
        np.testing.assert_allclose(fa, fb, rtol=CSV_RTOL, atol=atol, err_msg=name)


# ----------------------------------------------------------------- fig1


def test_fig1_matches_reference(reference, tmp_path):
    from repro.core import theory as jtheory
    from repro_torch.core import theory as ttheory

    want = reference("fig1").run(str(tmp_path / "ref.csv"))
    got = figures.run_fig1(str(tmp_path / "port.csv"))
    assert got["name"] == want["name"] and got["derived"] == want["derived"]
    np.testing.assert_allclose(ttheory.switching_times(ttheory.example1_system()),
                               jtheory.switching_times(jtheory.example1_system()), rtol=1e-12)
    a, b = (np.loadtxt(tmp_path / f, delimiter=",", skiprows=1) for f in ("port.csv", "ref.csv"))
    assert (tmp_path / "port.csv").read_text().splitlines()[0] == (tmp_path / "ref.csv").read_text().splitlines()[0]
    np.testing.assert_allclose(a, b, rtol=1e-12)


# ----------------------------------------------------------------- fig_hetero

HETERO_RUN = dict(iters=300, n_replicas=4, eval_every=100)


def test_fig_hetero_matches_reference(reference, tmp_path):
    ref = reference("fig_hetero")
    want = ref.run(str(tmp_path / "ref.csv"), **HETERO_RUN)
    (cases, result), = reference.seen
    t1 = list(cases[3].controller.switch_times)
    data = jax_linreg(jax.random.PRNGKey(0), m=400, d=20)
    eta = 0.5 / float(jnp.linalg.eigvalsh(2 * data.X.T @ data.X / 400)[-1])

    port_data = make_linreg_data(prng.PRNGKey(0), m=400, d=20, device="cpu")
    own = figures.hetero_t1_times(port_data, eta, figures.hetero_fleets()[0])
    assert len(own) == len(t1) == 3 and t1[0] > 0
    np.testing.assert_allclose(own, t1, rtol=1e-5)

    out = figures.hetero_grid(device="cpu", eta=eta, t1_times=t1, **HETERO_RUN)
    assert [c.label for c in figures.hetero_cases(eta, t1)] == [c.name() for c in cases]
    _assert_cells(out["results"], result, "fig_hetero")
    got = figures.run_fig_hetero(str(tmp_path / "port.csv"), device="cpu", eta=eta, t1_times=t1, **HETERO_RUN)
    assert got["name"] == want["name"] and _derived_keys(got) == _derived_keys(want)
    _assert_csv(tmp_path / "port.csv", tmp_path / "ref.csv", text_cols={0, 1}, decimals={2: 2, 3: 3})


# ----------------------------------------------------------------- fig3

FIG3_ITERS, FIG3_REPLICAS = 200, 4


def test_fig3_matches_reference(reference, tmp_path):
    want = reference("fig3").run(str(tmp_path / "ref.csv"), iters=FIG3_ITERS, n_replicas=FIG3_REPLICAS)
    (cases, result), = reference.seen
    eta = _eta(2000, 100, 0.4)
    adaptive = figures.fig3_adaptive(FIG3_ITERS, FIG3_REPLICAS, device="cpu", eta=eta)
    _assert_cells({"adaptive": adaptive["result"].cell(0)}, result, "fig3")
    got = figures.run_fig3(str(tmp_path / "port.csv"), iters=FIG3_ITERS, n_replicas=FIG3_REPLICAS, device="cpu",
                           eta=eta)
    assert got["name"] == want["name"] and _derived_keys(got) == _derived_keys(want)
    # the async arm's update count is a count of events, the same process
    assert got["derived"].split("async_updates=")[1] == want["derived"].split("async_updates=")[1]
    rate = got["async_rate"]
    assert rate["events"] > 0 and rate["events_per_s"] > 0 and rate["device"] == "cpu"
    _assert_csv(tmp_path / "port.csv", tmp_path / "ref.csv", text_cols={0}, decimals={1: 2})


def _reference_async(data, eta, straggler, total_time, key, eval_every):
    s = 2000 // 50

    def grad_fn(params, worker):
        Xi = jax.lax.dynamic_slice_in_dim(data.X, worker * s, s, 0)
        yi = jax.lax.dynamic_slice_in_dim(data.y, worker * s, s, 0)
        return jax.grad(lambda p: jnp.mean((Xi @ p - yi) ** 2))(params)

    return jax_async(grad_fn, lambda p: jnp.mean((data.X @ p - data.y) ** 2), jnp.zeros((100,)), n_workers=50,
                     eta=eta, straggler=straggler, total_time=total_time, key=key, eval_every=eval_every)


def test_fig3_async_arm_matches_reference():
    """Under exp(1) the host loop's trajectory is held by fig3's CSV above
    and by tests/test_torch_engine.py::test_simulate_async_sgd."""
    eta = _eta(2000, 100, 0.4) / 10.0
    data = jax_linreg(jax.random.PRNGKey(0), m=2000, d=100)
    port_data = make_linreg_data(prng.PRNGKey(0), m=2000, d=100, device="cpu")
    want = _reference_async(data, eta, jstr.Deterministic(1.0), 3.5, jax.random.PRNGKey(2), 10)
    got = figures.async_host_loop(port_data, 50, eta, tstr.Deterministic(1.0), 3.5, prng.PRNGKey(2), 10)
    assert got["updates"] == want["updates"] and len(want["updates"]) > 5
    assert got["time"] == want["time"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


# ----------------------------------------------------------------- the quickstart grids


def test_ablation_rows_match_reference(reference, tmp_path):
    want = reference("ablation").run(str(tmp_path / "ref.csv"), iters=500, n_replicas=1)
    got = figures.run_ablation(str(tmp_path / "port.csv"), iters=500, n_replicas=1, device="cpu",
                               eta=_eta(2000, 100, 0.5))
    assert got["name"] == want["name"] and got["derived"] == want["derived"]
    _assert_csv(tmp_path / "port.csv", tmp_path / "ref.csv", text_cols={0, 1}, decimals={5: 2})
    rows = (tmp_path / "port.csv").read_text().splitlines()[1:]
    assert len(rows) == 15 and any(r.split(",")[2] != "None" for r in rows)


# ----------------------------------------------------------------- the command line


def test_main_smoke_prints_the_reference_row_names(tmp_path, capsys):
    rows = figures.main(["--smoke", "--device", "cpu", "--only", "fig1,fig_hetero", "--out-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [r["name"] for r in rows] == \
        ["fig1_theory_bounds", "fig_hetero_two_speed_drift"]
    assert "replicas=8;" in rows[1]["derived"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fig1.csv", "fig_hetero.csv"]


def test_main_refuses_an_unknown_figure(tmp_path):
    with pytest.raises(SystemExit, match="unknown figures"):
        figures.main(["--device", "cpu", "--only", "fig1,fig9", "--out-dir", str(tmp_path)])
