"""The port's `train --simulate` (repro_torch.launch.train) on the CPU against
the reference's CLI, grid by grid: the reference's `train.main` runs with
`run_sweep` patched to `partition="none"` (its default `"auto"` fails under
this JAX), the port's `run_simulation` at the reference's eta (0.5 / L from
XLA's eigvalsh: the two eigensolvers differ in the last ulps).

Every cell is held at k exact in every replica, `time_mean` within 1e-6 and
`loss_mean` within 1e-4 relative (torch's log1p and matmul sums differ from
XLA's in the last ulps; a cell's mean time sums 300 iterations of them).
Labels, the header line's keys and the CSV's header and label and
iteration columns are held equal.  Every check of the CLI raises the
reference's message.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sweep as jsw  # noqa: E402
from repro.data import make_linreg_data as jax_linreg  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

TIME_RTOL, LOSS_RTOL = 1e-6, 1e-4
BASE = ["--simulate", "--steps", "300", "--replicas", "4", "--sim-eval-every", "100", "--sim-m", "200",
        "--sim-d", "10", "--n-workers", "10", "--k-step", "2"]
# Theorem-1 constants that switch k within the 300 iterations
SCHEDULE = ["--schedule-strong-convexity", "100", "--schedule-sigma2", "1000", "--schedule-f0-gap", "1e5"]
ALL_CONTROLLERS = ["--sim-controllers", "pflug,sketched_pflug,fixed,variance_ratio,schedule", "--sketch-dim", "8"]
GRIDS = {
    "controllers_x_stragglers": ALL_CONTROLLERS + SCHEDULE + ["--sim-stragglers", "exponential,pareto"],
    "n_grid": ALL_CONTROLLERS + SCHEDULE + ["--sim-n-grid", "10,20", "--sim-stragglers", "exponential"],
    "modes": ["--sim-mode", "sync,kasync,kbatch", "--sim-stragglers", "exponential", "--steps", "150",
              "--sim-eval-every", "50"],
    "faults_x_aggs": ["--sim-fault", "none,sign_flip:0.1:0,crash:0.1:5", "--sim-agg", "mean,trimmed,median,geomedian",
                      "--sim-stragglers", "exponential", "--steps", "150", "--sim-eval-every", "50"],
    "hetero_drift": ALL_CONTROLLERS + SCHEDULE + ["--sim-hetero", "0.3:4", "--sim-drift", "50:0.4"],
}


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


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _reference_eta(args) -> float:
    data = jax_linreg(jax.random.PRNGKey(args.seed), m=args.sim_m, d=args.sim_d)
    return 0.5 / (2 * float(jnp.linalg.eigvalsh(data.X.T @ data.X / args.sim_m).max()))


@pytest.fixture
def reference(monkeypatch):
    """The reference's CLI with `run_sweep(partition="none")`; returns
    {"cases", "result": its SweepResult} once it has run."""
    seen = {}
    run_sweep = jsw.run_sweep

    def patched(*a, **kw):
        seen["cases"] = kw["cases"]
        seen["result"] = functools.partial(run_sweep, partition="none")(*a, **kw)
        return seen["result"]

    monkeypatch.setattr(jsw, "run_sweep", patched)
    return seen


def _csv(path) -> list:
    return [line.split(",") for line in path.read_text().splitlines()]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_simulate_grid_matches_reference(grid, reference, tmp_path, capsys):
    argv = BASE + GRIDS[grid]
    jtrain.main(argv + ["--sim-csv", str(tmp_path / "ref.csv")])
    ref_out = capsys.readouterr().out
    args = ttrain.parse_args(argv + ["--device", "cpu", "--sim-csv", str(tmp_path / "port.csv")])
    got = ttrain.run_simulation(args, eta=_reference_eta(args))
    port_out = capsys.readouterr().out

    want = reference["result"]
    assert list(got["result"].labels) == list(want.labels) and len(want.labels) > 1
    ref_lines, port_lines = _json_lines(ref_out), _json_lines(port_out)
    assert set(port_lines[0]) == set(ref_lines[0])
    assert {k: v for k, v in port_lines[0].items() if k != "wall_s"} == \
        {k: v for k, v in ref_lines[0].items() if k != "wall_s"}
    assert [c["cell"] for c in port_lines[1:]] == [c["cell"] for c in ref_lines[1:]] == list(want.labels)
    assert [c["k_final"] for c in port_lines[1:]] == [c["k_final"] for c in ref_lines[1:]]

    np.testing.assert_array_equal(_np(got["result"].k), np.asarray(want.k))
    np.testing.assert_array_equal(got["result"].iteration, np.asarray(want.iteration))
    ref_stats = jsw.summarize_cells(want)
    for label, s in got["stats"].items():
        np.testing.assert_allclose(s["time_mean"], ref_stats[label]["time_mean"], rtol=TIME_RTOL, err_msg=label)
        np.testing.assert_allclose(s["loss_mean"], ref_stats[label]["loss_mean"], rtol=LOSS_RTOL, err_msg=label)

    # the Theorem-1 schedules (on a WorkerFleet's order statistics in the
    # hetero grid) are the reference's, and switch k within the run
    want_cases = reference["cases"]
    scheduled = [g for g, c in enumerate(want_cases) if hasattr(c.controller, "switch_times")]
    for g in scheduled:
        np.testing.assert_allclose(got["cases"][g].controller.switch_times, want_cases[g].controller.switch_times,
                                   rtol=1e-12, err_msg=want.labels[g])
    assert not scheduled or _np(got["result"].k)[scheduled, :, -1].max() > 1

    ref_csv, port_csv = _csv(tmp_path / "ref.csv"), _csv(tmp_path / "port.csv")
    assert port_csv[0] == ref_csv[0] and len(port_csv) == len(ref_csv)
    assert [r[:2] for r in port_csv] == [r[:2] for r in ref_csv]
    assert f"wrote {tmp_path / 'port.csv'}" in port_out


# each raises in both CLIs before any sweep runs
INVALID = [
    ["--sim-m", "201"],
    ["--sim-controllers", "pflug,bogus"],
    ["--sim-mode", "sync,warp"],
    ["--sim-mode", ","],
    ["--sim-agg", "mean,avg"],
    ["--sim-agg", ","],
    ["--fixed-k", "11", "--sim-controllers", "fixed"],
    ["--sim-fault", "sign_flip:0.1"],
    ["--sim-fault", "sign_flip:x:0"],
    ["--sim-fault", "sign_flip:1.5:0"],
    ["--sim-fault", "warp:0.2:0"],
    ["--sim-hetero", "0.3"],
    ["--sim-hetero", "1.5:4"],
    ["--sim-drift", "50"],
    ["--sim-mode", "sync,kbatch", "--sim-agg", "mean,median"],
    ["--sim-n-grid", "10,30"],
]


@pytest.mark.parametrize("extra", INVALID, ids=lambda a: " ".join(a))
def test_simulate_validation_raises_the_reference_message(extra, reference):
    argv = BASE + extra
    with pytest.raises(SystemExit) as want:
        jtrain.main(argv)
    with pytest.raises(SystemExit) as got:
        ttrain.main(argv + ["--device", "cpu"])
    assert isinstance(want.value.code, str) and got.value.code == want.value.code
    assert "result" not in reference


@pytest.mark.parametrize("flag", [["--production-mesh"], ["--distributed"], ["--cache-dir", "x"]])
def test_simulate_keeps_the_not_ported_flags_raising(flag, capsys):
    """--cache-dir is not ported and raises.  --distributed without a
    process group or torchrun's environment raises, naming what it lacks.
    --production-mesh plays no part in --simulate, as in the reference's
    CLI: the grid runs on the one-device mesh."""
    argv = BASE + flag + ["--device", "cpu"]
    if flag[0] == "--production-mesh":
        out = ttrain.main(argv)
        assert out["header"]["mesh_shape"] == [1, 1] and out["header"]["processes"] == 1
        return
    match = "not ported" if flag[0] == "--cache-dir" else "torchrun environment lacks"
    with pytest.raises(SystemExit, match=match):
        ttrain.main(argv)
