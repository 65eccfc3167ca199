"""The runner on the CPU: it finds cells, traffic and metric readers by name
in a copy of the benchmark with files added and none edited; a run with
its timed path broken comes out not correct; the measurement path refuses
to run without a card; no module of JAX or the JAX package is loaded."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import bench

from conftest import ROOT

FAULTS = [("sim-smoke", "unchanged"), ("sim-smoke", "half_batch"), ("sim-smoke", "answer"), ("sim-smoke", "draw"),
          ("train-smoke", "unchanged"), ("train-smoke", "half_batch"), ("train-smoke", "draw"),
          ("train-smoke-switch", "k_stuck"),
          ("prefill-smoke", "half_batch"), ("prefill-smoke", "answer"), ("prefill-smoke", "slot")]
# the number that has to catch each fault where the others cannot
CAUGHT_BY = {"k_stuck": "window_steps_departed", "slot": "rows_beyond_reach"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["sim-smoke", "train-smoke", "train-smoke-switch", "prefill-smoke"])
def test_added_cell_runs_correct_in_both_modes(smoke_root, cell):
    line = bench.run_cell(cell, 2**31 + 11, 0.2, False, root=smoke_root, device="cpu")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) >= {"setup_s"} and len(line["metrics"]) >= 2
    assert list(line)[-1] == "checks"
    traced = bench.run_cell(cell, 2**31 + 12, 0.2, True, root=smoke_root, device="cpu")
    assert traced["correct"] and traced["device"]["window_s"] > 0


def test_added_metric_reader_is_found(smoke_root):
    (smoke_root / "gpubench" / "metrics" / "chunks_done.py").write_text(
        "def read(record):\n    return record.counters.get('chunks')\n")
    spec = json.loads((smoke_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "chunks_done", "unit": "count", "better": "higher", "source": "program_counter",
                              "layer": "Engine: Sweep and Engine", "moves": "sim_lane_iters_per_s",
                              "workloads": ["sim-smoke"]})
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = bench.run_cell("sim-smoke", 3, 0.2, True, root=smoke_root, device="cpu")
    assert line["metrics"]["chunks_done"]["value"] >= 1
    assert "engine_captures" in line["metrics"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(smoke_root, cell, fault):
    line = bench.run_cell(cell, 2**31 + 21, 0.2, False, root=smoke_root, device="cpu", fault=fault)
    assert not line["correct"], line["checks"]
    if fault in CAUGHT_BY:
        c = line["checks"][CAUGHT_BY[fault]]
        assert c["value"] > c["limit"], line["checks"]


def test_measurement_path_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(bench.BenchError, match="no CUDA device"):
        bench.run_cell("sim-fig2-grid", 1, 1.0, False)
    sys.path.insert(0, str(ROOT / "gpubench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "gpubench"))
    assert run.main(["--workload", "sim-fig2-grid", "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_print_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "sim-fig2-grid", "--seed", "1",
                           "--seconds", "1"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    import repro_torch.launch.serve  # noqa: F401

    from gpubench.drivers import prefill, sim, train  # noqa: F401

    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys.modules["repro_torch"])
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys.modules["repro_torch"])
    assert bench.forbidden_modules() == ["repro.core"]


def test_import_guard_runs_after_the_readers(smoke_root, tmp_path, monkeypatch, capsys):
    """A per-layer reader that loads a module named jax leaves no result."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    (smoke_root / "gpubench" / "metrics" / "jax_loaded.py").write_text(
        "def read(record):\n    import jax  # noqa: F401\n    return 1.0\n")
    spec = json.loads((smoke_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "jax_loaded", "unit": "count", "better": "lower", "source": "program_counter",
                              "layer": "Device", "moves": "sim_lane_iters_per_s", "workloads": ["sim-smoke"]})
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(spec))
    sys.path.insert(0, str(ROOT / "gpubench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "gpubench"))
    real = bench.run_cell
    monkeypatch.setattr(bench, "run_cell", lambda *a, **kw: real(*a, **{**kw, "root": smoke_root, "device": "cpu"}))
    try:
        rc = run.main(["--workload", "sim-smoke", "--seed", "9", "--seconds", "0.2", "--trace", "1"])
    finally:
        sys.modules.pop("jax", None)
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == ""
    assert "jax" in captured.err
