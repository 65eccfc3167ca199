"""Rules of the PyTorch port: it stands apart from the JAX package, and it
runs on the card unless the caller asks for the CPU."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]
                elif isinstance(arg, ast.JoinedStr) and arg.values and isinstance(arg.values[0], ast.Constant):
                    yield arg.values[0].value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"ops.py", "kernel.py", "ref.py", "layers.py", "rwkv.py", "linear_scan.py", "serve.py",
            "chip_smoke.py", "prng.py", "straggler.py", "aggregation.py", "controller.py", "theory.py",
            "gradsource.py", "montecarlo.py", "simulate.py", "async_sim.py", "synthetic.py",
            "quickstart.py", "sweep.py", "execmode.py", "faults.py", "optimizers.py", "steps.py", "train.py",
            "lm_source.py", "io.py", "figures.py", "shardctx.py", "mesh.py", "sharding.py"} <= names


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points rightly run on it")


def _entry_points():
    from repro_torch.checkpoint import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = get_smoke_config("llama3.2-3b")
    rwkv_cfg = get_smoke_config("rwkv6-3b")
    return {
        "build_model": lambda: build_model(cfg),
        "build_model[rwkv6-3b]": lambda: build_model(rwkv_cfg),
        "convert.init[rwkv6-3b]": lambda: convert.init(rwkv_cfg, torch.Generator()),
        "convert.init": lambda: convert.init(cfg, torch.Generator()),
        "convert.params_from_jax": lambda: convert.params_from_jax({}),
        "serve.random_prompts": lambda: serve.random_prompts(cfg, 1, 8, seed=0),
        "serve.main": lambda: serve.main(["--smoke", "--prompt-len", "8", "--new-tokens", "2"]),
        "serve.main[rwkv6-3b]": lambda: serve.main(
            ["--arch", "rwkv6-3b", "--smoke", "--prompt-len", "8", "--new-tokens", "2"]),
        **_engine_entry_points(),
    }


def _engine_entry_points():
    import numpy as np

    from repro_torch.checkpoint import convert
    from repro_torch.core import async_sim, controller, faults, montecarlo, prng, simulate, straggler, sweep
    from repro_torch.data import make_linreg_data
    from repro_torch.launch import quickstart

    loss = quickstart.squared_error
    X, y, w0 = torch.ones(12, 4), torch.ones(12), torch.zeros(4)
    ctrl, strag = controller.FixedKController(n_workers=3, k=2), straggler.Exponential(1.0)
    return {
        "montecarlo.run_monte_carlo": lambda: montecarlo.run_monte_carlo(
            loss, w0, X, y, n_workers=3, controller=ctrl, straggler=strag, eta=0.01, num_iters=4,
            key=prng.PRNGKey(0), n_replicas=2),
        "simulate.simulate_fastest_k": lambda: simulate.simulate_fastest_k(
            loss, w0, X, y, n_workers=3, controller=ctrl, straggler=strag, eta=0.01, num_iters=4,
            key=prng.PRNGKey(0)),
        "async_sim.simulate_async_sgd": lambda: async_sim.simulate_async_sgd(
            lambda w, i: w, lambda w: w.sum(), w0, n_workers=3, eta=0.01, straggler=strag, total_time=1.0,
            key=prng.PRNGKey(0)),
        "sweep.run_sweep": lambda: sweep.run_sweep(
            loss, w0, X, y, n_workers=3, cases=[sweep.SweepCase(ctrl, strag, eta=0.01)], num_iters=4,
            key=prng.PRNGKey(0), n_replicas=2),
        "montecarlo.run_monte_carlo[kbatch]": lambda: montecarlo.run_monte_carlo(
            loss, w0, X, y, n_workers=3, controller=ctrl, straggler=strag, eta=0.01, num_iters=4,
            key=prng.PRNGKey(0), n_replicas=2, mode="kbatch"),
        "sweep.run_sweep[kasync]": lambda: sweep.run_sweep(
            loss, w0, X, y, n_workers=3, cases=[sweep.SweepCase(ctrl, strag, eta=0.01, mode="kasync")],
            num_iters=4, key=prng.PRNGKey(0), n_replicas=2),
        "quickstart.main[--setup async]": lambda: quickstart.main(["--setup", "async", "--iters", "2",
                                                                   "--replicas", "2"]),
        "montecarlo.run_monte_carlo[fault]": lambda: montecarlo.run_monte_carlo(
            loss, w0, X, y, n_workers=3, controller=ctrl, straggler=strag, eta=0.01, num_iters=4,
            key=prng.PRNGKey(0), n_replicas=2, fault=faults.byzantine_plan(3, 0.34, "crash"), agg="median"),
        "sweep.run_sweep[geomedian]": lambda: sweep.run_sweep(
            loss, w0, X, y, n_workers=3, cases=[sweep.SweepCase(ctrl, strag, eta=0.01, agg="geomedian",
                                                                fault=faults.byzantine_plan(3, 0.34, "sign_flip"))],
            num_iters=4, key=prng.PRNGKey(0), n_replicas=2),
        "quickstart.main[--setup byzantine]": lambda: quickstart.main(["--setup", "byzantine", "--iters", "2",
                                                                       "--replicas", "2"]),
        "make_linreg_data": lambda: make_linreg_data(prng.PRNGKey(0), m=12, d=4),
        "quickstart.main": lambda: quickstart.main(["--iters", "2", "--replicas", "2"]),
        "quickstart.main[--looped]": lambda: quickstart.main(["--iters", "2", "--replicas", "2", "--looped"]),
        **_training_entry_points(),
        "convert.engine_inputs": lambda: convert.engine_inputs(
            np.zeros((2, 2), np.uint32), np.zeros(4, np.float32), np.ones((12, 4), np.float32),
            np.ones(12, np.float32)),
    }


def _training_entry_points():
    from repro_torch.core import prng
    from repro_torch.data import TokenStream
    from repro_torch.launch import quickstart, train
    from repro_torch.launch.lm_source import LMSource

    return {
        "train.main": lambda: train.main(["--smoke", "--steps", "1", "--batch", "4", "--seq", "8"]),
        "train.main[--mode kbatch]": lambda: train.main(["--smoke", "--steps", "1", "--batch", "4", "--seq", "8",
                                                         "--mode", "kbatch"]),
        "TokenStream.batch_at": lambda: TokenStream(512, 8, 4).batch_at(0),
        "LMSource.init_params": lambda: LMSource().init_params(prng.PRNGKey(0)),
        "LMSource.make_data": lambda: LMSource().make_data(4, 8),
        "quickstart.main[--setup lm]": lambda: quickstart.main(["--setup", "lm", "--iters", "2", "--replicas", "2"]),
        **_experiment_entry_points(),
    }


def _experiment_entry_points():
    from repro_torch.launch import figures, train

    return {
        "train.main[--simulate]": lambda: train.main(["--simulate", "--steps", "2", "--replicas", "2"]),
        "train.main[--distributed]": lambda: train.main(["--smoke", "--steps", "1", "--batch", "4", "--seq", "8",
                                                         "--distributed"]),
        "train.main[--distributed --simulate]": lambda: train.main(["--simulate", "--steps", "2", "--replicas", "2",
                                                                    "--distributed"]),
        "figures.main[--only fig1]": lambda: figures.main(["--smoke", "--only", "fig1", "--out-dir", "unused"]),
        "figures.run_fig_hetero": lambda: figures.run_fig_hetero(iters=2, n_replicas=2),
        "figures.run_fig3": lambda: figures.run_fig3(iters=2, n_replicas=2, async_seeds=1),
    }


@pytest.mark.parametrize(
    "name",
    ["build_model", "convert.init", "convert.params_from_jax", "serve.random_prompts", "serve.main",
     "build_model[rwkv6-3b]", "convert.init[rwkv6-3b]", "serve.main[rwkv6-3b]",
     "montecarlo.run_monte_carlo", "simulate.simulate_fastest_k", "async_sim.simulate_async_sgd",
     "sweep.run_sweep", "make_linreg_data", "quickstart.main", "quickstart.main[--looped]",
     "convert.engine_inputs", "montecarlo.run_monte_carlo[kbatch]", "sweep.run_sweep[kasync]",
     "quickstart.main[--setup async]", "montecarlo.run_monte_carlo[fault]", "sweep.run_sweep[geomedian]",
     "quickstart.main[--setup byzantine]", "train.main", "train.main[--mode kbatch]", "TokenStream.batch_at",
     "LMSource.init_params", "LMSource.make_data", "quickstart.main[--setup lm]", "train.main[--simulate]",
     "figures.main[--only fig1]", "figures.run_fig_hetero", "figures.run_fig3", "train.main[--distributed]",
     "train.main[--distributed --simulate]"],
)
def test_entry_point_without_device_raises_on_a_host_without_cuda(name):
    _no_card()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _entry_points()[name]()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """In the checkout without a card, and beside nothing of the repo, the
    script exits non-zero and never prints its ok line."""
    _no_card()
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
