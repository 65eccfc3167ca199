"""The kernel cache (`core/cache.py`, `kernels/_build.py`) on the CPU.

The CPU tests run without nvcc, so a stand-in `nvcc` script on PATH answers
``--version`` and writes a file wherever ``-o`` points.  Fresh processes
build every CUDA source of a copy of the kernels' tree into one
REPRO_COMPILATION_CACHE_DIR: the first adds one entry a source, a warm
second adds 0 and compiles nothing, an edited source adds exactly its one
library, and another toolkit (another ``nvcc --version``) misses every
entry.  `--cache-dir` and the environment variable enable the cache for the
train CLI; the API is the reference's.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NVCC = """#!/usr/bin/env python3
import os, sys
if "--version" in sys.argv:
    print("Cuda compilation tools, release " + os.environ.get("STANDIN_CUDA", "12.8"))
    sys.exit(0)
with open(sys.argv[sys.argv.index("-o") + 1], "w") as f:
    f.write("built from " + sys.argv[-1])
"""
PROBE = """
import json, sys
from pathlib import Path
from repro_torch.core import cache
from repro_torch.kernels import _build
_build.KERNELS_DIR = Path(sys.argv[1])
where = cache.maybe_enable_from_env()
print(json.dumps({"dir": where, "built": sorted(_build.build_all())}))
"""


@pytest.fixture()
def toolkit(tmp_path):
    """(run, kernels tree, cache dir): ``run(**env)`` builds the tree's
    sources in a fresh process with the stand-in nvcc and the cache dir."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "nvcc").write_text(NVCC)
    (bindir / "nvcc").chmod(0o755)
    tree = tmp_path / "kernels"
    for src in _build.sources():
        dst = tree / src.relative_to(_build.KERNELS_DIR)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    where = tmp_path / "cache"

    def run(**extra):
        env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}", PYTHONPATH=str(ROOT / "src"),
                   **{cache.ENV_VAR: str(where)}, **extra)
        before = cache.cache_entries(str(where))
        proc = subprocess.run([sys.executable, "-c", PROBE, str(tree)], env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout)
        assert out["dir"] == str(where)
        return out["built"], cache.cache_entries(str(where)) - before

    return run, tree, where


def test_a_warm_cache_compiles_nothing_and_an_edit_compiles_one(toolkit):
    run, tree, where = toolkit
    names = sorted(s.stem for s in _build.sources())
    assert len(names) == 4
    assert run() == (names, 4)  # cold: every source compiled once
    assert run() == ([], 0)  # warm, in a fresh process: nothing
    src = sorted(tree.glob("*/csrc/*.cu"))[0]
    src.write_text(src.read_text() + "\n// edited\n")
    assert run() == ([src.stem], 1)  # the edited source alone
    assert run(STANDIN_CUDA="12.9") == (names, 4)  # another toolkit misses every entry
    assert sorted(p.name for p in where.iterdir()) == sorted(p.name for p in where.glob("*.so"))


def test_the_cache_api_follows_the_reference(tmp_path, monkeypatch):
    assert cache.ENV_VAR == "REPRO_COMPILATION_CACHE_DIR"
    assert cache.persistent_cache_dir() is None and _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.maybe_enable_from_env() is None
    monkeypatch.setenv(cache.ENV_VAR, "")
    assert cache.maybe_enable_from_env() is None
    where = tmp_path / "a" / "b"
    try:
        assert cache.enable_persistent_cache(str(where)) == str(where) and where.is_dir()
        assert cache.enable_persistent_cache(str(where)) == str(where)  # idempotent
        assert _build.BUILD_DIR == where and cache.persistent_cache_dir() == str(where)
        assert cache.cache_entries() == 0
        (where / "x.so").write_text("")
        assert cache.cache_entries() == cache.cache_entries(str(where)) == 1
        monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "env"))
        assert cache.maybe_enable_from_env() == str(tmp_path / "env")
    finally:
        cache.disable_persistent_cache()
    assert cache.persistent_cache_dir() is None and cache.cache_entries() == 0
    assert cache.cache_entries(str(tmp_path / "missing")) == 0


def test_the_train_cli_enables_the_cache_from_the_environment(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "env"))
    try:
        ttrain.main(["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32", "--steps", "1"])
        assert cache.persistent_cache_dir() == str(tmp_path / "env")
        # --cache-dir wins over the environment, as in the reference's CLI
        ttrain.main(["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32", "--steps", "1",
                     "--cache-dir", str(tmp_path / "flag")])
        assert cache.persistent_cache_dir() == str(tmp_path / "flag")
    finally:
        cache.disable_persistent_cache()
    assert len([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]) == 2
