"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` file under `repro_torch/kernels/` is compiled on its own into
a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so <source>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded from the build directory
(`repro_torch/kernels/build/`, listed in .gitignore).  `build_all()` starts
one nvcc per source, all at once, and waits for them together.  Nothing here
runs at import time: this module is imported on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    """Every CUDA source of the port, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _source(name: str) -> Path:
    for src in sources():
        if src.stem == name:
            return src
    raise FileNotFoundError(f"no CUDA source named {name}.cu under {KERNELS_DIR}")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _start(src: Path):
    """Start nvcc for `src` unless its library is built; returns (popen, tmp, out) or None."""
    out = library_path(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(src: Path, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process sees the whole file or none
    return log


def build_all() -> Dict[str, str]:
    """Compile every source not yet built, one nvcc each, all in parallel.

    Returns {name: nvcc output} for the sources that were compiled (the
    `-Xptxas -v` lines give registers, shared memory and spills)."""
    started = {src: _start(src) for src in sources()}
    logs = {}
    try:
        for src, st in started.items():
            if st is not None:
                logs[src.stem] = _finish(src, st)
    finally:
        for st in started.values():
            if st is not None and st[0].poll() is None:
                st[0].kill()
                st[0].wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library built from `<name>.cu`, compiling it first if needed."""
    if name not in _loaded:
        src = _source(name)
        started = _start(src)
        if started is not None:
            _finish(src, started)
        _loaded[name] = ctypes.CDLL(str(library_path(src)))
    return _loaded[name]
