"""The benchmark's runner: one cell, one run, one result line.

Everything a cell needs is found by name: the workload in
`BENCHMARK.json`, its configuration's file (``configs/<config>.json``),
its traffic mix (``traffic/<traffic>.json``, whose ``driver`` names the
module under ``drivers/`` that runs it), its limits
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``).  A cell or a metric is added by adding files
and entries; no file here changes.

A run: set-up (build, weights or data, warm-up of every shape the traffic
uses), then the measured window of ``--seconds``, then the check of what
the window produced against the plain reference under ``reference/``.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of the
calls made after the window and from the program's counters.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
# Top-level module names the benchmark's process may never hold: the JAX
# package beside the port, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot be measured: no result is printed."""


def use_checkout_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds: PyTorch's extensions, Triton's
    kernels and the port's nvcc libraries (`repro_torch.core.cache`)."""
    import os

    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    from repro_torch.core import cache

    cache.enable_persistent_cache(str(CACHE / "kernels"))


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError(f"missing {path}") from None


@dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes, and a
    value that is not finite fails."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Plan:
    """What one cell runs, read from its files."""

    workload: dict
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # {compared number: limit}
    end_to_end: list  # the cell's end-to-end metric entries of BENCHMARK.json
    per_layer: list  # the cell's per-layer metric entries
    root: Path = ROOT

    @property
    def name(self) -> str:
        return self.workload["name"]


def plan_for(workload: str, root: Path = ROOT) -> Plan:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    here = root / "gpubench"
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Plan(workload=cell, config=load_json(root / cfg_entry["file"]),
                traffic=load_json(here / "traffic" / f"{cell['traffic']}.json"),
                limits=load_json(here / "limits" / f"{workload}.json"), end_to_end=e2e, per_layer=per_layer,
                root=root)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(record)`` of ``metrics/<name>.py``, or, where there is no such
    file, of ``metrics/<name before its first dot>.py``: one reader serves
    the split quantities ``device_idle_share.sim``, ``.train`` and so on."""
    metrics = root / "gpubench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.is_file():
        path = metrics / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise BenchError(f"no reader {metrics / name}.py for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Record:
    """What a traced run hands the per-layer readers."""

    trace: object = None  # tracing.Trace of the calls after the window
    counters: dict = field(default_factory=dict)


def window(ctx, call: Callable, trace_calls: int):
    """The measured window: ``call()`` again and again until ``ctx.seconds``
    have passed, ending with the call that crosses them; then, in a traced
    run, ``trace_calls`` more calls under the profiler, so that neither its
    overhead nor the reading of its trace falls inside the window.  Returns
    (every call's result, the window's calls' host-clock seconds, the
    window's length)."""
    results, walls = [], []
    t0 = ctx.window_opens()
    while True:
        t = time.perf_counter()
        results.append(call())
        walls.append(time.perf_counter() - t)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    if ctx.tracer is not None:
        ctx.tracer.start()
        for _ in range(trace_calls):
            results.append(call())
        ctx.tracer.stop()
    return results, walls, elapsed


@dataclass
class Outcome:
    """What a driver returns: the end-to-end values it measured, the window's
    counts, the compared numbers and the record for the readers."""

    metrics: dict
    attempted: int
    failed: int
    checks: list
    record: Record
    memory_peak_bytes: int
    info: dict = field(default_factory=dict)  # readings shown beside the checks, not compared


@dataclass
class Context:
    """A driver's view of the run.  ``fault`` and ``control`` are set only by
    the calibration and the tests: a fault breaks the timed path underneath,
    a control puts the reference at a lower precision in the program's
    place."""

    plan: Plan
    seed: int
    seconds: float
    device: object
    t_start: float
    fault: Optional[str] = None
    control: Optional[str] = None
    detail: bool = False  # drivers add their per-answer readings to the line's info
    tracer: object = None
    setup_s: float = 0.0

    @property
    def config(self) -> dict:
        return self.plan.config

    @property
    def traffic(self) -> dict:
        return self.plan.traffic

    def limit(self, name: str) -> float:
        if name not in self.plan.limits:
            raise BenchError(f"limits/{self.plan.name}.json gives no limit for {name!r}")
        return float(self.plan.limits[name])

    def window_opens(self) -> float:
        """Set-up ends here; returns the window's start on the host clock."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        return now

    def span(self, name: str):
        """A named span in the trace (nothing when the run is not traced)."""
        if self.tracer is None or not self.tracer.active:
            return contextlib.nullcontext()
        return self.tracer.span(name)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             t_start: Optional[float] = None, device: Optional[str] = None, fault: Optional[str] = None,
             control: Optional[str] = None, detail: bool = False) -> dict:
    """Run one cell and return its result line (a dict).  ``device`` other
    than the card, ``fault`` and ``control`` are for the tests and the
    calibration only; the command line never sets them."""
    import torch

    from gpubench import tracing

    t_start = time.perf_counter() if t_start is None else t_start
    plan = plan_for(workload, root)
    chips = int(plan.workload["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
        device = "cuda"
    dev = torch.device(device)
    ctx = Context(plan=plan, seed=int(seed), seconds=float(seconds), device=dev, t_start=t_start, fault=fault,
                  control=control, detail=detail)
    if trace:
        ctx.tracer = tracing.Tracer(dev)
    driver = importlib.import_module(f"gpubench.drivers.{plan.traffic['driver']}")
    out: Outcome = driver.run(ctx)

    line = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted, "failed": out.failed}
    if dev.type == "cuda":
        device_line = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    else:
        device_line = {"platform": dev.type, "kind": dev.type, "count": 1}
    device_line["memory_peak_bytes"] = out.memory_peak_bytes
    if trace:
        tr = out.record.trace
        line["metrics"] = {}
        for m in plan.per_layer:
            value = metric_reader(m["name"], root)(out.record)
            if value is not None:
                line["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        line["device"] = {**device_line, "busy_s": tr.busy_s, "window_s": tr.window_s}
        line["breakdown"] = tr.breakdown()
    else:
        values = {**out.metrics, "setup_s": ctx.setup_s}
        line["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in plan.end_to_end}
        line["device"] = device_line
    if out.info:
        line["info"] = out.info
    # a value that is not finite is written as text: JSON has no number for it
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value), "limit": c.limit}
                      for c in out.checks}
    # after every reader has run: whatever the run loaded, up to its last line
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules of JAX or the JAX package were loaded: {found}")
    return line


def emit(line: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
