"""The traced calls: torch.profiler over the calls a traced run makes after
its window, reduced to what the per-layer readers need.

The harness marks its own spans (``gpubench.<name>``, by
`torch.profiler.record_function`) around the calls it makes into the
program; the trace gives every operation that ran on the device.  From
them: the window's length, the time the device was busy (the union of its
operations' intervals), kernel counts and device time by name, the device
time of the kernels a span launched, and the longest idle gaps labelled by
what the host was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "gpubench.window"


def _device_kind(name: str) -> str:
    """A device operation's kind from its name: copies and fills are named
    by CUPTI ("Memcpy HtoD ...", "Memset ..."), everything else is a kernel."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


@dataclass
class Trace:
    """Device operations (name, start_ns, end_ns, activity, launch_ns),
    harness spans (name, start_ns, end_ns) and host operations (name,
    start_ns, end_ns), all on the profiler's clock, inside the window."""

    window: tuple
    device_ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list:
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e, _, _ in self.device_ops if e > lo and s < hi)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernels(self, pattern: str = "") -> list:
        return [op for op in self.device_ops if op[3] == "kernel" and pattern in op[0]]

    def device_s(self, pattern: str = "") -> float:
        """Summed device time of the kernels whose name holds ``pattern``."""
        return sum(e - s for _, s, e, _, _ in self.kernels(pattern)) * 1e-9

    def span_device_s(self, span: str):
        """Device time of the operations launched inside the harness span
        ``gpubench.<span>``; None where no operation can be tied to its launch."""
        ivs = sorted((s, e) for n, s, e in self.spans if n == f"gpubench.{span}")
        if not ivs or not any(op[4] is not None for op in self.device_ops):
            return None
        starts = [s for s, _ in ivs]
        total = 0
        for _, s, e, _, launch in self.device_ops:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= ivs[i][1]:
                total += e - s
        return total * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing."""
        by_name = defaultdict(int)
        for n, s, e, _, _ in self.device_ops:
            by_name[n[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        merged = self.busy_intervals()
        gaps = []
        edges = [self.window[0]] + [x for iv in merged for x in iv] + [self.window[1]]
        for i in range(0, len(edges) - 1, 2):
            if edges[i + 1] > edges[i]:
                gaps.append((edges[i + 1] - edges[i], edges[i]))
        gaps.sort(reverse=True)
        labelled = defaultdict(int)
        for length, start in gaps[:top]:
            labelled[self._host_doing(start)] += length
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": [[n, t * 1e-9] for n, t in sorted(labelled.items(), key=lambda kv: -kv[1])]}

    def _host_doing(self, t: int) -> str:
        """The innermost harness span and the outermost host operation open
        at ``t``."""
        span = min((e - s, n) for n, s, e in self.spans if s <= t <= e) if any(
            s <= t <= e for _, s, e in self.spans) else (0, "outside spans")
        ops = [(s, n) for n, s, e in self.host_ops if s <= t <= e]
        op = min(ops)[1] if ops else "idle host"
        return f"{span[1]} / {op}"[:160]


class Tracer:
    """Starts and stops torch.profiler around the traced calls."""

    def __init__(self, device):
        self.device = device
        self.active = False
        self.trace = None
        self._prof = self._window = None

    def span(self, name: str):
        import torch

        return torch.profiler.record_function(f"gpubench.{name}")

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.active = True

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self.trace = reduce(self._prof.profiler.kineto_results.events())
        self._prof = None


def reduce(events) -> Trace:
    """A `Trace` from the profiler's raw events.  A device operation is tied
    to the host operation that launched it by its linked correlation id
    (that operation's own id; 0 where there is none)."""
    from torch.autograd import DeviceType

    window, spans, host, dev, launched = None, [], [], [], {}
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() != DeviceType.CPU:
            if name.startswith("gpubench."):  # the device-side copy of a harness span
                continue
            dev.append((name, s, e, _device_kind(name), ev.linked_correlation_id()))
            continue
        launched[ev.correlation_id()] = s
        if name == WINDOW:
            window = (s, e)
        elif name.startswith("gpubench."):
            spans.append((name, s, e))
        elif not name.startswith("cu"):
            host.append((name, s, e))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    ops = [(name, s, e, kind, launched.get(linked) if linked > 0 else None) for name, s, e, kind, linked in dev]
    return Trace(window=window, device_ops=ops, spans=spans, host_ops=host)
