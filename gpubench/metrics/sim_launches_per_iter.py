"""Kernels the device ran an iteration of the engine (the whole grid or
program, all lanes), counted in the profiler's trace of the traced calls."""


def read(record):
    iters = record.counters.get("iterations_traced")
    if record.trace is None or not iters:
        return None
    n = len(record.trace.kernels())
    return n / iters if n else None
