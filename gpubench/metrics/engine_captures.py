"""Graph captures and program builds the engine made inside the window:
the change of `run_sweep`'s or `run_monte_carlo`'s build counter (every
call of the window should be served from the program cache)."""


def read(record):
    return record.counters.get("captures")
