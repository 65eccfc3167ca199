"""The device's idle share of the traced calls, in percent: one minus the
time in which any operation ran on the device (the union of their
intervals) over the traced span, from the synchronised start of the first
traced call to the completion of the last.  Both come from the profiler's
trace; it is `busy_s` and `window_s` of the result's `device`.  Read for
every cell under its own name (`device_idle_share.sim`, `.train`,
`.prefill`): the profiler's records of every kernel of a replayed CUDA
graph slow the replay, so the sim cells read more idle traced than they
are untraced."""


def read(record):
    tr = record.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
