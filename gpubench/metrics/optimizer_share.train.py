"""The optimizer's share of the device time of the traced steps, in
percent: the device time of the operations launched inside the harness's
span around `Optimizer.apply`, over the device time of all operations."""


def read(record):
    tr = record.trace
    if tr is None:
        return None
    opt = tr.span_device_s("opt_apply")
    total = sum(e - s for _, s, e, _, _ in tr.device_ops) * 1e-9
    if not opt or total <= 0:
        return None
    return 100.0 * opt / total
