"""Flash-attention launches a request over the window: the change of the
kernel wrapper's counter (`kernels/attention/ops.launches`) over the
requests served."""


def read(record):
    n = record.counters.get("requests")
    if not n:
        return None
    return record.counters["flash_launches"] / n
