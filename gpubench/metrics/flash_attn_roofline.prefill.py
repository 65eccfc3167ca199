"""The flash-attention kernel's share of its roofline in the traced
prefills, in percent: the least time the card could take for the calls
(`flops.flash_attention_work` and `flops.bound_seconds` from the requests'
shapes, every layer) over the device time of the kernels named flash_attn."""

KERNEL = "flash_attn"


def read(record):
    tr, bound = record.trace, record.counters.get("flash_bound_s_traced")
    if tr is None or not bound:
        return None
    t = tr.device_s(KERNEL)
    if t <= 0:
        return None
    return 100.0 * bound / t
