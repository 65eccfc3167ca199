"""The whole train step's share of the card's bf16 peak, in percent: model
FLOPs a step (`flops.train_flops_per_token`, the experts at their active
share) over the host-clock time of the window's steps, which ran without the profiler,
over 989 TFLOP/s."""

from gpubench import flops


def read(record):
    rate = record.counters.get("untraced_flops_per_s")
    return None if not rate else 100.0 * rate / flops.PEAK_BF16_FLOPS
