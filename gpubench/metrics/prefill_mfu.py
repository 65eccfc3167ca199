"""The whole prefill's share of the card's bf16 peak, in percent: model
FLOPs of the window's requests, which ran without the profiler (`flops.prefill_flops`,
the experts at their active share, causal attention) over their host-clock
time, over 989 TFLOP/s."""

from gpubench import flops


def read(record):
    rate = record.counters.get("untraced_flops_per_s")
    return None if not rate else 100.0 * rate / flops.PEAK_BF16_FLOPS
