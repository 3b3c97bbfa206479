"""The whole forward's share of the card's bf16 dense peak (%): the
configuration's FLOPs per map times the maps per second of the traced
run's window outside its profiled units, over 989 TFLOP/s."""

from mvsbench.roofline.counts import H100_BF16_FLOPS, flops_per_map


def read(run):
    if not run.untraced():
        return None
    rate = run.untraced_rate()
    return 100.0 * flops_per_map(run.config, run.hw) * rate / H100_BF16_FLOPS
