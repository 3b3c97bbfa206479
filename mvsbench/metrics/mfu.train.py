"""The whole training step's share of the card's bf16 dense peak (%): 3
times the training forward's FLOPs a sample (the forward and a backward
of twice its work; remat's recomputation is not counted as model FLOPs)
times the samples per second of the traced run's window outside its
profiled steps, over 989 TFLOP/s."""

from mvsbench.roofline.counts import H100_BF16_FLOPS, flops_per_map


def read(run):
    if not run.untraced():
        return None
    rate = run.untraced_rate()
    return 100.0 * 3 * flops_per_map(run.config, run.hw) * rate \
        / H100_BF16_FLOPS
