"""K2's share of its roofline (%): the least card time of the warp
backwards the profiled training steps need (mvsbench/roofline/counts.py)
over K2's device time in the trace."""

from mvsbench.roofline.counts import k2_bound_ms
from mvsbench.trace import K2


def read(run):
    t = run.trace
    if t is None or t.group(K2) <= 0:
        return None
    bound = k2_bound_ms(run.config["model"], run.batch, run.hw, run.views)
    return 100.0 * bound * t.units / t.group(K2)
