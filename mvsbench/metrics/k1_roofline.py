"""K1's share of its roofline (%): the least card time of the warp
forwards the profiled forwards need (mvsbench/roofline/counts.py, from
the configuration's shapes) over K1's device time in the trace."""

from mvsbench.roofline.counts import k1_bound_ms
from mvsbench.trace import K1


def read(run):
    t = run.trace
    if t is None or t.group(K1) <= 0:
        return None
    bound = k1_bound_ms(run.config["model"], run.batch, run.hw, run.views)
    return 100.0 * bound * t.units / t.group(K1)
