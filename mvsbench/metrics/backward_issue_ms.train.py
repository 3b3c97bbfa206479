"""Host ms a training step in the program's "step.backward" span
(autograd's backward with remat's recomputation), the median over the
window's steps that ran with the profiler off."""

from mvsbench.spans import host_median


def read(run):
    return host_median(run, lambda u: u.host_ms("step.backward"))
