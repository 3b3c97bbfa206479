"""Host ms a training step that Python's collector ran inside the
program's "step" unit (its counter gc.ns over the step's spans), the
mean over the window's steps that ran with the profiler off: the
collector's cost comes in bursts, which a median would leave out."""

from mvsbench.spans import host_mean


def read(run):
    return host_mean(run, lambda u: u.count("gc.ns") / 1e6)
