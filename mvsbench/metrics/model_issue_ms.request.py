"""Host ms a request in the program's "runner.forward" span (the model's
Python and kernel launches), the median over the window's requests that
ran with the profiler off."""

from mvsbench.spans import host_median


def read(run):
    return host_median(run, lambda u: u.host_ms("runner.forward"))
