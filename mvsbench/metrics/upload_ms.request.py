"""Host ms a request in the program's "runner.upload" span (the view-set
copied from host memory to the card), the median over the window's
requests that ran with the profiler off."""

from mvsbench.spans import host_median


def read(run):
    return host_median(run, lambda u: u.host_ms("runner.upload"))
