"""Device ms a depth map in kernels grouped as convolution (cuDNN's),
over the profiled forwards."""

from mvsbench.trace import CONV


def read(run):
    t = run.trace
    if t is None or t.units == 0:
        return None
    ms = t.group(CONV)
    return ms / (t.units * run.batch) if ms > 0 else None
