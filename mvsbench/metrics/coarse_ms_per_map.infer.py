"""Device ms a depth map in the program's "model.stage1" span (the 1/8
plane sweep with K1, CostRegNet and the soft-argmax, and its upsampling),
over the window's forwards that ran under the profiler."""

from mvsbench.spans import device_ms_per_map


def read(run):
    return device_ms_per_map(run, ["model.stage1"])
