"""Device ms a depth map in the program's "model.features" span
(FeatureNet over every view, ContextNet over the reference view), over
the window's forwards that ran under the profiler."""

from mvsbench.spans import device_ms_per_map


def read(run):
    return device_ms_per_map(run, ["model.features"])
