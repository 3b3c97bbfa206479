"""Device ms a depth map in the program's diffusion refinement spans,
"model.stage2" and "model.stage3" (DiffMVS has only the first), each
with its upsampling, over the window's forwards that ran under the
profiler."""

from mvsbench.spans import device_ms_per_map


def read(run):
    return device_ms_per_map(run, ["model.stage2", "model.stage3"])
