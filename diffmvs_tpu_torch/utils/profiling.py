"""Profiling and tracing hooks (counterpart of
diffmvs_tpu/utils/profiling.py).

    with trace("stage1"):
        ...
    capture("/tmp/trace", fn, *args)   # one profiler capture of fn
    with wallclock("request") as h:
        h["result"] = fn(...)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(name: str):
    """A named range: a torch.profiler record_function span, and on a
    machine with CUDA an NVTX range around it."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def capture(logdir: str, fn: Callable, *args, **kwargs):
    """Run fn under torch.profiler (CPU, and CUDA where there is a card),
    waiting for the card before the capture closes, and write its chrome
    trace to logdir/trace.json. Returns fn's result."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return out


def _cuda_devices(obj):
    """The CUDA devices of the tensors in obj (nested lists, tuples and
    dicts)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in obj))
    return set()


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    """Wall-clock timer; the caller puts its result in holder["result"],
    and the exit waits for the CUDA devices that result lies on before it
    reads the clock. Sets holder["elapsed"] (s)."""
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        for dev in _cuda_devices(holder.get("result")):
            torch.cuda.synchronize(dev)
        holder["elapsed"] = time.perf_counter() - t0
        sink(f"{label}: {holder['elapsed'] * 1000:.2f} ms")
