"""Readings of the host around a run's window, which the result line
carries under "host" (no metric reads them): how fast the host was, and
what took its time, so that a run of a host-bound cell that reads slow
can be told apart from a slower program.

  probe(dev)   before and after the window, ~0.3 s outside both set-up
               and the window: host memory copy (GB/s), a pageable copy
               to the card of the same bytes (the request's upload path,
               GB/s), the host's time per small kernel launch (us), and
               a plain Python loop (ms).
  Usage        over the window: the process's CPU seconds against the
               host clock's, involuntary context switches, the machine's
               steal time (seconds the hypervisor gave its CPUs to
               others, /proc/stat), and the garbage collector's
               collections and seconds.
"""

from __future__ import annotations

import gc
import os
import resource
import statistics
import time

import numpy as np
import torch

clock = time.perf_counter
COPY_BYTES = 64 << 20


def _median_s(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = clock()
        fn()
        out.append(clock() - t0)
    return statistics.median(out)


def probe(dev) -> dict:
    a = np.ones(COPY_BYTES // 4, np.float32)
    b = np.empty_like(a)
    got = {"copy_gbps": COPY_BYTES / 1e9 / _median_s(
        lambda: np.copyto(b, a), 5)}

    def loop():
        x = 0
        for i in range(200_000):
            x += i

    got["py_ms"] = 1e3 * _median_s(loop, 3)
    if dev.type == "cuda":
        src = torch.from_numpy(a)

        def upload():
            src.to(dev)
            torch.cuda.synchronize(dev)

        upload()
        got["h2d_gbps"] = COPY_BYTES / 1e9 / _median_s(upload, 5)
        x = torch.zeros(16, device=dev)
        torch.cuda.synchronize(dev)
        n = 2000
        t0 = clock()
        for _ in range(n):
            x.add_(1.0)
        got["launch_us"] = 1e6 * (clock() - t0) / n
        torch.cuda.synchronize(dev)
    return got


def _steal_s():
    """The machine's steal time so far, all CPUs, in seconds; None where
    /proc/stat does not give it."""
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        return int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


class Usage:
    def __init__(self):
        self.gc_n, self.gc_s, self._t = 0, 0.0, None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = clock()
        elif self._t is not None:
            self.gc_n += 1
            self.gc_s += clock() - self._t

    def start(self):
        self.t0, self.ru0, self.steal0 = (
            clock(), resource.getrusage(resource.RUSAGE_SELF), _steal_s())
        gc.callbacks.append(self._on_gc)
        return self

    def stop(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        wall = clock() - self.t0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        steal = _steal_s()
        return {
            "wall_s": wall,
            "cpu_s": (ru.ru_utime + ru.ru_stime
                      - self.ru0.ru_utime - self.ru0.ru_stime),
            "invol_switches": ru.ru_nivcsw - self.ru0.ru_nivcsw,
            "steal_s": (None if steal is None or self.steal0 is None
                        else steal - self.steal0),
            "gc_collections": self.gc_n, "gc_s": self.gc_s,
            "torch_threads": torch.get_num_threads(),
            "cpus": len(os.sched_getaffinity(0)),
        }
