"""The traced part of a --trace 1 run: torch.profiler over a few steady
units of the window, reduced to device busy time, idle gaps, device time
by kernel group and by kernel, and the harness's own host spans.

GROUPS is a copy of the port's tools/profile_main.py table as it stood
when the benchmark was written (first match wins), so the grouping does
not move when the program does.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

GROUPS = (
    ("warp_corr_bwd", "warp_corr backward (K2, hand-written)"),
    # K1 and K3 are instances of warp_geom::corr_kernel
    ("sweepsamples", "warp_corr (K1, hand-written)"),
    ("cornersamples", "warp_corr_pre (K3, hand-written)"),
    ("warp_corr", "warp_corr (K1, hand-written)"),
    ("multi_tensor", "optimizer"),
    ("bn_bw", "normalization"),
    ("memcpy", "host-to-device copy"),
    ("bn_fw", "normalization"), ("moments", "normalization"),
    ("tonchw", "layout transform"), ("tonhwc", "layout transform"),
    ("conv", "convolution"), ("implicit", "convolution"),
    ("xmma", "convolution"), ("cudnn", "convolution"),
    ("gemm", "matmul"), ("norm", "normalization"),
    ("fft", "convolution"), ("region_transform", "convolution"),
    ("reduce", "reduction"), ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("index", "gather/index"), ("gather", "gather/index"),
    ("cat", "copy/cat"), ("copy", "copy/cat"),
)
K1 = "warp_corr (K1, hand-written)"
K2 = "warp_corr backward (K2, hand-written)"
CONV = "convolution"
SPAN = "mvsbench."


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


class Spans:
    """The harness's host spans around its calls into the program: host
    seconds by name, and under the profiler a record_function each, so
    that the trace's idle gaps can be labelled with them."""

    def __init__(self):
        self.seconds = collections.defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(SPAN + name) if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """What the profiler saw over the traced units."""

    def __init__(self, prof, units: int):
        self.window_s = 0.0
        self.units = units
        kernels, spans = [], []
        for ev in prof.events():
            tr = ev.time_range
            on_card = ev.device_type == torch.autograd.DeviceType.CUDA
            if ev.name.startswith(SPAN):
                # a span also shows on the card's timeline as an
                # annotation: not work
                if not on_card:
                    spans.append((ev.name[len(SPAN):], tr.start, tr.end))
            elif on_card:
                kernels.append((ev.name, tr.start, tr.end))
        # the window: the harness's "traced" span (its units, then a
        # synchronize) on the profiler's own clock
        for name, w0, w1 in spans:
            if name == "traced":
                self.window_s = (w1 - w0) / 1e6
                kernels = [(n, max(s, w0), min(e, w1))
                           for n, s, e in kernels if e > w0 and s < w1]
                break
        self.kernel_us = collections.Counter()
        for name, s, e in kernels:
            self.kernel_us[name] += e - s
        busy = _union([(s, e) for _, s, e in kernels])
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self.group_ms = collections.Counter()
        for name, us in self.kernel_us.items():
            self.group_ms[group_of(name)] += us / 1e3
        # idle gaps between consecutive busy intervals, each labelled with
        # the innermost harness span the host was in when it opened
        after = {}
        for name, s, e in kernels:
            if e not in after or s < after[e][1]:
                after[e] = (name, s)
        self.gaps = []
        for (s0, e0), (s1, _) in zip(busy, busy[1:]):
            inside = [sp for sp in spans if sp[1] <= e0 <= sp[2]]
            label = (min(inside, key=lambda sp: sp[2] - sp[1])[0]
                     if inside else "outside the harness's spans")
            prev = after.get(e0, ("?", 0))[0]
            self.gaps.append(((s1 - e0) / 1e6, label, prev))

    def group(self, name: str) -> float:
        """Device ms of a kernel group over the traced units."""
        return self.group_ms.get(name, 0.0)

    def breakdown(self) -> Dict[str, List[Tuple[str, float]]]:
        ops = [[f"[{group_of(n)}] {n[:160]}", us / 1e6]
               for n, us in self.kernel_us.most_common(10)]
        gaps = [[f"host in {label}; after {prev[:120]}", s]
                for s, label, prev in sorted(self.gaps, reverse=True)[:10]]
        return {"device_ops": ops, "idle_gaps": gaps}

    def groups(self) -> Dict[str, float]:
        return {k: v for k, v in self.group_ms.most_common()}


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which nothing ran on the card."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
