"""The port's tracing: spans and counters, kept in memory, always on.

    from diffmvs_tpu_torch.utils import profiling

    with profiling.span("runner.call"):            # no span open: a unit
        with profiling.span("runner.upload"):
            profiling.count("upload.pageable_bytes", x.nbytes)
        with profiling.span("model.features", device=imgs.device):
            ...
    profiling.units("runner.call")[-1].host_ms("runner.upload")

A span records its name, its start and end (ns on the host's monotonic
clock, time.perf_counter_ns), its parent and its unit: the top-level span
it was opened under, one request or one training step. Each thread keeps
its own stack of open spans, and a thread with none open starts a unit
of its own, with one exception: a span opened with lend=True
("step.backward") lends itself to autograd's engine. A thread with no
span open that runs a backward pass (autograd's device thread, while the
main thread waits in "step.backward") opens its spans and counts under
the lending span, if exactly one is open; with none or several (two
threads in a backward pass at once) its spans are a unit of their own
and its counts go to the process's totals only. The registry keeps the
span trees of the last RING units and, by span name, running totals:
count, host ns and self ns (the duration less its children's).

count(name, n) adds n to a counter: to the process's total, optionally
under a key (a shape), and to the innermost open span. One gc.callbacks
hook counts the collector's runs, "gc.collections" and "gc.ns", credited
to the span open when a run started.

Only while a torch.profiler is active, a span also opens a record
function "diffmvs.<name>" (record_range), so that it lands on the
profiler's timeline beside the kernels (under emit_nvtx, an NVTX range),
and a span given a device records its device time: a CUDA event pair on
the device's current stream, or on the CPU its host time. The profiler
stamps its events on the Unix clock (its own fast clock converted); one
offset, the Unix clock less the monotonic one, read when a span first
opens under a profiler, puts the spans kept in memory on that timeline
(on_timeline).
"""

from __future__ import annotations

import collections
import gc
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

RING = 1024             # units whose span trees are kept
PREFIX = "diffmvs."     # the spans' record_function names

clock = time.perf_counter_ns
profiler_active = torch._C._autograd._profiler_enabled
# the id of the backward pass the calling thread runs (-1: none)
graph_task = torch._C._current_graph_task_id
# a record_function of the function scope: a CPU range on the profiler's
# timeline that, unlike torch.profiler.record_function (a user
# annotation), the profiler does not also project onto the card's
# timeline over the kernels launched inside it, where a trace's reader
# would count it as device work
record_range = torch._C._profiler._RecordFunctionFast


class Span:
    """A span: a context manager, then the record it leaves."""

    __slots__ = ("registry", "name", "device", "lend", "unit", "parent",
                 "start", "end", "child_ns", "counts", "events", "rf")

    def __init__(self, registry: "Registry", name: str, device=None,
                 lend: bool = False):
        self.registry, self.name, self.device = registry, name, device
        self.lend = lend
        self.unit = self.parent = self.rf = None
        self.start = self.end = None
        self.child_ns = 0
        self.counts: Optional[Dict[str, int]] = None
        # None: no device time; (): the host time is the device time (the
        # CPU); else the span's CUDA events
        self.events = None

    def __enter__(self) -> "Span":
        return self.registry.open(self)

    def __exit__(self, *exc) -> bool:
        self.registry.close(self)
        return False

    @property
    def ns(self) -> int:
        return self.end - self.start

    @property
    def seconds(self) -> float:
        return self.ns / 1e9

    def device_ms(self) -> Optional[float]:
        """Device ms of a span given a device that ran under the profiler
        (its events, once the device has passed them); None otherwise."""
        if self.events is None or self.end is None:
            return None
        if not self.events:
            return self.ns / 1e6
        first, last = self.events
        last.synchronize()
        return first.elapsed_time(last)

    def count(self, name: str) -> int:
        return (self.counts or {}).get(name, 0)


class Unit:
    """The spans of one top-level call, the unit's own span first.
    profiled: whether it opened under the profiler."""

    __slots__ = ("id", "spans", "profiled")

    def __init__(self, uid: int, profiled: bool):
        self.id, self.profiled = uid, profiled
        self.spans: List[Span] = []

    @property
    def name(self) -> str:
        return self.spans[0].name

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def host_ms(self, name: str) -> Optional[float]:
        """Host ms of the unit's spans of that name; None without one."""
        spans = self.named(name)
        return sum(s.ns for s in spans) / 1e6 if spans else None

    def device_ms(self, name: str) -> Optional[float]:
        """Device ms of the unit's spans of that name; None without one,
        or if one has no device time."""
        ms = [s.device_ms() for s in self.named(name)]
        return sum(ms) if ms and None not in ms else None

    def count(self, name: str) -> int:
        """A counter summed over the unit's spans."""
        return sum(s.count(name) for s in self.spans)


class Registry:
    """Spans and counters. clock and profiling (whether a profiler is
    active) are the registry's inputs, so that a test can give its own."""

    def __init__(self, ring: int = RING, clock: Callable[[], int] = clock,
                 profiling: Callable[[], bool] = profiler_active):
        self.clock, self.profiling = clock, profiling
        self.lock = threading.RLock()
        self.ring = collections.deque(maxlen=ring)
        self.totals: Dict[str, List[int]] = {}
        self.counters: collections.Counter = collections.Counter()
        self.keyed: Dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        self.lent: tuple = ()       # the open spans opened with lend
        self.offset_ns: Optional[int] = None
        self.was_profiling = False
        self.next_id = 0
        self.gc_start = None
        self.local = threading.local()

    def stack(self) -> List[Span]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def innermost(self) -> Optional[Span]:
        """The calling thread's innermost open span; for a thread with
        none, the span lent to it (the module's note), or None."""
        st = self.stack()
        if st:
            return st[-1]
        lent = self.lent
        if len(lent) == 1 and graph_task() >= 0:
            return lent[0]
        return None

    def open(self, sp: Span) -> Span:
        st = self.stack()
        parent = self.innermost()
        prof = self.profiling()
        if prof and not self.was_profiling:
            self.offset_ns = time.time_ns() - self.clock()
        self.was_profiling = prof
        with self.lock:
            if parent is None:
                unit = Unit(self.next_id, prof)
                self.next_id += 1
            else:
                unit = parent.unit
            unit.spans.append(sp)
            sp.parent, sp.unit = parent, unit
            st.append(sp)
            if sp.lend:
                self.lent += (sp,)
        if prof:
            sp.rf = record_range(PREFIX + sp.name)
            sp.rf.__enter__()
        sp.start = self.clock()
        if prof and sp.device is not None:
            sp.events = ()
            if sp.device.type == "cuda":
                first = torch.cuda.Event(enable_timing=True)
                first.record(torch.cuda.current_stream(sp.device))
                sp.events = (first,)
        return sp

    def close(self, sp: Span):
        if sp.events:
            last = torch.cuda.Event(enable_timing=True)
            last.record(torch.cuda.current_stream(sp.device))
            sp.events = (sp.events[0], last)
        sp.end = self.clock()
        if sp.rf is not None:
            sp.rf.__exit__(None, None, None)
            sp.rf = None
        ns = sp.end - sp.start
        st = self.stack()
        with self.lock:
            if st and st[-1] is sp:
                st.pop()
            elif sp in st:
                st.remove(sp)
            if sp.lend:
                self.lent = tuple(x for x in self.lent if x is not sp)
            t = self.totals.get(sp.name)
            if t is None:
                t = self.totals[sp.name] = [0, 0, 0]
            t[0] += 1
            t[1] += ns
            t[2] += ns - sp.child_ns
            if sp.parent is None:
                if len(self.ring) == self.ring.maxlen:
                    # the unit and its spans refer to each other: unlink
                    # the unit that leaves, for its memory to be freed
                    # without the collector
                    self.ring[0].spans = None
                self.ring.append(sp.unit)
            else:
                sp.parent.child_ns += ns

    def count(self, name: str, n: int = 1, key=None):
        """Add n to counter `name` (and under `key`), crediting the
        innermost open span."""
        self.add(name, n, key, self.innermost())

    def add(self, name: str, n: int, key, sp: Optional[Span]):
        with self.lock:
            self.counters[name] += n
            if key is not None:
                self.keyed[name][key] += n
            if sp is not None:
                if sp.counts is None:
                    sp.counts = {}
                sp.counts[name] = sp.counts.get(name, 0) + n

    def on_gc(self, phase: str, info):
        if phase == "start":
            self.gc_start = (self.clock(), self.innermost())
        elif self.gc_start is not None:
            t0, sp = self.gc_start
            self.gc_start = None
            self.add("gc.collections", 1, None, sp)
            self.add("gc.ns", self.clock() - t0, None, sp)

    def reset_counters(self, prefix: str = ""):
        """Zero the process's counters whose names start with prefix (the
        spans keep theirs)."""
        with self.lock:
            for table in (self.counters, self.keyed):
                for name in [k for k in table if k.startswith(prefix)]:
                    del table[name]


REGISTRY = Registry()


def span(name: str, device=None, lend: bool = False) -> Span:
    """A span of the process's registry (see the module's note). device:
    the torch.device whose time the span takes under the profiler; lend:
    autograd's engine works under it while it is open."""
    return Span(REGISTRY, name, device, lend)


def count(name: str, n: int = 1, key=None):
    REGISTRY.count(name, n, key)


def counter(name: str) -> int:
    """The process's total of a counter."""
    return REGISTRY.counters.get(name, 0)


def keyed(name: str) -> collections.Counter:
    """A copy of a counter's totals by key."""
    return collections.Counter(REGISTRY.keyed.get(name, {}))


def reset_counters(prefix: str = ""):
    REGISTRY.reset_counters(prefix)


def units(name: Optional[str] = None) -> List[Unit]:
    """The units kept, oldest first; with name, those whose own span has
    that name."""
    with REGISTRY.lock:
        kept = list(REGISTRY.ring)
    return [u for u in kept if name is None or u.name == name]


def totals() -> Dict[str, Dict[str, float]]:
    """By span name since the process started: count, host_ms, self_ms."""
    with REGISTRY.lock:
        return {k: {"count": c, "host_ms": h / 1e6, "self_ms": s / 1e6}
                for k, (c, h, s) in REGISTRY.totals.items()}


def on_timeline(prof) -> Callable[[int], float]:
    """Maps a span's stamp (start or end) to the timeline of a stopped
    torch.profiler.profile: µs from its trace's start, as its events'
    time_range has them."""
    if REGISTRY.offset_ns is None:
        raise RuntimeError("profiling: no span has opened under a profiler")
    start = prof.profiler.kineto_results.trace_start_ns()
    offset = REGISTRY.offset_ns - start
    return lambda ns: (ns + offset) / 1e3


def _on_gc(phase, info):
    REGISTRY.on_gc(phase, info)


gc.callbacks.append(_on_gc)
