"""What the readers of the program's own spans share. The program keeps
its spans and counters in memory (diffmvs_tpu_torch/utils/profiling.py);
a reader reads them after the window, in the run's process.

Units are chosen as issue_ms.request chooses its calls: the last
`run.units` units of the entry's kind (DepthRunner.__call__'s
"runner.call", train_step's "step"). Readers of a span's host time take
the median over those that ran with the profiler off; readers of a
counter the mean over them, which counts its bursts (the collector's
rare long runs); device readers those that ran under the profiler. A
program without the registry, or without the span, reads None.
"""

from __future__ import annotations

import statistics
from typing import Callable, List, Optional

UNIT = {"batch": "runner.call", "request": "runner.call", "train": "step"}


def window(run) -> List:
    """The window's units of the run's kind, oldest first; [] without
    the registry."""
    from diffmvs_tpu_torch.utils import profiling

    units = getattr(profiling, "units", None)
    if units is None or run.units <= 0:
        return []
    return units(UNIT[run.kind])[-run.units:]


def host_values(run, value: Callable) -> Optional[List[float]]:
    """value(unit) over the window's units that ran with the profiler
    off; None if there are none, or if one reads None."""
    vals = [value(u) for u in window(run) if not u.profiled]
    return None if not vals or None in vals else vals


def host_median(run, value: Callable) -> Optional[float]:
    vals = host_values(run, value)
    return None if vals is None else statistics.median(vals)


def host_mean(run, value: Callable) -> Optional[float]:
    vals = host_values(run, value)
    return None if vals is None else statistics.fmean(vals)


def device_ms_per_map(run, names) -> Optional[float]:
    """Device ms a map of the spans named, summed over the window's units
    that ran under the profiler. A unit may lack some of the names (a
    stage DiffMVS does not have), not all; None if a span present has no
    device time, or there is no such unit."""
    traced = [u for u in window(run) if u.profiled]
    total = 0.0
    for u in traced:
        present = [n for n in names if u.named(n)]
        if not present:
            return None
        for n in present:
            ms = u.device_ms(n)
            if ms is None:
                return None
            total += ms
    return total / (len(traced) * run.batch) if traced else None
