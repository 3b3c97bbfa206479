"""Share of the traced window in which no operation ran on the card (%),
from the profiler's timeline."""

from mvsbench.trace import idle_pct


def read(run):
    return idle_pct(run)
