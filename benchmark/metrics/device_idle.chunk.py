"""Share of the traced chunks' window in which no device operation runs
(the union of the operations' intervals, from the profiler's trace)."""

from benchmark.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
