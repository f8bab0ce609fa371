"""Share of the traced ticks' work time in which no device operation
runs: the union of the operations' intervals from the profiler's trace,
with the host's ``sleep`` between ticks left out of the window and of the
busy time (the paced loop rests 22 of its 26 ms)."""

from benchmark.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
