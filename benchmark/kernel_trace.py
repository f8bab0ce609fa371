"""Device time of one kernel, found by its name in a traced window, per
unit of one of the program's counters.

``trace.reduce`` keeps every kernel of the traced window by name
(``kernel_us``); the program's counters are kept over the same steps
(``program_trace.profile``). Against a program without the kernel or the
counter, the reader finds nothing and returns None.
"""

from __future__ import annotations

import re


def kernel_s_per_count(run, pattern: str, counter: str):
    """Device seconds of the traced window's kernels whose name matches
    ``pattern``, per unit of the counter ``counter``; None where the trace
    has no such kernel or the counter is absent or zero."""
    tr = run.result.trace
    if not tr:
        return None
    us = [d for n, d in tr.get("kernel_us", ()) if re.search(pattern, n)]
    n = tr.get("counters", {}).get(counter)
    return sum(us) * 1e-6 / n if us and n else None
