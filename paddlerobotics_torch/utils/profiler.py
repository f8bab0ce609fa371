"""Device-time breakdown of a callable on the card (torch.profiler).

The port's counterpart of the JAX package's ``utils/profiler.trace``:
``device_breakdown`` runs a callable a few times under ``torch.profiler``
and reports what the card did in that window — kernels launched, their
summed device time, the busy share of the wall time, and the kernels that
took most of it.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import torch


def device_breakdown(fn: Callable[[], object], reps: int, top: int = 6
                     ) -> dict:
    """Profile `reps` calls of `fn` (after one warm-up call).

    Returns per-call kernel count and device ms, wall ms, the device busy
    share (summed kernel time over wall time, one stream) and the `top`
    kernels by device time with their share of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = collections.Counter()
    count = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        count += 1
        per_kernel[ev.name] += ev.time_range.elapsed_us()
    dev_us = sum(per_kernel.values())
    return {
        "kernels_per_call": count / reps,
        "device_ms_per_call": dev_us / reps / 1e3,
        "wall_ms_per_call": wall_us / reps / 1e3,
        "device_busy_share": dev_us / wall_us if wall_us else 0.0,
        "top": [(name[:60], round(us / dev_us, 4) if dev_us else 0.0)
                for name, us in per_kernel.most_common(top)],
    }
