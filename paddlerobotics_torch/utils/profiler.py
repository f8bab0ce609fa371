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


ATTEMPTS = 3


def device_breakdown(fn: Callable[[], object], reps: int, top: int = 6,
                     match: str | None = None) -> dict:
    """Profile `reps` calls of `fn` (after one warm-up call).

    Returns per-call kernel count and device ms, wall ms, the device busy
    share (summed kernel time over wall time, one stream) and the `top`
    kernels by device time with their share of it. With `match`, also the
    launches and device ms per call of the kernels whose name contains it
    (`match_launches_per_call`, `match_ms_per_call`). Raises if the
    profiler saw no such kernel in `ATTEMPTS` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a window of a few short kernels now and then comes back with no
    # device events at all (or none of the matched ones); such a window is
    # taken again
    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        per_kernel = collections.Counter()
        count = matched = 0
        for ev in prof.events():
            # ranges such as ``Optimizer.step`` are recorded on the device
            # too, over the kernels they hold: not kernels themselves
            if ev.device_type != torch.autograd.DeviceType.CUDA or \
                    getattr(ev, "is_user_annotation", False):
                continue
            count += 1
            matched += bool(match and match in ev.name)
            per_kernel[ev.name] += ev.time_range.elapsed_us()
        if count and (matched or not match):
            break
    else:
        raise RuntimeError(f"torch.profiler saw no device kernel "
                           f"{'named ' + match + ' ' if match else ''}in "
                           f"{ATTEMPTS} windows of {reps} calls")
    dev_us = sum(per_kernel.values())
    out = {
        "kernels_per_call": count / reps,
        "device_ms_per_call": dev_us / reps / 1e3,
        "wall_ms_per_call": wall_us / reps / 1e3,
        "device_busy_share": dev_us / wall_us if wall_us else 0.0,
        "top": [(name[:60], round(us / dev_us, 4) if dev_us else 0.0)
                for name, us in per_kernel.most_common(top)],
    }
    if match:
        out["match_launches_per_call"] = matched / reps
        out["match_ms_per_call"] = sum(
            us for name, us in per_kernel.items() if match in name) / reps / 1e3
    return out
