"""Profiling and numeric-guard hooks (the JAX package's ``utils/profiler``).

- ``trace(logdir)``: a ``torch.profiler`` window (CPU and, with a card,
  CUDA activity) written into ``logdir`` as a Chrome trace, which
  ``chrome://tracing``, Perfetto or TensorBoard's profile plugin open;
- ``annotate(name)``: a named range in such a trace (``record_function``),
  and an NVTX range when CUDA is present;
- ``enable_nan_checks()``: the counterpart of ``jax_debug_nans`` (the
  reference's FLAGS_check_nan_inf): raise ``FloatingPointError`` on the
  first operation that makes a NaN, forward or backward;
- ``StepTimer``: steps/s with an exponential moving average;
- ``device_breakdown``: a callable's kernels, device time and busy share on
  the card over a few calls.

The NaN checks are a process-wide switch. Turning it on pushes a
``TorchDispatchMode`` onto the calling thread's mode stack; the mode checks
the floating outputs of every aten operation after it ran. The autograd
engine runs backward under the thread-local state of the call that started
it, so the mode also sees the backward operations, on the engine's device
threads too. Kernels launched through ``ctypes`` pass no aten dispatch: their
wrappers check their own floating outputs when ``nan_checks_on`` is set
(``ops/physics_step.control_step`` and ``ops/attention.flash_attention``;
``ops/lap.track_match`` has integer and boolean outputs only). Only NaN is
checked, not inf, as in JAX. With the switch off, a wrapper pays for one
read of ``nan_checks_on``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import time
from typing import Callable, Iterable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)
from torch.utils._pytree import tree_leaves

ATTEMPTS = 3

# read by the kernel wrappers; set only through enable_nan_checks
nan_checks_on = False
_nan_mode = None

# operations whose outputs are uninitialised memory by contract
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided", "resize_",
                            "set_"})


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block (CPU, and CUDA when a card is present) into a Chrome
    trace under ``logdir``; yields the file's path, written when the block
    ends, also when it raises."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}.{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof = profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """Named range inside a trace (and an NVTX range with a card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def check_outputs(name: str, tensors: Iterable[torch.Tensor]) -> None:
    """Raise ``FloatingPointError`` naming ``name`` if a floating tensor of
    ``tensors`` holds a NaN (one read-back for all of them)."""
    flags = [torch.isnan(t).any() for t in tensors
             if t.is_floating_point() or t.is_complex()]
    if flags and bool(torch.stack(flags).any()):
        raise FloatingPointError(f"invalid value (nan) encountered in {name}")


class _NanCheckMode(TorchDispatchMode):
    """Checks the floating outputs of every aten operation."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            check_outputs(str(func), [
                t for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.layout == torch.strided
                and t.device.type != "meta"])
        return out


def enable_nan_checks(enable: bool = True) -> None:
    """FLAGS_check_nan_inf equivalent: error on the first NaN.

    Call it on and off from the same thread; a thread of its own (a loader's
    worker, a native callback) sees the kernel wrappers' checks but not the
    mode."""
    global nan_checks_on, _nan_mode
    if enable and _nan_mode is None:
        _nan_mode = _NanCheckMode()
        _nan_mode.__enter__()
    elif not enable and _nan_mode is not None:
        if _get_current_dispatch_mode() is not _nan_mode:
            raise RuntimeError("enable_nan_checks(False): another dispatch "
                               "mode is above the NaN checks, or this is "
                               "not the thread that turned them on")
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None
    nan_checks_on = enable


class StepTimer:
    """Throughput counter with exponential moving average."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._t = None
        self.steps_per_sec = 0.0

    def tick(self, n_steps: int = 1) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = n_steps / max(now - self._t, 1e-9)
            self.steps_per_sec = (self.ema * self.steps_per_sec +
                                  (1 - self.ema) * inst
                                  if self.steps_per_sec else inst)
        self._t = now
        return self.steps_per_sec


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
