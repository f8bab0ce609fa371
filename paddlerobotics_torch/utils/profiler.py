"""Profiling, spans and numeric-guard hooks (the JAX package's
``utils/profiler``).

- ``trace(logdir)``: a ``torch.profiler`` window (CPU and, with a card,
  CUDA activity) written into ``logdir`` as a Chrome trace, which
  ``chrome://tracing``, Perfetto or TensorBoard's profile plugin open;
  the program's spans are on inside it;
- ``annotate(name)``: the program's one span API (below);
- ``enable_nan_checks()``: the counterpart of ``jax_debug_nans`` (the
  reference's FLAGS_check_nan_inf): raise ``FloatingPointError`` on the
  first operation that makes a NaN, forward or backward;
- ``device_breakdown``: a callable's kernels, device time and busy share on
  the card over a few calls.

Spans are off unless ``enable_spans(True)`` switches them on. Off,
``annotate(name)`` reads the module global ``spans_on`` and returns one
shared null context: no clock read, no NVTX range, no ``record_function``,
no allocation. On, each span keeps one ``Span`` record in memory: its name,
start and end on ``time.perf_counter_ns``, its id, its parent's id (0 for a
root) and its root's id, which every span opened inside one root shares
(one ``BatchedQuadrupedEnv.step`` call, say). ``collect_spans()`` hands the
records over and clears them. Only while a ``torch.profiler`` session is
active is a span also a ``record_function`` range and, with a card, an NVTX
range, so it lands in the Chrome trace on the profiler's clock beside the
kernels it launched; outside one it pays for neither. While spans are on, a
``gc.callbacks`` hook records every collection as a span ``host.gc`` (its
``generation`` the one collected), inside whatever span was open. The
parents are per thread.

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
import gc
import itertools
import os
import socket
import threading
import time
from typing import Callable, Iterable, List, NamedTuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)
from torch.utils._pytree import tree_leaves

ATTEMPTS = 3

# read by the kernel wrappers; set only through enable_nan_checks
nan_checks_on = False
_nan_mode = None

# read by annotate; set only through enable_spans
spans_on = False

# operations whose outputs are uninitialised memory by contract
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided", "resize_",
                            "set_"})


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block (CPU, and CUDA when a card is present) into a Chrome
    trace under ``logdir``; yields the file's path, written when the block
    ends, also when it raises. The program's spans are on inside the block,
    so each is a range in the trace; where they were off before, they are
    off again after it and the records it made are dropped."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}.{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    was_on, t0 = spans_on, time.perf_counter_ns()
    enable_spans(True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        if not was_on:
            enable_spans(False)
            _records[:] = [r for r in _records if r.start_ns < t0]
        prof.export_chrome_trace(path)


# --- spans -------------------------------------------------------------------

class Span(NamedTuple):
    """One closed span (times on ``time.perf_counter_ns``)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int          # the enclosing span's id; 0 for a root
    root: int            # the root's id (a root's own)
    generation: int      # host.gc: the generation collected; else -1


_records: List[Span] = []
_ids = itertools.count(1)
_local = threading.local()   # .open: (id, root) of each open span, inner last
_gc_open = None
_profiling = torch._C._autograd._profiler_enabled


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL = _NullSpan()


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def _push_ranges(name: str):
    """A ``record_function`` and, with a card, an NVTX range for ``name``,
    entered; None outside a profiler session."""
    if not _profiling():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    return rf, nvtx


def _pop_ranges(ranges) -> None:
    rf, nvtx = ranges
    if nvtx:
        torch.cuda.nvtx.range_pop()
    rf.__exit__(None, None, None)


class _Span:
    __slots__ = ("name", "id", "parent", "root", "ranges", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open()
        self.id = i = next(_ids)
        self.parent, self.root = stack[-1] if stack else (0, i)
        stack.append((i, self.root))
        self.ranges = _push_ranges(self.name)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.ranges is not None:
            _pop_ranges(self.ranges)
        _open().pop()
        _records.append(Span(self.name, self.t0, t1, self.id, self.parent,
                             self.root, -1))


def annotate(name: str):
    """The program's span ``name`` around a block (``with annotate(...)``);
    a shared null context while spans are off."""
    if not spans_on:
        return _NULL
    return _Span(name)


def _gc_hook(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: each collection as a span ``host.gc``."""
    global _gc_open
    if phase == "start":
        stack = _open()
        i = next(_ids)
        parent, root = stack[-1] if stack else (0, i)
        _gc_open = (i, parent, root, info["generation"],
                    _push_ranges("host.gc"), time.perf_counter_ns())
    elif _gc_open is not None:
        t1 = time.perf_counter_ns()
        i, parent, root, generation, ranges, t0 = _gc_open
        _gc_open = None
        if ranges is not None:
            _pop_ranges(ranges)
        _records.append(Span("host.gc", t0, t1, i, parent, root, generation))


def enable_spans(enable: bool = True) -> None:
    """Switch the program's spans (and the ``host.gc`` hook) on or off.
    Records stay until ``collect_spans``."""
    global spans_on
    if enable and _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)
    elif not enable and _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)
    spans_on = enable


def collect_spans() -> List[Span]:
    """The records of every span closed since the last call, in the order
    they closed; clears them."""
    global _records
    out, _records = _records, []
    return out


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
