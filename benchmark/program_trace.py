"""A profiled window with the program's own spans and counters on: what
``trace.profile`` gives, and the device time of the kernels launched inside
each of the program's spans that a driver names.

The program's spans (``paddlerobotics_torch.utils.profiler``) are switched
on for the window's steps only, after the profiler's first step, and off
again after it; their records and the counters they kept are handed over
with the trace. Against a program without spans or counters the window is
traced all the same and those parts are empty.
"""

from __future__ import annotations

import bisect
import json
from typing import Callable, Dict, Iterable, List

import torch

from benchmark import program, trace as trace_mod
from benchmark.harness import scratch_dir


def profile(step: Callable[[int], None], n: int, spans, name: str,
            program_spans: Iterable[str]) -> dict:
    """Run ``step(0)`` and then ``step(i)`` for i = 1..n inside the
    ``bench.window`` range, as ``trace.profile`` does, the program's spans
    on over the window; returns ``trace.reduce`` of it with ``steps``,
    ``span_device`` (``span_device`` over ``program_spans``),
    ``program_ms`` (host ms of each program span closed in the window, by
    name) and ``counters``."""
    from torch.profiler import ProfilerActivity, record_function

    prof = program.spans_module()
    spans.annotate = True
    path = scratch_dir() / f"benchmark_trace_{name}.json"
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    records, counters = [], {}
    try:
        with torch.profiler.profile(activities=acts) as p:
            step(0)
            if cuda:
                torch.cuda.synchronize()
            if prof is not None:
                prof.collect_spans()
                _counters(prof)
                prof.enable_spans(True)
            try:
                with record_function(trace_mod.WINDOW):
                    for i in range(1, n + 1):
                        step(i)
                    if cuda:
                        torch.cuda.synchronize()
            finally:
                if prof is not None:
                    prof.enable_spans(False)
                    records, counters = prof.collect_spans(), _counters(prof)
        p.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        spans.annotate = False
        if path.exists():
            path.unlink()
    out = trace_mod.reduce(events, set(spans.ms) | set(program_spans))
    out["steps"] = n
    out["span_device"] = span_device(events, program_spans)
    ms: Dict[str, List[float]] = {}
    for r in records:
        ms.setdefault(r.name, []).append((r.end_ns - r.start_ns) * 1e-6)
    out["program_ms"] = ms
    out["counters"] = counters
    return out


def _counters(prof) -> Dict[str, int]:
    collect = getattr(prof, "collect_counters", None)
    return collect() if collect is not None else {}


def span_device(events: List[dict], names: Iterable[str]) -> dict:
    """For each span name: its ranges inside the window (``calls``) and the
    kernels launched inside any of them (matched to their launch through the
    trace's ``correlation`` id; nested ranges of one name count a kernel
    once), their number and device seconds. A name with no range in the
    window is left out."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == trace_mod.WINDOW and
           e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no bench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    launches = {}
    for e in xs:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver"):
            launches[corr] = float(e["ts"])
    kernels = [e for e in xs if e.get("cat") == "kernel" and
               w0 <= float(e["ts"]) < w1]
    out = {}
    for name in names:
        ivs = trace_mod.union([
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
            if e.get("cat") == "user_annotation" and e.get("name") == name
            and w0 <= float(e["ts"]) < w1])
        calls = sum(1 for e in xs if e.get("cat") == "user_annotation" and
                    e.get("name") == name and w0 <= float(e["ts"]) < w1)
        if not calls:
            continue
        starts = [a for a, _ in ivs]
        n_k, dev_us = 0, 0.0
        for e in kernels:
            t = launches.get((e.get("args") or {}).get("correlation"))
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t < ivs[j][1]:
                n_k += 1
                dev_us += float(e["dur"])
        out[name] = {"calls": calls, "kernels": n_k,
                     "device_s": dev_us * 1e-6}
    return out


def device_s_per_count(run, span: str, counter: str):
    """Device seconds of the kernels launched inside the program's span
    ``span`` in a traced run, per unit of its counter ``counter``; None
    where the trace has no such span or counter."""
    tr = run.result.trace
    if not tr or span not in tr.get("span_device", {}):
        return None
    n = tr.get("counters", {}).get(counter)
    return tr["span_device"][span]["device_s"] / n if n else None
