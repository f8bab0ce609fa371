"""A short ``torch.profiler`` window over steady steps, reduced to what the
per-layer readers and the result's ``breakdown`` take: the device's busy
time as the union of its operations' intervals (overlapping kernels count
once), the ten longest idle gaps, each named by the harness span that
covers most of it on the host, and the device time by operation name.

The Chrome trace is written to ``harness.scratch_dir()``, read back and
deleted.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Tuple

import torch

from benchmark.harness import scratch_dir

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def profile(step: Callable[[int], None], n: int, spans, name: str) -> dict:
    """Run ``step(i)`` for i = 1..n under the profiler with the spans
    annotated, inside one ``bench.window`` range that ends with a
    synchronize (step 0 runs first, outside it); returns ``reduce`` of the
    trace."""
    from torch.profiler import ProfilerActivity, record_function

    spans.annotate = True
    path = scratch_dir() / f"benchmark_trace_{name}.json"
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        with torch.profiler.profile(activities=acts) as prof:
            # one step before the window takes the profiler's own start-up
            step(0)
            if cuda:
                torch.cuda.synchronize()
            with record_function(WINDOW):
                for i in range(1, n + 1):
                    step(i)
                if cuda:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        spans.annotate = False
        if path.exists():
            path.unlink()
    out = reduce(events, set(spans.ms))
    out["steps"] = n
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(events: List[dict], span_names) -> dict:
    """Busy and window seconds, kernels, device time by name and the idle
    gaps of one traced window (times in the trace are microseconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW and
           e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no bench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    # the device's operations that started inside the window
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and
           w0 <= float(e["ts"]) < w1]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    ivs = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                          w1)) for e in dev]
    busy_ivs = union([(a, b) for a, b in ivs if b > a])
    busy = sum(b - a for a, b in busy_ivs)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs
                  if e.get("cat") == "user_annotation" and
                  e.get("name") in span_names)
    edges = [w0] + [x for iv in busy_ivs for x in iv] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)
    named = [(_busiest_span(host, a, b), g) for g, a, b in gaps[:10]]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": len(kernels),
        "kernel_us": [(e["name"], float(e["dur"])) for e in kernels],
        "device_ops": sorted(((k, v * 1e-6) for k, v in by_name.items()),
                             key=lambda kv: -kv[1]),
        "idle_gaps": [(name, g * 1e-6) for name, g in named],
    }


def _busiest_span(host, a: float, b: float) -> str:
    """The harness span that covers most of the interval [a, b] on the
    host."""
    best, name = 0.0, "host:outside-spans"
    for s0, s1, n in host:
        cover = min(s1, b) - max(s0, a)
        if cover > best:
            best, name = cover, n
    return name


def breakdown(tr: dict, k: int = 10) -> dict:
    return {"device_ops": [[n[:160], s] for n, s in tr["device_ops"][:k]],
            "idle_gaps": [[n, s] for n, s in tr["idle_gaps"][:k]]}

