"""The program's own spans (``paddlerobotics_torch.utils.profiler``) read
beside the harness's: per phase of the env step, host ms per step from the
span records of a timed window, and, over a profiled window, the kernels
each span launched, their device time and the device's idle time while the
host was inside it.

Against a program without spans (no ``enable_spans``) ``spans_module``
returns None and every reader here finds nothing: None, or an empty table.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from benchmark import trace as trace_mod

STEP = "env.step"
PHASES = ("env.command", "env.etg", "env.physics", "env.reward",
          "env.autoreset", "env.observe")
PHYSICS = ("physics.args", "physics.ring")
GC = "host.gc"
SETUP = ("setup.env", "setup.kernel")
NAMES = (STEP,) + PHASES + PHYSICS + (GC,) + SETUP
OUTSIDE = "host:outside-spans"
UNMATCHED = "host:launch-not-traced"
HARNESS = "harness:"        # prefix of a harness span's row


def spans_module():
    """The program's ``utils.profiler`` where it has spans, else None."""
    try:
        from paddlerobotics_torch.utils import profiler
    except ImportError:
        return None
    return profiler if hasattr(profiler, "enable_spans") else None


# --- span records of a timed window ------------------------------------------

def in_window(records: Iterable, start_s: float, seconds: float) -> List:
    """The records that started inside the window (``start_s`` on
    ``time.perf_counter``, the clock the records' ``perf_counter_ns``
    reads)."""
    t0 = int(start_s * 1e9)
    t1 = int((start_s + seconds) * 1e9)
    return [r for r in records if t0 <= r.start_ns < t1]


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6


def window_summary(records: Sequence, start_s: float,
                   seconds: float) -> Optional[dict]:
    """Host ms per env step of each span over the window's steps, with
    ``env.step``'s self time and mean, the collector's pauses and their
    generations; None where the window holds no ``env.step`` span."""
    win = in_window(records, start_s, seconds)
    steps = [r for r in win if r.name == STEP]
    if not steps:
        return None
    n = len(steps)
    step_ids = {r.id for r in steps}
    per_step = {name: sum(_ms(r) for r in win if r.name == name and
                          r.root in step_ids) / n
                for name in PHASES + PHYSICS + (GC,)}
    children = sum(_ms(r) for r in win if r.parent in step_ids)
    step_ms = sum(_ms(r) for r in steps) / n
    gcs = [r for r in win if r.name == GC]
    by_gen = {str(g): [r for r in gcs if r.generation == g]
              for g in (0, 1, 2)}
    return {
        "steps": n,
        "env_step_ms": step_ms,
        "env_step_self_ms": step_ms - children / n,
        "host_ms_per_step": per_step,
        # pauses directly under env.step, between its phases: with the
        # phases and the self time they make up env.step
        "gc_between_phases_ms": sum(_ms(r) for r in gcs
                                    if r.parent in step_ids) / n,
        "gc": {g: {"count": len(x), "ms": sum(map(_ms, x)),
                   "max_ms": max(map(_ms, x), default=0.0),
                   "in_steps": sum(r.root in step_ids for r in x)}
               for g, x in by_gen.items()},
        "step_max_ms": max(_ms(r) for r in steps),
    }


def setup_seconds(records: Iterable) -> Dict[str, float]:
    """Seconds of the first ``setup.env`` and ``setup.kernel`` span (a
    process builds or loads the kernel once)."""
    out: Dict[str, float] = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        if r.name in SETUP and r.name not in out:
            out[r.name] = _ms(r) * 1e-3
    return out


# --- spans on the profiler's clock -------------------------------------------

def _nest(ranges: List[dict]) -> None:
    """Give each range (``ts``, ``end``, ``tid``) its ``depth`` and
    ``parent`` (an index into ``ranges`` or None) on its thread."""
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i]["tid"], ranges[i]["ts"],
                                  -ranges[i]["end"]))
    stack: List[int] = []
    tid = None
    for i in order:
        r = ranges[i]
        if r["tid"] != tid:
            stack, tid = [], r["tid"]
        while stack and ranges[stack[-1]]["end"] <= r["ts"]:
            stack.pop()
        r["parent"] = stack[-1] if stack else None
        r["depth"] = len(stack)
        stack.append(i)


def _ranges(xs: List[dict], w0: float, w1: float,
            harness_names) -> List[dict]:
    """The harness's and the program's ranges inside the window. A harness
    span is outermost; the program's ``env.step`` sits inside the
    harness's range of the same name."""
    out = []
    for e in xs:
        if e.get("cat") != "user_annotation":
            continue
        name = e.get("name")
        if name not in NAMES and name not in harness_names:
            continue
        ts = float(e["ts"])
        end = ts + float(e["dur"])
        if end <= w0 or ts >= w1:
            continue
        out.append({"name": name, "ts": ts, "end": end,
                    "tid": e.get("tid")})
    _nest(out)
    for r in out:
        top = r["depth"] == 0 and r["name"] in harness_names
        r["row"] = HARNESS + r["name"] if top else r["name"]
        r["program"] = not top and r["name"] in NAMES
    return out


def _innermost_at(ranges: List[dict], t: float) -> str:
    best = None
    for r in ranges:
        if r["ts"] <= t < r["end"] and (best is None or
                                       r["depth"] > best["depth"]):
            best = r
    return best["row"] if best else OUTSIDE


def _gap_owner(ranges: List[dict], a: float, b: float) -> str:
    """The innermost program span that covers more than half of the gap
    [a, b], else the span (program or harness) that covers most of it,
    else ``host:outside-spans``."""
    half = (b - a) / 2
    best, best_cover = None, 0.0
    inner = None
    for r in ranges:
        cover = min(r["end"], b) - max(r["ts"], a)
        if cover <= 0:
            continue
        if r["program"] and cover > half and (
                inner is None or r["depth"] > inner["depth"]):
            inner = r
        if cover > best_cover:
            best, best_cover = r, cover
    if inner is not None:
        return inner["row"]
    return best["row"] if best else OUTSIDE


def _host_op(ops, a: float, b: float) -> str:
    """The innermost (shortest) host operation that covers more than half
    of [a, b], else the one that covers most of it; ``-`` where none
    does."""
    inner, inner_len = None, 0.0
    best, best_cover = "-", 0.0
    for o0, o1, name in ops:
        cover = min(o1, b) - max(o0, a)
        if cover <= 0:
            continue
        if cover > (b - a) / 2 and (inner is None or o1 - o0 < inner_len):
            inner, inner_len = name, o1 - o0
        if cover > best_cover:
            best, best_cover = name, cover
    return inner if inner is not None else best


def by_span(events: List[dict], harness_names, steps: int,
            k: int = 10) -> dict:
    """Per program span (and per harness span, as ``harness:<name>``) over
    the profiled window, each per step: calls, host ms, self ms (less its
    child spans), kernels launched inside it (a kernel goes to the
    innermost span around its launch, matched through the trace's
    ``correlation`` id), their device ms and the idle ms of the device
    gaps it owns (``_gap_owner``); and the ``k`` longest gaps, each named
    by its owner and by the host operation (CPU operator or CUDA API call)
    that covers most of it. Kernels with no launch event in the trace form
    the row ``host:launch-not-traced``, so the rows' kernels
    (``kernels_in_rows``) add up to the window's (``kernels``); each row
    also names its three most launched kernels (``top_kernels``, launches
    per step)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == trace_mod.WINDOW and
           e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no bench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ranges = _ranges(xs, w0, w1, set(harness_names))
    rows: Dict[str, Dict[str, float]] = {}

    def row(name):
        return rows.setdefault(name, {"calls": 0.0, "host_ms": 0.0,
                                      "self_ms": 0.0, "kernels": 0.0,
                                      "device_ms": 0.0, "idle_ms": 0.0})

    child = [0.0] * len(ranges)
    for r in ranges:
        if r["parent"] is not None:
            child[r["parent"]] += r["end"] - r["ts"]
    for i, r in enumerate(ranges):
        x = row(r["row"])
        x["calls"] += 1
        x["host_ms"] += (r["end"] - r["ts"]) * 1e-3
        x["self_ms"] += (r["end"] - r["ts"] - child[i]) * 1e-3
    launches = {}
    for e in xs:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver"):
            launches[corr] = float(e["ts"])
    dev = [e for e in xs if e.get("cat") in trace_mod.DEVICE_CATS and
           w0 <= float(e["ts"]) < w1]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    names: Dict[str, Dict[str, int]] = {}
    for e in kernels:
        t = launches.get((e.get("args") or {}).get("correlation"))
        owner = UNMATCHED if t is None else _innermost_at(ranges, t)
        x = row(owner)
        x["kernels"] += 1
        x["device_ms"] += float(e["dur"]) * 1e-3
        kn = names.setdefault(owner, {})
        kn[e["name"][:80]] = kn.get(e["name"][:80], 0) + 1
    ivs = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                          w1)) for e in dev]
    busy = trace_mod.union([(a, b) for a, b in ivs if b > a])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            owner = _gap_owner(ranges, a, b)
            row(owner)["idle_ms"] += (b - a) * 1e-3
            gaps.append(((b - a) * 1e-6, owner, a, b))
    gaps.sort(reverse=True)
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime",
                                           "cuda_driver")]
    per = max(steps, 1)
    table = {n: {c: v / per for c, v in x.items()} for n, x in rows.items()}
    for n, kn in names.items():
        table[n]["top_kernels"] = [
            [name, c / per] for name, c in sorted(
                kn.items(), key=lambda kv: -kv[1])[:3]]
    return {"spans": table, "kernels": len(kernels),
            "kernels_in_rows": int(sum(x["kernels"] for x in rows.values())),
            "idle_ms": sum(g[0] for g in gaps) * 1e3 / per,
            "program_gaps": [[n, g, _host_op(ops, a, b)]
                             for g, n, a, b in gaps[:k]]}
