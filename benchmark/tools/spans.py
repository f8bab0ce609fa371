"""A cell's run with the program's spans on (``utils/profiler.enable_spans``
from before the env is built to after the profiled steps), read by
``benchmark/program.py``: each phase of the env step in host ms per step
over the timed window, the set-up spans, and with ``--trace 1`` the
profiler's steps span by span (kernels, device ms, idle ms) with the ten
longest idle gaps named by the program's spans.

    python3 -m benchmark.tools.spans --workload <cell> --seeds 1,2 \
        --seconds 51 [--trace 1] [--spans 0]

``--spans 0`` makes the same run with the program's spans off, so the
harness's own ``env.step`` span (``env_step_host_ms``) can be read with
them on against off. Prints one JSON line per seed. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from benchmark import program, run
from benchmark import trace as trace_mod


def run_once(cell, seed: int, seconds: float, trace: bool, spans: bool,
             device=None) -> dict:
    """One run of ``cell`` (a name or a ``manifest.Cell``) with the
    program's spans on or off; returns its record."""
    prof = program.spans_module() if spans else None
    if spans and prof is None:
        raise RuntimeError("the program has no spans (utils/profiler)")
    # trace.profile deletes its Chrome trace once reduced: keep the events
    # it hands to reduce
    captured = []
    reduce = trace_mod.reduce

    def keep(events, names, *rest):
        captured.append((events, set(names)))
        return reduce(events, names, *rest)

    trace_mod.reduce = keep
    if prof:
        prof.collect_spans()
        prof.enable_spans(True)
    try:
        line, rr = run.run_cell(cell, seed, seconds, trace, device=device)
    finally:
        trace_mod.reduce = reduce
        if prof:
            prof.enable_spans(False)
    records = prof.collect_spans() if prof else []
    # the run's lists of span times go on past the window into the
    # profiled steps: the window's own are its first ``steps``
    ms = (rr.spans.get("env.step") or [])[:rr.steps]
    rec = {"seed": seed, "spans": bool(spans), "trace": bool(trace),
           "correct": line["correct"],
           "checks": {k: v["value"] for k, v in line["checks"].items()},
           "env_steps_per_s": rr.metrics.get("env_steps_per_s"),
           "steps": rr.steps,
           "env_step_host_ms": statistics.fmean(ms) if ms else None,
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "device": line["device"]}
    if records:
        rec["window"] = program.window_summary(records, rr.window_start,
                                               rr.window_s)
        rec["setup"] = program.setup_seconds(records)
    if captured and rr.trace is not None:
        events, names = captured[-1]
        rec["by_span"] = program.by_span(events, names, rr.trace["steps"])
        rec["harness_idle_gaps"] = rr.trace["idle_gaps"]
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    run.cache_dirs()
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = run_once(args.workload, seed, args.seconds, bool(args.trace),
                       bool(args.spans), device=args.device)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
