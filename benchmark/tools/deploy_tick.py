"""The deploy cell's tick split into its parts, run by run. From each
tick's due time: the wake-up after the pacer's sleep (due time to the
tick's start), ``DeployPolicy``, the env step, the observation's copy to
the host, and the rest of the work (``read_state``, the spans). For each
part its mean, median, p95, largest, and mean over the tail ticks (those
at or over the tick's p95).

    python3 -m benchmark.tools.deploy_tick --seeds 1,2 --seconds 51

The cell's entries are merged in from ``benchmark/pending/`` where they
wait there. The harness's spans are on in the window (four spans a tick,
a few µs). Start one process per seed to run as the benchmark does. Prints
one JSON line per seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmark import harness, manifest, run

CELL = "a1_etg_flat.deploy_b1_38hz"


def with_pending() -> dict:
    """``BENCHMARK.json`` with the entries of the cells under ``pending/``."""
    bench = manifest.load()
    for path in sorted((manifest.HERE / "pending").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            bench[key] += [e for e in entries if e not in bench[key]]
    return bench


def probe(cell, seed: int, seconds: float, device=None) -> dict:
    """One run of the deploy ``cell`` (a ``manifest.Cell``) with its tick
    split into parts; returns its record."""
    wake, lat = [], []
    init, wait, latency = (harness.Spans.__init__, harness.Pacer.wait,
                           harness.Pacer.latency_ms)

    def spans_on(self, on=False):
        init(self, on=True)

    def timed_wait(self, i):
        due = wait(self, i)
        wake.append((self.clock() - due) * 1e3)
        return due

    def timed_latency(self, due):
        v = latency(self, due)
        lat.append(v)
        return v

    harness.Spans.__init__ = spans_on
    harness.Pacer.wait, harness.Pacer.latency_ms = timed_wait, timed_latency
    try:
        line, rr = run.run_cell(cell, seed, seconds, False, device=device)
    finally:
        harness.Spans.__init__ = init
        harness.Pacer.wait, harness.Pacer.latency_ms = wait, latency
    n = rr.steps     # the warm-up's ticks are not paced: neither waits
    parts = {"wake": np.array(wake),
             "policy": np.array(rr.spans["policy"]),
             "env_step": np.array(rr.spans["env.step"]),
             "to_host": np.array(rr.spans["obs.to_host"]),
             "tick": np.array(lat)}
    parts["rest"] = parts["tick"] - sum(parts[k] for k in (
        "wake", "policy", "env_step", "to_host"))
    tail = parts["tick"] >= np.percentile(parts["tick"], 95)
    return {"seed": seed, "correct": line["correct"], "ticks": n,
            "tick_p95_ms": line["metrics"]["tick_p95_ms"]["value"],
            "setup_s": line["metrics"]["setup_s"]["value"],
            "late_ticks": int((parts["wake"] > cell.traffic["dt_s"] * 1e3)
                              .sum()),
            "parts_ms": {k: {"mean": float(v.mean()),
                             "p50": float(np.percentile(v, 50)),
                             "p95": float(np.percentile(v, 95)),
                             "max": float(v.max()),
                             "tail_mean": float(v[tail].mean())}
                         for k, v in parts.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    run.cache_dirs()
    cell = manifest.cell(CELL, with_pending())
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(probe(cell, seed, args.seconds, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
