"""The readings a cell's limits are set from: the program's compared
numbers on many seeds and, on a few, those of each stand-in (the control,
the reference in TF32, and planted faults) put in the program's place and
judged by the same check, all in one process, each seed a short window at
the cell's own size.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--stand-ins control,fault:half_batch] [--stand-in-seeds 3]

Prints one JSON line per seed and appends it to
``chiprun_out/readings_<cell>.jsonl``. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from benchmark import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--stand-ins", default="")
    p.add_argument("--stand-in-seeds", type=int, default=3)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    run.cache_dirs()
    import torch

    out = pathlib.Path("chiprun_out") / f"readings_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    stand_ins = [v for v in args.stand_ins.split(",") if v]
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        line, rr = run.run_cell(
            args.workload, seed, args.seconds, False, device=args.device,
            stand_ins=stand_ins if n < args.stand_in_seeds else ())
        rec = {"seed": seed, "correct": line["correct"],
               "checks": {k: v["value"] for k, v in line["checks"].items()},
               "where": rr.check.where, "compared": rr.check.compared,
               "stand_ins": {v: {"correct": c.correct, "checks": c.values,
                                 "where": c.where}
                             for v, c in rr.stand_ins.items()},
               "metrics": line["metrics"],
               "steps": rr.steps, "memory_peak_bytes":
               line["device"]["memory_peak_bytes"]}
        print(json.dumps(rec), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
