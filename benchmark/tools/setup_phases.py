"""One run of a cell as ``benchmark.run`` makes it, with its set-up split
by the host clock into phases: ``import torch``, the CUDA context, the
program's modules, the env's construction (the program's
``BatchedQuadrupedEnv``) and the rest up to the window (weights, reset,
warm-up, graph captures); with the host's load average before and after.

    python3 -m benchmark.tools.setup_phases --workload <cell> --seed <n> \
        --seconds 51

Start one process per run, as the benchmark's runs are: the first phases
are paid once a process. ``setup_s`` counts from this module's start, as
``benchmark.run`` counts from its own. Prints one JSON line. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args(argv)
    run._T0 = _T0
    run.cache_dirs()
    load0 = os.getloadavg()
    marks = [("start", time.perf_counter())]
    import torch
    marks.append(("import_torch", time.perf_counter()))
    torch.cuda.init()
    torch.empty(1, device="cuda")
    marks.append(("cuda_context", time.perf_counter()))
    from paddlerobotics_torch.envs import batched_env
    marks.append(("program_import", time.perf_counter()))
    env_s = []
    init = batched_env.BatchedQuadrupedEnv.__init__

    def timed_init(self, *a, **k):
        t = time.perf_counter()
        init(self, *a, **k)
        env_s.append(time.perf_counter() - t)

    batched_env.BatchedQuadrupedEnv.__init__ = timed_init
    try:
        line, rr = run.run_cell(args.workload, args.seed, args.seconds, False)
    finally:
        batched_env.BatchedQuadrupedEnv.__init__ = init
    phases = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    phases["start"] = marks[0][1] - _T0
    phases["env_init"] = sum(env_s)
    phases["rest"] = (rr.window_start - marks[-1][1]) - phases["env_init"]
    rec = {"workload": args.workload, "seed": args.seed,
           "correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "phases_s": phases, "loadavg": [load0, os.getloadavg()]}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
