"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced, the
``breakdown``; its last key, ``checks``, holds each number compared beside
its limit, which also end standard error. Without a card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits with 2, 3 or 4.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()      # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def cache_dirs(root: pathlib.Path = ROOT) -> None:
    """Fixed cache directories inside the checkout, so the first run of a
    cell builds and every later one finds what it built. (The port builds
    its kernels into ``build/torch_kernels/`` inside the checkout by
    itself.)"""
    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / sub)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device=None, stand_ins=()):
    """Run the cell (a name, or a ``manifest.Cell``); returns (the result
    line as a dict, the driver's ``RunResult``). ``device`` defaults to the
    card; the tests pass the CPU, whose plain physics stands in for the
    kernel, and cells cut to a small batch. Each of ``stand_ins``
    (``control``, the reference in TF32, or ``fault:<name>``, the reference
    with a planted fault) is put in the program's place after the window
    and judged by the same check: ``stand_in_line`` gives its line."""
    import torch

    from benchmark import harness, manifest
    from benchmark import trace as trace_mod
    from benchmark.reference import config as rconfig

    if isinstance(cell, str):
        cell = manifest.cell(cell)
    device = torch.device(device or "cuda")
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = manifest.driver(cell.traffic["driver"], cell.root)
    rr = drv.run(cell, seed, seconds, bool(trace), device, tuple(stand_ins))
    metrics = {}
    if not trace:
        setup_s = rr.window_start - _T0
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else rr.metrics[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(
            result=rr, cell=cell, cfg=harness.quadruped_config(
                rconfig.QuadrupedConfig, cell.config["quadruped"]))
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"], cell.root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": rr.memory_peak_bytes}
    line = {"correct": rr.check.correct, "attempted": rr.attempted,
            "failed": rr.failed, "metrics": metrics, "device": dev}
    if trace and rr.trace is not None:
        dev["busy_s"] = rr.trace["busy_s"]
        dev["window_s"] = rr.trace["window_s"]
        line["breakdown"] = trace_mod.breakdown(rr.trace)
    line["checks"] = rr.check.line()
    return line, rr


def stand_in_line(line: dict, rr, name: str) -> dict:
    """The result line with the stand-in ``name``'s outputs in the
    program's place: the same check, another verdict."""
    c = rr.stand_ins[name]
    return dict(line, correct=c.correct, failed=int(not c.correct),
                checks=c.line())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    import torch

    from benchmark import harness, manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    if cell.chips > 1:
        print(f"{args.workload}: no driver runs over {cell.chips} cards",
              file=sys.stderr)
        return 3
    line, rr = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, v in line["checks"].items():
        where = rr.check.where.get(k, "")
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})"
              f"{' at ' + where if where else ''}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
