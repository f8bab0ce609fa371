"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own under this folder, so a later cell, mix,
configuration or per-layer metric is new files and new entries, never an
edit of a file that is here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from typing import Any, Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass
class Cell:
    """One cell and everything the run needs of it."""
    name: str
    config: Dict[str, Any]        # configs/<config>.json
    traffic: Dict[str, Any]       # traffic/<traffic>.json
    check: Dict[str, Any]         # workloads/<cell>.json
    chips: int
    end_to_end: List[Dict[str, Any]]   # the cell's end-to-end metrics
    per_layer: List[Dict[str, Any]]    # the cell's per-layer metrics
    run_seconds: int
    root: pathlib.Path = ROOT          # the checkout the files are in


def load(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def _applies(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, bench: Dict[str, Any] | None = None,
         root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench if bench is not None else load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(by_name)}")
    w = by_name[check_name(name)]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "benchmark"
    config = read_json(root / cfg_entry["file"])
    traffic = read_json(here / "traffic" / f"{check_name(w['traffic'])}.json")
    check = read_json(here / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, e2e_names)]
    return Cell(name, config, traffic, check, int(w["chips"]), e2e,
                per_layer, int(bench["run_seconds"]), root)


def driver(name: str, root: pathlib.Path = ROOT):
    """``drivers/<name>.py``."""
    return _load_file(root / "benchmark" / "drivers" /
                      f"{check_name(name)}.py", f"benchmark_driver_{name}")


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """``metrics/<name>.py``: a module with ``read(run) -> float | None``."""
    return _load_file(root / "benchmark" / "metrics" /
                      f"{check_name(name)}.py",
                      f"benchmark_metric_{name.replace('.', '_')}")


def _load_file(path: pathlib.Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def validate(bench: Dict[str, Any], root: pathlib.Path = ROOT) -> None:
    """The contract's limits on names, units, sources and files; raises on
    the first breach."""
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != keys:
        raise ValueError(f"keys {sorted(bench)} != {sorted(keys)}")
    if not 1 <= bench["run_seconds"] <= 51 or \
            int(bench["run_seconds"]) != bench["run_seconds"]:
        raise ValueError("run_seconds is a whole number from 1 to 51")
    names = set()
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ValueError(f"config keys {sorted(c)}")
        check_name(c["name"])
        for k in c["reduced"]:
            check_name(k)
        if not (root / c["file"]).is_file():
            raise FileNotFoundError(c["file"])
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench["paths"]):
            raise ValueError(f"{c['file']} is not under paths")
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ValueError(f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            check_name(w[k])
        if w["config"] not in cfgs or w["chips"] not in (1, 4):
            raise ValueError(f"workload {w['name']}")
        if (w["config"], w["traffic"]) in pairs or w["name"] in names:
            raise ValueError(f"workload {w['name']} twice")
        pairs.add((w["config"], w["traffic"]))
        names.add(w["name"])
        if len(w["why"]) > 200 or "\n" in w["why"] or "\t" in w["why"]:
            raise ValueError(f"why of {w['name']}")
    metric_names = set()
    for m in bench["end_to_end"]:
        extra = set(m) - {"name", "unit", "better", "bound", "source",
                          "workloads"}
        if extra or m["source"] not in SOURCES_E2E or \
                not 0 < m["bound"] <= 0.25:
            raise ValueError(f"end-to-end metric {m['name']}")
        metric_names.add(check_name(m["name"]))
    if "setup_s" not in metric_names:
        raise ValueError("setup_s is missing")
    e2e_names = set(metric_names)
    for m in bench["per_layer"]:
        extra = set(m) - {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if extra or m["source"] not in SOURCES or \
                m["moves"] not in e2e_names:
            raise ValueError(f"per-layer metric {m['name']}")
        if m["name"] in metric_names:
            raise ValueError(f"metric {m['name']} twice")
        metric_names.add(check_name(m["name"]))
        if not (root / "benchmark" / "metrics" /
                f"{m['name']}.py").is_file():
            raise FileNotFoundError(f"metrics/{m['name']}.py")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                            "higher"):
            raise ValueError(f"unit or better of {m['name']}")
        for w in m.get("workloads", ()):
            if w not in names:
                raise ValueError(f"{m['name']} lists unknown cell {w}")
    for w in bench["workloads"]:
        cell(w["name"], bench, root)          # every file is there
