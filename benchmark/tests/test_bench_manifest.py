"""BENCHMARK.json against the contract, the files it names found by name,
and a cell, a traffic mix, a check and a per-layer metric added as new
files only."""

import json
import shutil

import pytest

from benchmark import manifest, run

ROOT = manifest.ROOT


def test_benchmark_json_meets_the_contract():
    bench = manifest.load()
    manifest.validate(bench)
    assert bench["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert bench["paths"] == ["benchmark"]
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in manifest.load()
                                  ["workloads"]])
def test_every_cell_finds_its_files_by_name(name, bench=None):
    cell = manifest.cell(name, bench)
    assert cell.traffic["driver"] in ("rollout", "train", "deploy")
    assert hasattr(manifest.driver(cell.traffic["driver"]), "run")
    assert set(cell.check["limits"]) and all(
        v > 0 for v in cell.check["limits"].values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(manifest.metric_reader(m["name"]).read)


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "pending")
                                        .glob("*.json")),
                         ids=lambda p: p.stem)
def test_a_pending_cell_meets_the_contract_once_added(path):
    """A cell under ``pending/`` is ``BENCHMARK.json`` entries only: added
    to it, the manifest still meets the contract and finds every file."""
    bench = manifest.load()
    for key, entries in json.loads(path.read_text()).items():
        bench[key] += entries
    manifest.validate(bench)
    assert [w["name"] for w in json.loads(path.read_text())["workloads"]] \
        == [path.stem]
    test_every_cell_finds_its_files_by_name(path.stem, bench)


@pytest.mark.parametrize("name,ok", [
    ("env_steps_per_s", True), ("a1_etg_flat.rollout_b4096", True),
    ("_x-1.2", True), ("has space", False), ("a/b", False), ("", False),
    ("x" * 65, False), ("µs", False), (".hidden", False)])
def test_names_allowed(name, ok):
    if ok:
        assert manifest.check_name(name) == name
    else:
        with pytest.raises(ValueError):
            manifest.check_name(name)


@pytest.mark.parametrize("unit,ok", [
    ("env_steps/s", True), ("%", True), ("kernels/step", True),
    ("ms", True), ("tokens per s", False), ("µs", False),
    ("x" * 17, False)])
def test_units_allowed(unit, ok):
    assert bool(manifest.UNIT.match(unit)) == ok


def test_every_unit_and_bound_in_the_manifest():
    bench = manifest.load()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]}[
        "setup_s"] <= 0.25


def test_a_breach_is_refused():
    bench = manifest.load()
    bad = json.loads(json.dumps(bench))
    bad["per_layer"][0]["why"] = "a key no metric may carry"
    with pytest.raises(ValueError):
        manifest.validate(bad)
    bad = json.loads(json.dumps(bench))
    bad["workloads"].append(dict(bad["workloads"][0], name="dup"))
    with pytest.raises(ValueError):
        manifest.validate(bad)


def test_a_new_cell_is_new_files_only(tmp_path):
    """A throwaway cell with its own traffic mix, check and per-layer
    metric: copies of the folder gain files and BENCHMARK.json entries, no
    file there changes, and the cell runs."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    here = tmp_path / "benchmark"
    (here / "traffic" / "rollout_b6_tiny.json").write_text(json.dumps(
        {"driver": "rollout", "num_envs": 6, "warmup_steps": 1,
         "trace_steps": 1}))
    (here / "workloads" / "a1_etg_dr.rollout_b6_tiny.json").write_text(
        json.dumps({"samples": 1, "sample_below": 2,
                    "limits": {"start_gap": 1e-6, "action_gap": 1e-6,
                               "step_gap": 1e-6}}))
    (here / "metrics" / "policy_host_ms.tiny.py").write_text(
        "from benchmark.readers import span_mean_ms\n\n\n"
        "def read(run):\n    return span_mean_ms(run, 'policy')\n")
    bench["workloads"].append(
        {"name": "a1_etg_dr.rollout_b6_tiny", "config": "a1_etg_dr",
         "traffic": "rollout_b6_tiny", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("a1_etg_dr.rollout_b6_tiny")
    bench["per_layer"].append(
        {"name": "policy_host_ms.tiny", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "actor",
         "moves": "env_steps_per_s",
         "workloads": ["a1_etg_dr.rollout_b6_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    manifest.validate(bench, tmp_path)
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    cell = manifest.cell("a1_etg_dr.rollout_b6_tiny", bench, tmp_path)
    assert [m["name"] for m in cell.per_layer] == ["policy_host_ms.tiny"]
    line, _ = run.run_cell(cell, 5, 0.2, False, device="cpu")
    assert line["correct"] and line["metrics"]["env_steps_per_s"][
        "value"] > 0
    line, _ = run.run_cell(cell, 5, 0.2, True, device="cpu")
    assert line["correct"] and line["metrics"]["policy_host_ms.tiny"][
        "value"] > 0
    assert list(line)[-1] == "checks"
