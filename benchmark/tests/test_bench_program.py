"""The program's spans read by ``benchmark/program.py``: a synthetic trace
split span by span (kernels through their launches' correlation ids, idle
gaps to the innermost span that holds most of each), and the small CPU
rollout cells run with the program's spans on through
``benchmark/tools/spans.py``."""

import math

import pytest

from benchmark import program, run, trace
from benchmark.tools import spans as spans_tool

from test_bench_cells import ROLLOUT, small


def _ev(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_a_trace_is_split_span_by_span():
    ev = [_ev(trace.WINDOW, "user_annotation", 0.0, 100.0),
          _ev("policy", "user_annotation", 0.0, 20.0),
          _ev("env.step", "user_annotation", 20.0, 80.0),     # harness
          _ev("env.step", "user_annotation", 21.0, 78.0),     # program
          _ev("env.etg", "user_annotation", 22.0, 10.0),
          _ev("env.physics", "user_annotation", 40.0, 30.0),
          _ev("physics.args", "user_annotation", 41.0, 4.0),
          _ev("host.gc", "user_annotation", 50.0, 15.0),
          _ev("cudaLaunchKernel", "cuda_runtime", 2.0, 1.0, corr=1),
          _ev("cudaLaunchKernel", "cuda_runtime", 23.0, 1.0, corr=2),
          _ev("cuLaunchKernel", "cuda_driver", 42.0, 1.0, corr=3),
          _ev("gemm", "kernel", 3.0, 5.0, corr=1),
          _ev("etg", "kernel", 25.0, 5.0, corr=2),
          _ev("control_step_kernel", "kernel", 44.0, 4.0, corr=3),
          _ev("lost", "kernel", 90.0, 2.0, corr=9),
          _ev("aten::copy_", "cpu_op", 48.0, 41.0),
          _ev("cudaStreamSynchronize", "cuda_runtime", 49.0, 39.0)]
    out = program.by_span(ev, {"policy", "env.step"}, steps=1)
    rows = out["spans"]
    assert out["kernels"] == out["kernels_in_rows"] == 4
    assert rows["harness:policy"]["kernels"] == 1
    assert rows["env.etg"]["kernels"] == 1
    assert rows["physics.args"]["kernels"] == 1
    assert rows[program.UNMATCHED]["kernels"] == 1
    assert rows["env.physics"]["self_ms"] == pytest.approx((30 - 4 - 15)
                                                           * 1e-3)
    assert rows["harness:env.step"]["calls"] == rows["env.step"]["calls"] \
        == 1
    # busy 3-8, 25-30, 44-48, 90-92, so the gaps are 48-90 (env.physics
    # holds over half), 8-25 (no program span holds half: policy covers
    # most), 30-44 and 92-100 (the program's env.step), 0-3 (policy)
    assert out["program_gaps"] == [
        ["env.physics", pytest.approx(42e-6), "cudaStreamSynchronize"],
        ["harness:policy", pytest.approx(17e-6), "cudaLaunchKernel"],
        ["env.step", pytest.approx(14e-6), "cuLaunchKernel"],
        ["env.step", pytest.approx(8e-6), "-"],
        ["harness:policy", pytest.approx(3e-6), "cudaLaunchKernel"]]
    assert rows["physics.args"]["top_kernels"] == [
        ["control_step_kernel", 1.0]]
    assert out["idle_ms"] == pytest.approx(84e-3)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(84e-3)


def test_the_gc_pause_owns_a_gap_it_holds():
    ev = [_ev(trace.WINDOW, "user_annotation", 0.0, 100.0),
          _ev("env.step", "user_annotation", 0.0, 100.0),
          _ev("env.step", "user_annotation", 1.0, 98.0),
          _ev("env.reward", "user_annotation", 10.0, 80.0),
          _ev("host.gc", "user_annotation", 20.0, 60.0),
          _ev("k", "kernel", 0.0, 10.0), _ev("k", "kernel", 90.0, 10.0)]
    out = program.by_span(ev, {"policy", "env.step"}, steps=1)
    assert out["program_gaps"] == [["host.gc", pytest.approx(80e-6), "-"]]
    assert out["kernels_in_rows"] == out["kernels"] == 2


@pytest.mark.parametrize("name", ROLLOUT)
def test_small_rollout_with_spans_reads_every_phase(name):
    rec = spans_tool.run_once(small(name), 2 ** 31 + 11, 0.2, True, True,
                              device="cpu")
    assert rec["correct"]
    w = rec["window"]
    assert w["steps"] == rec["steps"] >= 1
    for phase in program.PHASES:
        assert math.isfinite(w["host_ms_per_step"][phase])
        assert w["host_ms_per_step"][phase] > 0, phase
    parts = (sum(w["host_ms_per_step"][p] for p in program.PHASES) +
             w["gc_between_phases_ms"] + w["env_step_self_ms"])
    assert parts == pytest.approx(w["env_step_ms"])
    assert w["env_step_ms"] <= rec["env_step_host_ms"]
    assert set(rec["setup"]) >= {"setup.env"}
    b = rec["by_span"]
    assert b["kernels_in_rows"] == b["kernels"]
    for phase in program.PHASES:
        assert b["spans"][phase]["calls"] >= 1, phase


@pytest.mark.parametrize("name", ROLLOUT)
def test_untraced_line_keeps_its_keys_with_spans_on(name):
    off, _ = run.run_cell(small(name), 2 ** 31 + 13, 0.1, False,
                          device="cpu")
    prof = program.spans_module()
    prof.enable_spans(True)
    try:
        on, _ = run.run_cell(small(name), 2 ** 31 + 13, 0.1, False,
                             device="cpu")
    finally:
        prof.enable_spans(False)
        prof.collect_spans()
    assert on.keys() == off.keys()
    assert on["metrics"].keys() == off["metrics"].keys()
    assert on["correct"] and all(v["value"] == 0.0
                                 for v in on["checks"].values())
