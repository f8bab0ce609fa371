"""The harness's arithmetic: the open loop's tick schedule, the gaps
compared, the drawn sample of steps and the trace's busy union and gaps."""

import math

import pytest
import torch

from benchmark import harness, trace


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        assert s > 0
        self.t += s


def test_ticks_on_time_read_their_own_work():
    c = FakeClock()
    p = harness.Pacer(0.026, clock=c, sleep=c.sleep)
    p.start()
    lat = []
    for i in range(5):
        due = p.wait(i)
        assert due == pytest.approx(100.0 + 0.026 * i)
        c.t += 0.005                       # the tick's work
        lat.append(p.latency_ms(due))
    assert lat == pytest.approx([5.0] * 5)


def test_a_late_tick_delays_the_ticks_after_it():
    c = FakeClock()
    p = harness.Pacer(0.026, clock=c, sleep=c.sleep)
    p.start()
    work = [0.005, 0.060, 0.005, 0.005, 0.005]
    lat = []
    for i, w in enumerate(work):
        due = p.wait(i)
        c.t += w
        lat.append(p.latency_ms(due))
    # tick 1 ends at 100.086; tick 2 (due 100.052) starts then and ends at
    # 100.091, tick 3 (due 100.078) ends at 100.096; tick 4 (due 100.104)
    # is on time again
    assert lat == pytest.approx([5.0, 60.0, 39.0, 18.0, 5.0])


@pytest.mark.parametrize("p,r,want", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.0, 2.5], [1.0, 2.0], 0.25),          # over the widest |r| = 2
    ([0.001], [0.0], 0.001),                  # near zero: absolute
    ([True, False], [True, True], 1.0),
    ([math.nan], [1.0], math.inf),
])
def test_gap(p, r, want):
    assert harness.gap(torch.tensor(p), torch.tensor(r)) == \
        pytest.approx(want)


def test_gap_of_different_shapes_is_infinite():
    assert harness.gap(torch.zeros(3), torch.zeros(4)) == math.inf


def test_sample_steps_follow_the_seed():
    a = harness.sample_steps(2 ** 31 + 99, 4, 1500)
    assert a == harness.sample_steps(2 ** 31 + 99, 4, 1500)
    assert a[0] == 0 and len(set(a)) == 5 and max(a) < 1500
    assert a != harness.sample_steps(2 ** 31 + 98, 4, 1500)


def test_check_is_correct_only_with_every_number_under_its_limit():
    c = harness.Check({"a": 1e-5, "b": 1e-5})
    c.add("a", 0.0)
    assert not c.correct                      # b never compared
    c.add("b", 2e-6)
    assert c.correct
    c.add("b", 1e-6)                          # the widest stays
    assert c.values["b"] == 2e-6
    c.add("a", math.nan)
    assert not c.correct and c.over() == ["a"]
    assert c.line()["a"]["value"] == "nan"


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_busy_is_the_union_and_gaps_are_named():
    ev = [_ev(trace.WINDOW, "user_annotation", 0.0, 100.0),
          _ev("env.step", "user_annotation", 0.0, 60.0),
          _ev("policy", "user_annotation", 60.0, 40.0),
          _ev("k1", "kernel", 10.0, 20.0),
          _ev("k2", "kernel", 20.0, 20.0),     # overlaps k1
          _ev("k1", "kernel", 70.0, 10.0),
          _ev("m", "gpu_memcpy", 95.0, 10.0),  # runs past the window
          _ev("k0", "kernel", -20.0, 10.0)]    # before it: left out
    r = trace.reduce(ev, {"env.step", "policy"})
    assert r["busy_s"] == pytest.approx(45e-6)   # 10-40, 70-80, 95-100
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["kernels"] == 3
    assert dict(r["device_ops"])["k1"] == pytest.approx(30e-6)
    assert "k0" not in dict(r["device_ops"])
    # idle 0-10 and 40-70 lie mostly inside env.step, 80-95 inside policy
    assert [n for n, _ in r["idle_gaps"]] == ["env.step", "policy",
                                              "env.step"]
    assert [g for _, g in r["idle_gaps"]] == pytest.approx(
        [30e-6, 15e-6, 10e-6])
