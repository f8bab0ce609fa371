"""Port parity of ``utils/profiler``: the NaN checks in both packages
(forward and, in the port, backward), their switch, an env step under them,
and the Chrome trace of ``trace`` / ``annotate``; the port's spans: off they
record nothing, on they nest, count a collector pause as ``host.gc``, land
in a trace as ranges around the env step's operations, and leave the step
bit-equal.

The kernel wrappers' own checks (``control_step``, ``flash_attention``)
need the card: ``chip_smoke.py``'s ``[nan_checks]`` plants a fault inside
each kernel."""

import dataclasses
import gc
import glob
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddlerobotics_tpu.utils import profiler as jprofiler

from paddlerobotics_torch.core.config import (QuadrupedConfig, SimConfig,
                                              TaskConfig)
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.sim import sbatch, terrain
from paddlerobotics_torch.utils import profiler

from torch_parity import one_thread  # noqa: F401


@pytest.fixture
def nan_checks():
    """The port's NaN checks on for the test, off after it."""
    profiler.enable_nan_checks()
    try:
        yield
    finally:
        profiler.enable_nan_checks(False)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_nan_checks_raise_on_a_nan_making_op(package):
    if package == "jax":
        jprofiler.enable_nan_checks()
        try:
            with pytest.raises(FloatingPointError):
                jnp.log(jnp.float32(-1.0)).block_until_ready()
        finally:
            jprofiler.enable_nan_checks(False)
        assert not jax.config.jax_debug_nans
        return
    profiler.enable_nan_checks()
    try:
        assert torch.log(torch.tensor([2.0])).item() == pytest.approx(
            np.log(2.0))
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor([2.0, -1.0]))
    finally:
        profiler.enable_nan_checks(False)
    assert not profiler.nan_checks_on


def test_nan_checks_catch_a_backward_nan(nan_checks):
    # sqrt(x)·0 at x = 0 is 0 forward; its gradient is 0 / (2·sqrt(0))
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0.0).sum()
    assert y.item() == 0.0
    with pytest.raises(FloatingPointError, match="aten.div"):
        y.backward()


def test_nothing_raised_once_the_checks_are_off():
    profiler.enable_nan_checks()
    profiler.enable_nan_checks()                   # on twice: one mode
    profiler.enable_nan_checks(False)
    assert not profiler.nan_checks_on
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    x = torch.zeros(1, requires_grad=True)
    (torch.sqrt(x) * 0.0).sum().backward()
    assert torch.isnan(x.grad).all()
    profiler.enable_nan_checks(False)              # off twice: no error


def test_switching_off_under_another_mode_raises():
    class Other(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    profiler.enable_nan_checks()
    try:
        with Other():
            with pytest.raises(RuntimeError, match="another dispatch mode"):
                profiler.enable_nan_checks(False)
    finally:
        profiler.enable_nan_checks(False)
    assert not profiler.nan_checks_on


def _zero_mass(p: sbatch.BDynParams) -> sbatch.BDynParams:
    """Env 0 without base or leg mass: its articulated inertia is singular
    and the step makes NaN in that env alone."""
    base, leg = p.base_mass_scale.clone(), p.leg_mass_scale.clone()
    base[0] = 0.0
    leg[:, 0] = 0.0
    return p._replace(base_mass_scale=base, leg_mass_scale=leg)


def test_plain_physics_fault_raises_only_under_the_checks(nan_checks):
    B = 4
    rb = sbatch.init_robot(B, 0.27, hist_len=2)
    p = _zero_mass(sbatch.BDynParams.default(B))
    sim, h_fn = SimConfig(), terrain.height_fn(TaskConfig())
    with pytest.raises(FloatingPointError, match="aten"):
        sbatch.control_step(rb, rb.s.q.clone(), p, sim, h_fn)
    profiler.enable_nan_checks(False)
    out = sbatch.control_step(rb, rb.s.q.clone(), p, sim, h_fn)
    assert torch.isnan(out.s.q[:, 0]).all()
    assert not torch.isnan(out.s.q[:, 1:]).any()


def test_check_outputs_names_the_kernel():
    ok = [torch.zeros(3), torch.zeros(2, dtype=torch.int32)]
    profiler.check_outputs("control_step", ok)
    bad = ok + [torch.tensor([1.0, float("nan")])]
    with pytest.raises(FloatingPointError, match="control_step"):
        profiler.check_outputs("control_step", bad)
    # inf is not checked, as in JAX
    profiler.check_outputs("flash_attention", [torch.tensor([float("inf")])])


def test_env_step_under_the_checks_is_bit_equal():
    env = BatchedQuadrupedEnv(QuadrupedConfig(), 8, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0))
    act = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.2, 0.2, (8, 12)).astype(np.float32))

    def step():
        st = state.replace(rng=torch.Generator().manual_seed(5))
        ns, nobs, rew, done, _ = env.step(st, act)
        return [nobs, rew, done, ns.robot.s.q, ns.robot.obs_hist]

    ref = step()
    profiler.enable_nan_checks()
    try:
        got = step()
    finally:
        profiler.enable_nan_checks(False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trace_holds_the_annotated_range(tmp_path):
    with profiler.trace(str(tmp_path)) as path:
        for _ in range(2):
            with profiler.annotate("env_step"):
                torch.ones(16).sum()
    assert glob.glob(str(tmp_path / "*.pt.trace.json")) == [path]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "env_step"
              and e.get("cat") == "user_annotation"]
    assert len(ranges) == 2


# --- spans -------------------------------------------------------------------

PHASES = ("env.command", "env.etg", "env.physics", "env.reward",
          "env.autoreset", "env.observe")


@pytest.fixture
def spans():
    """The port's spans on for the test, off and emptied after it."""
    profiler.collect_spans()
    profiler.enable_spans(True)
    try:
        yield
    finally:
        profiler.enable_spans(False)
        profiler.collect_spans()


_ENVS = {}


def _env(regime):
    """A B=4 CPU env on flat ground or under DR (built once)."""
    if regime not in _ENVS:
        cfg = QuadrupedConfig()
        if regime == "dr":
            cfg = dataclasses.replace(cfg, random=dataclasses.replace(
                cfg.random, random_dynamics=True))
        _ENVS[regime] = BatchedQuadrupedEnv(cfg, 4, device="cpu")
    return _ENVS[regime]


def _one_step(env):
    state, _ = env.reset(torch.Generator().manual_seed(3))
    act = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.2, 0.2, (4, 12)).astype(np.float32))
    return env.step(state, act)


def test_spans_off_record_nothing_and_put_no_range_in_a_trace():
    from torch.profiler import ProfilerActivity

    assert not profiler.spans_on
    profiler.collect_spans()
    assert profiler.annotate("a") is profiler.annotate("b")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.annotate("env.step"):
            torch.ones(4).sum()
    assert profiler.collect_spans() == []
    assert [e.name for e in prof.events() if e.name == "env.step"] == []


def test_nested_spans_give_parent_root_and_self_time(spans, monkeypatch):
    clock = iter([0, 10, 30, 40, 45, 50, 70, 100, 200, 207])
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
    gc.disable()
    try:
        with profiler.annotate("root"):
            with profiler.annotate("a"):
                pass
            with profiler.annotate("b"):
                with profiler.annotate("c"):
                    pass
        with profiler.annotate("other"):
            pass
    finally:
        gc.enable()
    rec = {r.name: r for r in profiler.collect_spans()}
    root = rec["root"]
    assert (root.parent, root.root) == (0, root.id)
    assert rec["a"].parent == rec["b"].parent == root.id
    assert rec["c"].parent == rec["b"].id
    assert {rec[k].root for k in "abc"} == {root.id}
    assert rec["other"].root == rec["other"].id != root.id
    assert (root.start_ns, root.end_ns) == (0, 100)

    def self_ns(r):
        return r.end_ns - r.start_ns - sum(
            c.end_ns - c.start_ns for c in rec.values() if c.parent == r.id)

    assert [self_ns(rec[k]) for k in ("root", "a", "b", "c", "other")] == [
        100 - 20 - 30, 20, 30 - 5, 5, 7]


def test_a_collection_under_spans_is_a_host_gc_span(spans):
    with profiler.annotate("outer"):
        gc.collect(1)
    rec = profiler.collect_spans()
    pauses = [r for r in rec if r.name == "host.gc"]
    outer = [r for r in rec if r.name == "outer"][0]
    assert [(r.generation, r.parent, r.root) for r in pauses] == [
        (1, outer.id, outer.id)]
    assert outer.start_ns <= pauses[0].start_ns < pauses[0].end_ns <= \
        outer.end_ns
    profiler.enable_spans(False)
    assert profiler._gc_hook not in gc.callbacks
    gc.collect(0)
    assert profiler.collect_spans() == []


def test_the_env_steps_phases_enclose_its_operations_in_a_trace(tmp_path):
    env = _env("flat")
    with profiler.trace(str(tmp_path)) as path:
        _one_step(env)
    assert not profiler.spans_on and profiler.collect_spans() == []
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "cpu_op"]
    (s0, s1), = ranges["env.step"]
    assert sorted(n for n in ranges if n.startswith("env.")) == sorted(
        PHASES + ("env.step",))
    assert len(ranges["env.etg"]) == len(ranges["env.command"]) == 2
    for name in PHASES:
        for a, b in ranges[name]:
            assert s0 <= a <= b <= s1, name
            assert any(a <= o0 and o1 <= b for o0, o1 in ops), name
    inside = [(o0, o1) for o0, o1 in ops if s0 <= o0 < s1]
    assert inside and all(o1 <= s1 for _, o1 in inside)


@pytest.mark.parametrize("regime", ["flat", "dr"])
def test_env_step_under_spans_is_bit_equal(regime):
    env = _env(regime)

    def step():
        ns, nobs, rew, done, info = _one_step(env)
        return ([nobs, rew, done, ns.robot.s.q, ns.robot.obs_hist,
                 ns.rng.get_state()] + list(ns.dyn) + list(info.values()))

    ref = step()
    profiler.enable_spans(True)
    try:
        got = step()
    finally:
        profiler.enable_spans(False)
    rec = [r for r in profiler.collect_spans() if r.name != "host.gc"]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    root, = [r for r in rec if r.name == "env.step"]
    assert {r.root for r in rec if r.name.startswith("env.")} == {root.id}
    assert {r.name for r in rec if r.parent == root.id} == set(PHASES)
