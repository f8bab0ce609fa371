"""Port parity of ``utils/profiler``: ``StepTimer`` against the JAX
package's on one injected clock, the NaN checks in both packages (forward
and, in the port, backward), their switch, an env step under them, and the
Chrome trace of ``trace`` / ``annotate``.

The kernel wrappers' own checks (``control_step``, ``flash_attention``)
need the card: ``chip_smoke.py``'s ``[nan_checks]`` plants a fault inside
each kernel."""

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


def test_step_timer_matches_jax(monkeypatch):
    clock = [0.0, 0.013, 0.029, 0.030, 0.051, 0.0515, 0.09]
    steps = [1, 4096, 4096, 7, 4096, 1, 300]
    out = {}
    for name, mod in (("jax", jprofiler), ("torch", profiler)):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(ema=0.8)
        out[name] = [timer.tick(n) for n in steps]
    assert out["torch"][0] == 0.0 and out["torch"][-1] > 0.0
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-12)


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
