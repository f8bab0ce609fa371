"""Port parity of ``cli/env_bench`` (``bench.py`` and the long-ring probe)
and of ``graft_entry.entry`` (``__graft_entry__.entry``).

The bench's timed rollout at B=8, 3 zero-action control steps, in both
regimes, from the JAX env's reset state carried over (its dynamics and push
salt handed to the port's ``reset``), against JAX's ``env.step`` scanned
over the same zero actions: obs, reward and state agree at the env tests'
tolerance (1e-4, test_torch_env). Under DR the dynamics are the env tests'
mild draw (a fifth of the DR range, injected into both resets): at the full
range one observation element of 392 drifts to 8.1e-4 within 3 steps, the
contact dynamics amplifying last-bit differences as test_torch_env
describes. The ring length equals the JAX
env's in each regime, and the CLI's lines parse to their schema. One step
of ``entry()`` at B=256 against ``__graft_entry__.entry()`` itself, the
actor carried by ``convert.actor_from_flax``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from paddlerobotics_tpu.core import config as jconfig
from paddlerobotics_tpu.envs import randomize as jrandomize
from paddlerobotics_tpu.envs.batched_env import BatchedQuadrupedEnv as JEnv
from paddlerobotics_tpu.sim import sbatch as jsb

from paddlerobotics_torch import convert, graft_entry
from paddlerobotics_torch.cli import env_bench
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

from torch_parity import dyn_np, one_thread  # noqa: F401

B = 8
STEPS = 3
ATOL = RTOL = 1e-4
DR_SCALE = 0.2          # test_torch_env's mild draw


def _jax_config(regime: str):
    cfg = jconfig.QuadrupedConfig()
    if regime == "dr_long_ring":
        cfg = dataclasses.replace(cfg, random=dataclasses.replace(
            cfg.random, random_dynamics=True))
    return cfg


@pytest.mark.parametrize("regime", env_bench.REGIMES)
def test_timed_rollout_matches_jax_scan(regime):
    jenv = JEnv(_jax_config(regime), num_envs=B)
    dyn = None
    if regime == "dr_long_ring":
        keys = jax.random.split(jax.random.key(11), B)
        dyn = jsb.BDynParams.from_leading(jax.vmap(
            lambda k: jrandomize.sample_dynamics(k, scale=DR_SCALE))(keys))
    js, jobs = jenv.reset(jax.random.key(0), dyn=dyn)

    def scan(s):
        def body(s, _):
            ns, obs, rew, done, _ = jenv.step(s, jnp.zeros((B, 12)))
            return ns, (obs, rew, done)
        return jax.lax.scan(body, s, None, length=STEPS)

    js_n, (jobs_n, jrew, jdone) = jax.jit(scan)(js)

    env = BatchedQuadrupedEnv(env_bench.regime_config(regime), B,
                              device="cpu")
    assert env._hist_len == jenv._hist_len
    ts, tobs = env.reset(torch.Generator().manual_seed(0),
                         dyn=convert.dyn_from_numpy(dyn_np(js.dyn),
                                                    device="cpu"),
                         push_salt=int(js.push_salt))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=ATOL,
                               rtol=RTOL)
    out = env_bench.timed_rollout(env, ts, STEPS, 1)
    ts_n, tobs_n, trew, tdone = out["final"]
    assert out["event_ms"] is None and out["env_steps_per_s"] > 0
    assert not bool(tdone.any())
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone[-1]))
    np.testing.assert_allclose(tobs_n.numpy(), np.asarray(jobs_n[-1]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew[-1]), atol=ATOL,
                               rtol=RTOL)
    for f in ("pos", "quat", "w", "v", "q", "qd"):
        np.testing.assert_allclose(
            getattr(ts_n.robot.s, f).numpy(),
            np.asarray(getattr(js_n.robot.s, f)), atol=ATOL, rtol=RTOL,
            err_msg=f)
    np.testing.assert_array_equal(ts_n.step_idx.numpy(),
                                  np.asarray(js_n.step_idx))
    assert ts_n.robot.obs_hist.shape == js_n.robot.obs_hist.shape


def test_warm_up_leaves_the_timed_rollout_unchanged():
    """The warm-up runs on a copy of the generator: the timed rollout is
    the rollout from the given state, autoreset draws included."""
    env = BatchedQuadrupedEnv(env_bench.regime_config("dr_long_ring"), 4,
                              device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(3))
    # every env falls at its first step: autoreset draws fresh dynamics
    pos = state.robot.s.pos.clone()
    pos[2] = 0.05
    state = state.replace(robot=state.robot.replace(
        s=state.robot.s.replace(pos=pos)))
    gen_state = state.rng.get_state()
    got = env_bench.timed_rollout(env, state, 2, 1)["final"]
    state.rng.set_state(gen_state)
    want = env_bench.rollout(env, state, 1)
    assert bool(want[3].all())
    state.rng.set_state(gen_state)
    want = env_bench.rollout(env, state, 2)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(got[0].dyn.motor_kp, want[0].dyn.motor_kp,
                               rtol=0, atol=0)


def test_cli_prints_the_bench_lines(capsys):
    lines = env_bench.main(["--num_envs", "4", "--steps", "2", "--reps", "1",
                            "--regime", "both", "--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines and len(lines) == 4
    no_dr, dr, ratio, metric = lines
    for line, regime, ring in ((no_dr, "no_dr", 2), (dr, "dr_long_ring", 40)):
        assert line["regime"] == regime and line["ring_len"] == ring
        assert line["env_steps_per_s"] > 0 and line["control_steps"] == 2
        assert line["num_envs"] == 4 and line["event_ms_per_step"] is None
    # from the printed rates, as the long-ring probe computes it
    assert ratio["dr_over_nodr"] == round(
        dr["env_steps_per_s"] / no_dr["env_steps_per_s"], 4)
    # a CPU rate is not a per-chip metric
    assert metric == {"metric": "a1_env_steps_per_sec_cpu_4envs",
                      "value": no_dr["env_steps_per_s"],
                      "unit": "env_steps/s",
                      "device": {"name": "cpu", "power_limit": None}}
    assert "vs_baseline" not in metric


def test_cli_default_regime_is_bench_py(capsys):
    lines = env_bench.main(["--num_envs", "2", "--steps", "1", "--reps", "1",
                            "--device", "cpu"])
    assert [set(x) for x in lines] == [
        {"regime", "env_steps_per_s", "ring_len", "num_envs",
         "control_steps", "host_ms_per_step", "event_ms_per_step"},
        {"metric", "value", "unit", "device"}]
    assert lines[0]["regime"] == "no_dr"


def test_unknown_regime_raises():
    with pytest.raises(ValueError, match="unknown regime"):
        env_bench.regime_config("dr")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_entry_matches_jax_entry():
    jfn, (js, jparams, jobs) = __graft_entry__.entry()
    jout = jax.jit(jfn)(js, jparams, jobs)
    n = jobs.shape[0]
    fn, (state, actor, obs) = graft_entry.entry(n, device="cpu")
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(state.robot.s.q.numpy(),
                                  np.asarray(js.robot.s.q))
    assert isinstance(actor, torch.nn.Module)
    actor = convert.actor_from_flax(_np(jparams), device="cpu")
    out = fn(state, actor, torch.as_tensor(np.array(jobs)))
    assert [tuple(o.shape) for o in out] == [
        tuple(np.shape(o)) for o in jout]
    assert not any(o.requires_grad for o in out)
    for got, want, name in zip(out, jout, ("obs", "rew", "done", "pos")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    assert graft_entry.dryrun_multichip.__module__ == \
        "paddlerobotics_torch.parallel.dryrun"
