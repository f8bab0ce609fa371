"""Port parity: the batched env against the JAX package's (use_pallas=False).

Both envs start from matched state (the JAX push salt and dynamics are
handed to the port's ``reset``) and take the same seeded actions; reset
obs, then obs, reward and done over 5 steps must agree to 1e-4. Error
compounds over the 50 substeps of 5 control steps (the physics agrees to
1e-5 per step, see test_torch_physics), and the observation divides
angles by 0.1, so 1e-4 is the tolerance here.

Each JAX configuration compiles its step once; independent features
share a configuration to keep the count small.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.core import config as jconfig
from paddlerobotics_tpu.envs import randomize as jrandomize
from paddlerobotics_tpu.envs.batched_env import BatchedQuadrupedEnv as JEnv
from paddlerobotics_tpu.etg import fit as jfit
from paddlerobotics_tpu.sim import sbatch as jsb

from paddlerobotics_torch import convert
from paddlerobotics_torch.core import config as tconfig
from paddlerobotics_torch.envs import randomize
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.etg import fit

from torch_parity import dyn_np

B = 8
STEPS = 5
ATOL = 1e-4
OBS_RTOL = 1e-4


def _configs(**sections):
    """The same QuadrupedConfig in both packages from {section: {field: v}}."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.QuadrupedConfig()
        for sec, kw in sections.items():
            cfg = dataclasses.replace(
                cfg, **{sec: dataclasses.replace(getattr(cfg, sec), **kw)})
        out.append(cfg)
    return out


def _rollout(sections, dyn_scale=None, start_idx=0, donef_at=None):
    """Reset and step both envs; compare at every step. Returns the final
    port state."""
    jcfg, tcfg = _configs(**sections)
    jenv = JEnv(jcfg, B)
    tenv = BatchedQuadrupedEnv(tcfg, B, device="cpu")
    dyn_j = None
    if dyn_scale is not None:
        keys = jax.random.split(jax.random.key(11), B)
        dyn_j = jsb.BDynParams.from_leading(jax.vmap(
            lambda k: jrandomize.sample_dynamics(k, scale=dyn_scale))(keys))
    js, jobs = jenv.reset(jax.random.key(3), dyn=dyn_j)
    ts, tobs = tenv.reset(
        torch.Generator().manual_seed(3), push_salt=int(js.push_salt),
        dyn=None if dyn_j is None else convert.dyn_from_numpy(dyn_np(dyn_j)))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=ATOL)
    assert ts.robot.obs_hist.shape == js.robot.obs_hist.shape
    if start_idx:
        js = js.replace(step_idx=jnp.full((B,), start_idx, jnp.int32))
        ts.step_idx = torch.full((B,), start_idx, dtype=torch.int32)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(5)
    bound, offset = tenv.act_bound, tenv.act_offset
    np.testing.assert_array_equal(bound, jenv.act_bound)
    for i in range(STEPS):
        a = rng.uniform(-1, 1, (B, tenv.action_dim)).astype(np.float32)
        act = (0.2 * a * bound + offset).astype(np.float32)
        donef = np.zeros(B, bool)
        if donef_at is not None and i == donef_at:
            donef[::2] = True
        js, jobs, jrew, jdone, jinfo = jstep(js, jnp.asarray(act),
                                             jnp.asarray(donef))
        ts, tobs, trew, tdone, tinfo = tenv.step(ts, torch.as_tensor(act),
                                                 torch.as_tensor(donef))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=ATOL,
                                   err_msg=f"reward, step {i}")
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=ATOL,
                                   rtol=OBS_RTOL, err_msg=f"obs, step {i}")
        for k in ("torso", "up", "feet", "tau", "velx", "success"):
            np.testing.assert_allclose(tinfo[k].numpy(),
                                       np.asarray(jinfo[k]), atol=ATOL,
                                       err_msg=k)
        np.testing.assert_array_equal(ts.step_idx.numpy(),
                                      np.asarray(js.step_idx))
    return ts, js


def test_default_env_and_forced_autoreset():
    ts, js = _rollout({}, donef_at=3)
    # the forced envs restarted: two steps since the reset at step 3
    assert ts.step_idx.tolist() == [1, 5] * (B // 2)


def test_pushes_filter_and_overheat():
    """random_force (pushes active from step 75), the Butterworth action
    filter and the overheat latch in one configuration."""
    ts, js = _rollout(
        {"random": {"random_force": True},
         "train": {"enable_action_filter": True},
         "sim": {"motor_overheat_protection": True,
                 "overheat_shutdown_torque": 1.0,
                 "overheat_shutdown_time": 0.05}},
        start_idx=74)
    assert float(ts.dyn.external_force.abs().max()) > 0
    np.testing.assert_allclose(ts.dyn.external_force.numpy(),
                               np.asarray(js.dyn.external_force), atol=1e-5)
    np.testing.assert_array_equal(ts.motor_on.numpy(), np.asarray(js.motor_on))
    assert not bool(ts.motor_on.all())
    np.testing.assert_allclose(ts.filter_z.numpy(), np.asarray(js.filter_z),
                               atol=ATOL)


def test_domain_randomization_long_ring():
    """DR with the JAX draws injected: full-ring policy-obs latency blend
    over L=40 and the dynamics echo in the observation. The draw is mild
    (a fifth of the DR range): at half range the dynamics amplify last-bit
    differences past the tolerance within 5 steps (2.4e-4 measured), and
    the physics under wider draws is held over two steps in
    test_torch_physics."""
    ts, js = _rollout({"random": {"random_dynamics": True},
                       "sensors": {"dynamic_vec": True}}, dyn_scale=0.2)
    assert ts.robot.obs_hist.shape[0] == 40


@pytest.mark.parametrize("mode", ["hybrid", "torque"])
def test_act_modes(mode):
    _rollout({"train": {"act_mode": mode}})


def test_sample_dynamics_matches_jax():
    """The port's batched DR draw on JAX's uniform draws (jitter off and
    on) equals the JAX per-env sampler, and the echo inverts it."""
    keys = jax.random.split(jax.random.key(2), B)
    for jitter in (False, True):
        ref = jax.vmap(lambda k: jrandomize.sample_dynamics(
            k, scale=0.7, jitter=jitter))(keys)
        u, ju = [], []
        for k in keys:
            if jitter:
                k, ks = jax.random.split(k)
                ju.append(float(jax.random.uniform(ks, ())))
            u.append(np.asarray(jax.random.uniform(
                k, (48,), minval=-1.0, maxval=1.0)))
        got = randomize.sample_dynamics(
            B, scale=0.7, jitter=jitter, u=np.stack(u),
            jitter_u=np.asarray(ju, np.float32) if jitter else None)
        want = jsb.BDynParams.from_leading(ref)
        for f in jsb.BDynParams._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       atol=1e-5, err_msg=f)
        np.testing.assert_allclose(
            randomize.dynamics_to_normalized(got).numpy(),
            np.asarray(jrandomize.dynamics_to_normalized(want)), atol=1e-5)


def test_etg_residual_and_fit_match_jax():
    jcfg, tcfg = _configs()
    jenv, tenv = JEnv(jcfg, B), BatchedQuadrupedEnv(tcfg, B, device="cpu")
    w_j, b_j = jfit.opt_with_points(jcfg.etg)
    w_t, b_t = fit.opt_with_points(tcfg.etg, device="cpu")
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-6)
    np.testing.assert_allclose(fit.prior_points(tcfg.etg),
                               jfit.prior_points(jcfg.etg))
    # a proximal refit from perturbed control points
    pts = jfit.prior_points(jcfg.etg) + 0.01 * np.arange(12).reshape(6, 2)
    w2_j, b2_j = jfit.opt_with_points(jcfg.etg, jnp.asarray(pts), w_j, b_j)
    w2_t, b2_t = fit.opt_with_points(
        tcfg.etg, torch.as_tensor(pts, dtype=torch.float32), w_t, b_t)
    np.testing.assert_allclose(w2_t.numpy(), np.asarray(w2_j), atol=1e-5)
    np.testing.assert_allclose(b2_t.numpy(), np.asarray(b2_j), atol=1e-6)
    w, b = tenv.default_etg()
    jw, jb = jenv.default_etg()
    idx = np.array([0, 1, 7, 19, 20, 38, 77, 599], np.int32)
    ej = jenv._etg_residual(jw, jb, jnp.asarray(idx))
    et = tenv._etg_residual(w, b, torch.as_tensor(idx))
    np.testing.assert_allclose(et[0].numpy(), np.asarray(ej[0]), atol=1e-5)
    for a, c in zip(et[1:3], ej[1:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    np.testing.assert_allclose(et[3].numpy(), np.asarray(ej[3]), atol=1e-5)
