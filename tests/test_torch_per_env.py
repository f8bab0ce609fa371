"""Port parity: the per-env env path (``core/math3d``, ``sim/motor``,
``sim/contact``, the per-env ABA of ``sim/dynamics``, ``sim/robot``,
``envs/quadruped_env`` and ``envs/registry.make_env``) against the JAX
package's, and the vmapped per-env env against the port's batched env.

Tolerances: rtol 1e-4 with atol 1e-4 against JAX (float32 sums in another
order; the observation divides angles by 0.1); against the batched env the
bounds of the JAX package's own tests (``tests/test_sbatch.py:49-79``: q
2e-3, base position 5e-3, quaternion 2e-3; ``tests/test_batched_env.py``:
obs at reset 2e-3, ETG residual 1e-4), which hold the two physics
formulations (per-env Featherstone, batched SoA) to each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from paddlerobotics_tpu.core import config as jconfig
from paddlerobotics_tpu.core import math3d as jm
from paddlerobotics_tpu.envs import make_env as jmake_env
from paddlerobotics_tpu.envs import randomize as jrandomize
from paddlerobotics_tpu.sim import contact as jcontact
from paddlerobotics_tpu.sim import dynamics as jdyn
from paddlerobotics_tpu.sim import motor as jmotor
from paddlerobotics_tpu.sim import robot as jrobot
from paddlerobotics_tpu.sim import terrain as jterrain

from paddlerobotics_torch.core import config as tconfig
from paddlerobotics_torch.core import math3d as tm
from paddlerobotics_torch.core.types import QuadState
from paddlerobotics_torch.envs import make_env
from paddlerobotics_torch.envs import registry
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.envs.quadruped_env import EnvDraws, QuadrupedEnv
from paddlerobotics_torch.sim import contact as tcontact
from paddlerobotics_torch.sim import dynamics as tdyn
from paddlerobotics_torch.sim import motor as tmotor
from paddlerobotics_torch.sim import robot as trobot
from paddlerobotics_torch.sim import terrain as tterrain
from paddlerobotics_torch.sim.dynamics import DynamicsParams

from torch_parity import one_thread  # noqa: F401

RTOL = ATOL = 1e-4


def close(t, j, rtol=RTOL, atol=ATOL, err=""):
    np.testing.assert_allclose(np.asarray(t.detach().cpu().numpy()
                                          if isinstance(t, torch.Tensor)
                                          else t), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=err)


def assert_tree_close(t, j, **kw):
    """The port's NamedTuples against JAX's struct dataclasses of the same
    field order, leaf by leaf."""
    tl, jl = pytree.tree_leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            close(a, b, **kw)


# --- math3d -------------------------------------------------------------------

_R = np.random.RandomState(0)
_Q = _R.randn(5, 4).astype(np.float32)
_Q /= np.linalg.norm(_Q, axis=-1, keepdims=True)
_V = _R.randn(5, 3).astype(np.float32)
_W = np.concatenate([_R.randn(4, 3), np.zeros((1, 3))]).astype(np.float32)
_TH = _R.randn(5).astype(np.float32)

MATH_CASES = {
    "quat_mul": (lambda m: m.quat_mul, (_Q, _Q[::-1].copy())),
    "quat_rotate": (lambda m: m.quat_rotate, (_Q, _V)),
    "quat_rotate_inv": (lambda m: m.quat_rotate_inv, (_Q, _V)),
    "quat_to_mat": (lambda m: m.quat_to_mat, (_Q,)),
    "mat_to_quat": (lambda m: lambda q: m.mat_to_quat(m.quat_to_mat(q)),
                    (_Q,)),
    "quat_from_euler": (lambda m: m.quat_from_euler, (_V,)),
    "quat_to_euler": (lambda m: m.quat_to_euler, (_Q,)),
    "quat_integrate": (lambda m: lambda q, w: m.quat_integrate(q, w, 0.01),
                       (_Q, _W)),
    "skew": (lambda m: m.skew, (_V,)),
    "rot_x": (lambda m: m.rot_x, (_TH,)),
    "rot_y": (lambda m: m.rot_y, (_TH,)),
    "rot_z": (lambda m: m.rot_z, (_TH,)),
    "quat_normalize": (lambda m: m.quat_normalize, (2.0 * _Q,)),
    "cross": (lambda m: getattr(m, "cross", jnp.cross), (_V, _V[::-1].copy())),
}


@pytest.mark.parametrize("name", list(MATH_CASES))
def test_math3d_matches_jax(name):
    get, args = MATH_CASES[name]
    out_t = get(tm)(*[torch.as_tensor(a) for a in args])
    out_j = get(jm)(*[jnp.asarray(a) for a in args])
    close(out_t, out_j, err=name)


# --- motor --------------------------------------------------------------------

def test_motor_laws_match_jax():
    r = np.random.RandomState(1)
    cmd, q, qd = (r.randn(12).astype(np.float32) for _ in range(3))
    kp, kd = np.full(12, 80.0, np.float32), np.full(12, 1.5, np.float32)
    lim = np.full(12, 20.0, np.float32)
    hyb = r.randn(60).astype(np.float32) * 5
    t = torch.as_tensor
    close(tmotor.pd_torque(t(cmd), t(q), t(qd), t(kp), t(kd), t(lim), 0.9),
          jmotor.pd_torque(cmd, q, qd, kp, kd, lim, 0.9))
    close(tmotor.hybrid_torque(t(hyb), t(q), t(qd), t(lim)),
          jmotor.hybrid_torque(hyb, q, qd, lim))
    close(tmotor.torque_passthrough(t(cmd * 30), t(lim)),
          jmotor.torque_passthrough(cmd * 30, lim))
    close(tmotor.dc_motor_torque(t(cmd), t(qd * 40)),
          jmotor.dc_motor_torque(cmd, qd * 40))
    assert int(tmotor.MotorControlMode.HYBRID) == int(
        jmotor.MotorControlMode.HYBRID)


# --- contacts and the ABA -----------------------------------------------------

def _perturbed_state(seed, height=0.30):
    """A JAX QuadState off its rest pose (feet in and out of contact)."""
    r = np.random.RandomState(seed)
    st = jdyn.default_state(height=height)
    quat = np.asarray(st.base_quat) + 0.05 * r.randn(4)
    return st.replace(
        base_pos=st.base_pos + jnp.asarray(0.02 * r.randn(3), jnp.float32),
        base_quat=jnp.asarray(quat / np.linalg.norm(quat), jnp.float32),
        base_ang_vel=jnp.asarray(0.3 * r.randn(3), jnp.float32),
        base_lin_vel=jnp.asarray(0.2 * r.randn(3), jnp.float32),
        q=st.q + jnp.asarray(0.1 * r.randn(12), jnp.float32),
        qd=jnp.asarray(r.randn(12), jnp.float32))


def _mild_dyn(seed=4, scale=0.2):
    """A mild DR draw (a fifth of the range) in both packages."""
    jd = jrandomize.sample_dynamics(jax.random.key(seed), scale=scale)
    return jd, DynamicsParams(*[torch.as_tensor(np.array(getattr(jd, f)))
                                for f in DynamicsParams._fields])


def _qstate(js):
    return QuadState(*[torch.as_tensor(np.array(getattr(js, f)))
                       for f in QuadState._fields])


@pytest.mark.parametrize("mode", ["ground", "up_stair", "obstacle"])
def test_contacts_match_jax(mode):
    task = dict(task_mode=mode, terrain_start=0.0, step_height=0.27)
    jh = jterrain.height_fn(jconfig.TaskConfig(**task))
    th = tterrain.height_fn(tconfig.TaskConfig(**task))
    js = _perturbed_state(2, height=0.24)
    ts = _qstate(js)
    jd, td = _mild_dyn()
    jout = jcontact.compute_contacts(js, jdyn.world_poses(js), jh, jd,
                                     jconfig.SimConfig())
    tout = tcontact.compute_contacts(ts, tdyn.world_poses(ts), th, td,
                                     tconfig.SimConfig())
    assert bool(tout[0].in_contact.any()), "no foot in contact"
    assert_tree_close(tout, jout)


def test_forward_dynamics_matches_jax():
    js = _perturbed_state(3)
    ts = _qstate(js)
    jd, td = _mild_dyn()
    r = np.random.RandomState(5)
    tau = r.randn(12).astype(np.float32) * 5
    ff, kf = (r.randn(4, 3).astype(np.float32) * 20 for _ in range(2))
    bf = r.randn(3).astype(np.float32) * 10
    ja0, jqdd = jdyn.forward_dynamics(js, tau, ff, kf, bf, jd)
    t = torch.as_tensor
    ta0, tqdd = tdyn.forward_dynamics(ts, t(tau), t(ff), t(kf), t(bf), td)
    close(ta0, ja0, err="a0")
    close(tqdd, jqdd, err="qdd")
    poses_t, poses_j = tdyn.world_poses(ts), jdyn.world_poses(js)
    for k in poses_j:
        close(poses_t[k], poses_j[k], err=k)
    close(tdyn.foot_world_velocities(ts, poses_t),
          jdyn.foot_world_velocities(js, poses_j))
    close(tdyn.integrate(ts, ta0, tqdd, 0.002).base_quat,
          jdyn.integrate(js, ja0, jqdd, 0.002).base_quat)


# --- robot.control_step -------------------------------------------------------

@pytest.mark.parametrize("mode,sim_kw", [
    ("POSITION", {}),
    ("POSITION", {"pd_latency": 0.003, "enable_clip_motor_commands": True}),
    ("TORQUE", {}),
    ("HYBRID", {"on_rack": True}),
])
def test_control_step_matches_jax(mode, sim_kw):
    jcfg, tcfg = jconfig.SimConfig(**sim_kw), tconfig.SimConfig(**sim_kw)
    jh = jterrain.height_fn(jconfig.TaskConfig())
    th = tterrain.height_fn(tconfig.TaskConfig())
    jrb = jrobot.init_robot_state(jcfg, height=0.30)
    trb = trobot.init_robot_state(tcfg, height=0.30, device="cpu")
    assert_tree_close(trb, jrb)
    jd, td = _mild_dyn()
    r = np.random.RandomState(6)
    q0 = np.asarray(jrb.state.q)
    if mode == "TORQUE":
        act = (r.randn(12) * 3).astype(np.float32)
    elif mode == "HYBRID":
        a5 = np.stack([q0 + 0.1 * r.randn(12), np.full(12, 60.0),
                       r.randn(12), np.full(12, 1.0), r.randn(12)], axis=1)
        act = a5.reshape(60).astype(np.float32)
    else:
        act = (q0 + 0.2 * r.randn(12)).astype(np.float32)
    jmode = getattr(jmotor.MotorControlMode, mode)
    tmode = getattr(tmotor.MotorControlMode, mode)
    step = jax.jit(lambda rb, a: jrobot.control_step(rb, a, jd, jcfg, jh,
                                                     jmode))
    jrb = step(jrb, jnp.asarray(act))
    trb = trobot.control_step(trb, torch.as_tensor(act), td, tcfg, th, tmode)
    assert_tree_close(trb, jrb)


def test_delayed_interp_matches_jax():
    r = np.random.RandomState(7)
    hist = r.randn(32, 12).astype(np.float32)
    for lat in (0.0, 0.0017, 0.0061, 0.5):
        close(trobot.delayed_interp(torch.as_tensor(hist),
                                    torch.tensor(lat), 0.0026),
              jrobot.delayed_interp(jnp.asarray(hist), jnp.asarray(lat),
                                    0.0026), err=str(lat))


# --- the env ------------------------------------------------------------------

def _both(task="ground", random=None, **overrides):
    """The env in both packages; ``random`` sets RandomConfig fields, which
    make_env's overrides do not route (in either package)."""
    cfgs = [mod.QuadrupedConfig(random=mod.RandomConfig(**(random or {})))
            for mod in (jconfig, tconfig)]
    return (jmake_env("Quadrupedal", task=task, config=cfgs[0], **overrides),
            make_env("Quadrupedal", task=task, config=cfgs[1], device="cpu",
                     **overrides))


def _draws(js):
    """Reset draws carrying the JAX state's push salt (nothing else drawn)."""
    return EnvDraws(torch.zeros(48), torch.zeros(()), torch.zeros(3),
                    torch.as_tensor(np.array(js.push_salt)))


def _steps(jenv, tenv, js, ts, steps, seed=8, donef_at=None,
           autoreset=False):
    """Step both envs with the same seeded actions; compare every step."""
    jstep = jax.jit(jenv.step_autoreset if autoreset else jenv.step)
    tstep = tenv.step_autoreset if autoreset else tenv.step
    r = np.random.RandomState(seed)
    for i in range(steps):
        a = (0.2 * r.uniform(-1, 1, tenv.action_dim) * tenv.act_bound
             + tenv.act_offset).astype(np.float32)
        donef = donef_at == i
        js, jobs, jrew, jdone, jinfo = jstep(js, jnp.asarray(a), donef)
        ts, tobs, trew, tdone, tinfo = tstep(ts, torch.as_tensor(a), donef)
        assert bool(tdone) == bool(jdone)
        close(tobs, jobs, err=f"obs, step {i}")
        close(trew, jrew, err=f"reward, step {i}")
        for k in ("torso", "up", "feet", "tau", "velx", "success", "ETG_act"):
            close(tinfo[k], jinfo[k], err=f"{k}, step {i}")
        assert int(ts.step_idx) == int(js.step_idx)
    return ts, js


def _rollout(jenv, tenv, jd=None, td=None, steps=5, **kw):
    js, jobs = jenv.reset(jax.random.key(0), dyn=jd)
    ts, tobs = tenv.reset(dyn=td, draws=_draws(js))
    close(tobs, jobs, err="reset obs")
    return _steps(jenv, tenv, js, ts, steps, **kw)


def test_env_reset_and_step_match_jax():
    jenv, tenv = _both()
    assert tenv.obs_dim == jenv.obs_dim == 49
    np.testing.assert_array_equal(tenv.act_bound, jenv.act_bound)
    ts, js = _rollout(jenv, tenv)
    assert_tree_close(ts.robot, js.robot)


def test_env_mild_dr_pushes_filter_overheat_match_jax():
    """A mild DR draw injected with the dynamics echo in the observation;
    then from step 74 (pushes are active from step 75) with the action
    filter and the overheat latch."""
    jenv, tenv = _both(random={"random_force": True},
                       enable_action_filter=True,
                       motor_overheat_protection=True,
                       overheat_shutdown_torque=1.0,
                       overheat_shutdown_time=0.05, dynamic_vec=True)
    jd, td = _mild_dyn()
    _rollout(jenv, tenv, jd, td, steps=2)
    js, _ = jenv.reset(jax.random.key(0), dyn=jd)
    ts, _ = tenv.reset(dyn=td, draws=_draws(js))
    js = js.replace(step_idx=jnp.asarray(74, jnp.int32))
    ts = ts.replace(step_idx=torch.tensor(74, dtype=torch.int32))
    ts, js = _steps(jenv, tenv, js, ts, 3, seed=9)
    assert float(ts.dyn.external_force.abs().max()) > 0
    close(ts.dyn.external_force, js.dyn.external_force)
    np.testing.assert_array_equal(ts.motor_on.numpy(), np.asarray(js.motor_on))
    assert not bool(ts.motor_on.all())
    close(ts.filter_state, js.filter_state)


@pytest.mark.parametrize("mode", ["hybrid", "torque"])
def test_env_act_modes_match_jax(mode):
    jenv, tenv = _both(act_mode=mode)
    assert tenv.action_dim == jenv.action_dim
    _rollout(jenv, tenv, steps=3)


def test_env_step_autoreset_matches_jax():
    jenv, tenv = _both()
    ts, js = _rollout(jenv, tenv, steps=3, donef_at=1, autoreset=True)
    assert int(ts.step_idx) == 1


def test_reset_without_draws_raises():
    tenv = make_env("Quadrupedal", device="cpu", config=tconfig.QuadrupedConfig(
        random=tconfig.RandomConfig(random_dynamics=True)))
    with pytest.raises(ValueError, match="draws"):
        tenv.reset()
    # pushes: every episode needs a fresh salt (the JAX env draws one on
    # each reset), through reset and through the autoreset
    tenv = make_env("Quadrupedal", device="cpu", config=tconfig.QuadrupedConfig(
        random=tconfig.RandomConfig(random_force=True)))
    with pytest.raises(ValueError, match="random_force"):
        tenv.reset()
    g = torch.Generator().manual_seed(1)
    st, _ = tenv.reset(draws=tenv.sample_draws(g))
    with pytest.raises(ValueError, match="random_force"):
        tenv.step_autoreset(st, torch.zeros(12), donef=True)
    tenv = make_env("Quadrupedal", device="cpu", noise=True)
    with pytest.raises(ValueError, match="obs_noise"):
        tenv.reset()
    g = torch.Generator().manual_seed(0)
    st, obs = tenv.reset(obs_noise=tenv.sample_obs_noise(g))
    assert obs.shape == (49,)


# --- make_env -----------------------------------------------------------------

def test_make_env_routes_overrides_like_jax():
    kw = dict(reward_p=5.0, vel_d=0.5, act_mode="traj", step_y=0.05,
              beam_width=0.4, etg_obs=True, action_repeat=8, noise=True)
    jenv, tenv = _both("balance_beam", **kw)
    assert dataclasses.asdict(tenv.cfg) == dataclasses.asdict(jenv.cfg)
    assert tenv.cfg.task.task_mode == "balance_beam"
    cfg = tconfig.QuadrupedConfig(sim=tconfig.SimConfig(action_repeat=5))
    env = make_env(config=cfg, task="up_slope", device="cpu")
    assert env.cfg.sim.action_repeat == 5
    assert env.cfg.task.task_mode == "up_slope"
    assert isinstance(env, QuadrupedEnv) and env.device.type == "cpu"


def test_make_env_refuses_unknown_names():
    for make in (jmake_env, lambda *a, **k: make_env(*a, device="cpu", **k)):
        with pytest.raises(TypeError, match="no_such_field"):
            make("Quadrupedal", no_such_field=1)
        # RandomConfig's fields are not routed
        with pytest.raises(TypeError, match="random_force"):
            make("Quadrupedal", random_force=True)
        with pytest.raises(ValueError, match="unknown env"):
            make("Hexapod")


def test_register_env():
    seen = {}

    def factory(**kw):
        seen.update(kw)
        return "env"

    registry.register_env("Custom", factory)
    try:
        assert make_env("Custom", task="up_stair", device="cpu",
                        vel_d=0.3) == "env"
    finally:
        registry._ENV_REGISTRY.pop("Custom")
    assert seen == {"task": "up_stair", "config": None, "device": "cpu",
                    "vel_d": 0.3}


# --- vmapped per-env against the batched env ----------------------------------

def test_vmapped_per_env_matches_batched_env():
    """B envs through ``vmap(env.step)`` against the batched env from the
    same start with the same per-env actions, at the JAX tests' bounds."""
    B = 4
    env = make_env("Quadrupedal", device="cpu")
    benv = BatchedQuadrupedEnv(tconfig.QuadrupedConfig(), B, device="cpu")
    draws = env.sample_draws(torch.Generator().manual_seed(0), (B,))
    ps, pobs = vmap(lambda d: env.reset(draws=d))(draws)
    bs, bobs = benv.reset(torch.Generator().manual_seed(0))
    close(pobs, bobs, rtol=0, atol=2e-3, err="obs at reset")
    idx = torch.full((B,), 5, dtype=torch.int32)
    etg_b = benv._etg_residual(bs.etg_w, bs.etg_b, idx)[0]
    etg_p = vmap(env._etg_residual)(ps.etg_w, ps.etg_b, idx)[0]
    close(etg_p, etg_b.T, rtol=0, atol=1e-4, err="ETG residual")
    r = np.random.RandomState(10)
    step = vmap(env.step)
    for _ in range(5):
        a = torch.as_tensor(0.05 * r.randn(B, 12), dtype=torch.float32)
        ps, pobs, _, pdone, _ = step(ps, a)
        bs, bobs, _, bdone, _ = benv.step(bs, a)
        s = bs.robot.s
        close(ps.robot.state.q, s.q.T, rtol=0, atol=2e-3, err="q")
    close(ps.robot.state.base_pos, s.pos.T, rtol=0, atol=5e-3, err="pos")
    close(ps.robot.state.base_quat, s.quat.T, rtol=0, atol=2e-3, err="quat")
    assert not bool(pdone.any()) and not bool(bdone.any())
