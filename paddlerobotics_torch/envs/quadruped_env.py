"""The per-env A1 quadruped environment (port of the JAX package's
``envs/quadruped_env.py``, the functional ``rlschool.make_env``).

``reset`` / ``step`` / ``step_autoreset`` are pure functions of one env's
``EnvState``; a batch runs under ``torch.func.vmap``, as the JAX env runs
under ``jax.vmap``:

    env = make_env("Quadrupedal", task="ground")           # on cuda
    draws = env.sample_draws(generator, batch=(64,))
    state, obs = torch.func.vmap(lambda d: env.reset(draws=d))(draws)
    state, obs, rew, done, info = torch.func.vmap(env.step)(state, actions)

Randomness is drawn outside the vmapped functions: ``EnvDraws`` holds one
reset's draws (the dynamics' uniforms, the spawn jitter, the push salt) and
``obs_noise`` an observation's sensor-noise normals, each made by
``sample_draws`` / ``sample_obs_noise`` from an explicit
``torch.Generator``. The JAX env folds them out of a key carried in its
state (``fold_in``); threefry keys and torch generators never give the same
numbers, so a caller that must reproduce a JAX run injects the draws. A
reset that needs a draw it was not given raises.

The physics is the per-env Featherstone path (``sim/robot.py``); the
batched env (``envs/batched_env.py``) runs the same model through the
physics kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from paddlerobotics_torch.core import math3d
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.core.types import RobotState
from paddlerobotics_torch.envs import action_filter as af
from paddlerobotics_torch.envs import randomize, sensors
from paddlerobotics_torch.envs import reward as reward_mod
from paddlerobotics_torch.etg import fit as etg_fit
from paddlerobotics_torch.etg import model as etg_model
from paddlerobotics_torch.sim import a1_model as a1
from paddlerobotics_torch.sim import robot as robot_mod
from paddlerobotics_torch.sim import terrain
from paddlerobotics_torch.sim.dynamics import DynamicsParams
from paddlerobotics_torch.sim.motor import MotorControlMode

MAX_EPISODE_STEPS = 2048
_INT32_MAX = 2 ** 31 - 1


class EnvState(NamedTuple):
    robot: RobotState
    dyn: DynamicsParams
    etg_w: torch.Tensor        # (3,H)
    etg_b: torch.Tensor        # (3,)
    step_idx: torch.Tensor     # () int32
    last_base_pos: torch.Tensor
    init_rpy: torch.Tensor
    filter_state: torch.Tensor  # (2,12) Butterworth carry
    done: torch.Tensor          # () bool
    push_salt: torch.Tensor     # () int32 seed for burst-indexed pushes
    oh_counter: torch.Tensor    # (12,) consecutive over-torque steps
    motor_on: torch.Tensor      # (12,) bool overheat latch

    def replace(self, **kw) -> "EnvState":
        return self._replace(**kw)


class EnvDraws(NamedTuple):
    """One reset's randomness, drawn outside the vmapped functions."""

    dyn_u: torch.Tensor       # (48,) uniform [-1, 1): the dynamics draw
    dyn_jitter: torch.Tensor  # () uniform [0, 1): the DR scale jitter
    x_noise: torch.Tensor     # (3,) standard normal: the spawn jitter
    push_salt: torch.Tensor   # () int32: the push-burst salt


def _select(cond: torch.Tensor, a, b):
    """``where(cond, a, b)`` leaf by leaf over two pytrees of one env."""
    la, spec = pytree.tree_flatten(a)
    lb, _ = pytree.tree_flatten(b)
    return pytree.tree_unflatten(
        [torch.where(cond.reshape((1,) * x.ndim), x, y)
         for x, y in zip(la, lb)], spec)


class QuadrupedEnv:
    """Static config and precomputed tables on ``device`` (the card unless
    it says otherwise); every method is a pure function of its inputs."""

    def __init__(self, config: QuadrupedConfig, device=None):
        self.cfg = config
        self.device = resolve_device(device)
        dev = self.device
        self.h_fn = terrain.height_fn(config.task)
        # pairing='auto' -> bound for the gallop task, trot otherwise
        self._etg_cfg = etg_model.resolve_pairing(config.etg,
                                                  config.task.task_mode)
        self._w0, self._b0 = etg_fit.opt_with_points(config.etg, device=dev)
        self._va, self._vb = etg_model.phase_tables(
            config.etg, MAX_EPISODE_STEPS, device=dev)
        self._filter_b, self._filter_a = af.butter_lowpass_coeffs(
            1.0 / config.sim.control_dt)
        mode = config.train.act_mode
        self.act_offset = np.zeros(12)
        if mode == "pose":
            self.act_bound = np.array([0.1, 0.7, 0.7] * 4)
        elif mode == "torque":
            self.act_bound = np.array([10.0] * 12)
        elif mode == "hybrid":
            # (pos, kp, q̇*, kd, τ_ff) per motor, as the batched env
            kp0 = np.asarray(a1.MOTOR_KP)
            kd0 = np.asarray(a1.MOTOR_KD)
            self.act_bound = np.stack([
                np.full(12, config.train.act_bound), 0.5 * kp0,
                np.full(12, 2.0), 0.5 * kd0, np.full(12, 5.0)],
                axis=1).reshape(60)
            self.act_offset = np.stack([
                np.zeros(12), kp0, np.zeros(12), kd0, np.zeros(12)],
                axis=1).reshape(60)
        else:  # traj
            self.act_bound = np.array([config.train.act_bound] * 12)
        self.control_mode = {
            "torque": MotorControlMode.TORQUE,
            "hybrid": MotorControlMode.HYBRID,
        }.get(mode, MotorControlMode.POSITION)
        self._spawn_height = 0.27

    # -- helpers -------------------------------------------------------------

    @property
    def obs_dim(self) -> int:
        return self.cfg.sensors.base_obs_dim

    @property
    def action_dim(self) -> int:
        return 60 if self.control_mode == MotorControlMode.HYBRID else 12

    def default_etg(self):
        return self._w0, self._b0

    def _table_row(self, table: torch.Tensor, step_idx) -> torch.Tensor:
        i = torch.as_tensor(step_idx, device=table.device).to(torch.int64)
        return torch.index_select(table, 0, (i % MAX_EPISODE_STEPS)
                                  .reshape(1))[0]

    def _etg_residual(self, etg_w, etg_b, step_idx):
        v_a = self._table_row(self._va, step_idx)
        v_b = self._table_row(self._vb, step_idx)
        act = etg_model.etg_joint_residual(etg_w, etg_b, v_a, v_b,
                                           self._etg_cfg)
        # gait phase mask from the readout z-delta of each leg
        d = etg_model.foot_deltas(etg_w, etg_b, v_a, v_b, self._etg_cfg)
        swing = d[:, 2] > 0.02
        stance = d[:, 2] <= 0.005
        return act, swing, stance, v_a

    # -- randomness, drawn outside vmap --------------------------------------

    def sample_draws(self, generator: torch.Generator,
                     batch: tuple = ()) -> EnvDraws:
        """``EnvDraws`` with leading shape ``batch`` from ``generator`` (on
        its device)."""
        dev = generator.device
        return EnvDraws(
            dyn_u=torch.rand(batch + (randomize.NUM_DYNAMIC_PARAMS,),
                             generator=generator, device=dev) * 2.0 - 1.0,
            dyn_jitter=torch.rand(batch, generator=generator, device=dev),
            x_noise=torch.randn(batch + (3,), generator=generator,
                                device=dev),
            push_salt=torch.randint(0, _INT32_MAX, batch,
                                    generator=generator, device=dev,
                                    dtype=torch.int32))

    def sample_obs_noise(self, generator: torch.Generator,
                         batch: tuple = ()) -> torch.Tensor:
        """Standard normals of an observation's sensor noise,
        ``batch + (sensors.NOISE_DIM,)``."""
        return torch.randn(batch + (sensors.NOISE_DIM,),
                           generator=generator, device=generator.device)

    # -- reset ---------------------------------------------------------------

    def reset(self, etg_w: Optional[torch.Tensor] = None,
              etg_b: Optional[torch.Tensor] = None,
              dyn: Optional[DynamicsParams] = None,
              x_noise: bool = False,
              draws: Optional[EnvDraws] = None,
              obs_noise: Optional[torch.Tensor] = None
              ) -> Tuple[EnvState, torch.Tensor]:
        """Fresh episode (env.reset(ETG_w, ETG_b, x_noise)). ``dyn`` None
        draws the dynamics from ``draws`` under ``random_dynamics`` and
        takes the nominal ones otherwise. Under ``random_force`` every
        episode takes a fresh push salt from ``draws`` (the JAX env draws
        one on every reset), so a reset without them raises; elsewhere the
        salt is unused and 0 without ``draws``."""
        dev = self.device
        rnd = self.cfg.random
        if rnd.random_force and draws is None:
            raise ValueError("random_force: reset needs draws "
                             "(QuadrupedEnv.sample_draws) for the episode's "
                             "push salt")
        if etg_w is None or etg_b is None:
            etg_w, etg_b = self.default_etg()
        if dyn is None:
            if rnd.random_dynamics:
                if draws is None:
                    raise ValueError("random_dynamics: reset needs draws "
                                     "(QuadrupedEnv.sample_draws) or dyn")
                dyn = randomize.sample_dynamics_env(
                    draws.dyn_u, draws.dyn_jitter, rnd.dynamics_scale,
                    rnd.dr_scale_jitter)
            else:
                dyn = DynamicsParams.default(device=dev)

        h0 = self.h_fn(torch.zeros((), device=dev), torch.zeros((), device=dev))
        rb = robot_mod.init_robot_state(self.cfg.sim,
                                        height=self._spawn_height + h0)
        if x_noise:
            if draws is None:
                raise ValueError("x_noise: reset needs draws "
                                 "(QuadrupedEnv.sample_draws)")
            dx = 0.02 * draws.x_noise
            rb = rb.replace(state=rb.state.replace(
                base_pos=rb.state.base_pos + dx * a1._c([1.0, 1.0, 0.0], dx)))
        salt = (draws.push_salt if draws is not None else
                torch.zeros((), dtype=torch.int32, device=dev))
        state = EnvState(
            robot=rb, dyn=dyn, etg_w=etg_w, etg_b=etg_b,
            step_idx=torch.zeros((), dtype=torch.int32, device=dev),
            last_base_pos=rb.state.base_pos,
            init_rpy=math3d.quat_to_euler(rb.state.base_quat),
            filter_state=af.init_filter_state(
                self._filter_b, self._filter_a, rb.state.q),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            push_salt=salt,
            oh_counter=torch.zeros(12, device=dev),
            motor_on=torch.ones(12, dtype=torch.bool, device=dev))
        etg_act, _, _, _ = self._etg_residual(etg_w, etg_b, state.step_idx)
        return state, self._observe(state, etg_act, obs_noise)

    # -- observation ---------------------------------------------------------

    def _observe(self, state: EnvState, etg_act: torch.Tensor,
                 obs_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg.sensors
        rb = state.robot
        st = rb.state
        R_b = math3d.quat_to_mat(st.base_quat)
        base_vel_w = R_b @ st.base_lin_vel
        # The reference delays the FULL policy observation — q, qd, base
        # quat and rpy-rate — at control_latency over the substep ring.
        sdt = self.cfg.sim.substep_dt
        lat = state.dyn.control_latency
        q_obs = robot_mod.delayed_interp(rb.q_hist, lat, sdt)
        qd_obs = robot_mod.delayed_interp(rb.qd_hist, lat, sdt)
        quat_obs = robot_mod.delayed_interp(rb.quat_hist, lat, sdt)
        # the linear blend shrinks the norm slightly: renormalize first
        quat_obs = quat_obs / torch.linalg.norm(quat_obs)
        rpy = math3d.quat_to_euler(quat_obs) - state.init_rpy
        drpy = robot_mod.delayed_interp(rb.w_hist, lat, sdt)
        foot_pose = (a1.foot_positions_in_base_frame(st.q)
                     if cfg.footpose else None)
        etg_features = (self._table_row(self._va, state.step_idx)
                        if cfg.etg_obs else None)
        if cfg.noise and obs_noise is None:
            raise ValueError("SensorConfig.noise: pass obs_noise "
                             "(QuadrupedEnv.sample_obs_noise)")
        dyn_vec = (randomize.dynamics_to_normalized_env(state.dyn)
                   if cfg.dynamic_vec else None)
        return sensors.assemble_obs(
            cfg, base_vel_w, rb.contact.in_contact, rpy, drpy,
            q_obs, qd_obs, etg_act,
            etg_features=etg_features, foot_pose=foot_pose,
            dynamic_vec=dyn_vec,
            ext_force=state.dyn.external_force, noise=obs_noise)

    # -- step ----------------------------------------------------------------

    def step(self, state: EnvState, action: torch.Tensor,
             donef=False, obs_noise: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor,
                        Dict[str, torch.Tensor]]:
        """One control step. ``action`` is the *scaled* policy action (the
        caller multiplies by act_bound, as train.py:147 does)."""
        cfg = self.cfg
        dev = action.device
        etg_act, swing, stance, _ = self._etg_residual(
            state.etg_w, state.etg_b, state.step_idx)
        q0 = a1._c(a1.INIT_MOTOR_ANGLES, action)
        lo, hi = a1._c(a1.MOTOR_LOWER, action), a1._c(a1.MOTOR_UPPER, action)

        if self.control_mode == MotorControlMode.TORQUE:
            cmd = action
            filt_state = state.filter_state
        elif self.control_mode == MotorControlMode.HYBRID:
            a5 = action.reshape(12, 5)
            q_des = torch.minimum(torch.maximum(q0 + etg_act + a5[:, 0], lo),
                                  hi)
            cmd = torch.stack([
                q_des, torch.clamp(a5[:, 1], min=0.0), a5[:, 2],
                torch.clamp(a5[:, 3], min=0.0), a5[:, 4]], dim=1).reshape(60)
            filt_state = state.filter_state
        else:
            target = q0 + etg_act + action
            if cfg.train.enable_action_filter:
                target, filt_state = af.filter_step(
                    self._filter_b, self._filter_a, state.filter_state,
                    target)
            else:
                filt_state = state.filter_state
            cmd = torch.minimum(torch.maximum(target, lo), hi)

        # Sporadic push bursts, as the batched path: ~0.26 s push every
        # ~3.9 s, direction and magnitude a pure hash of (burst index,
        # episode salt), constant within a burst.
        dyn = state.dyn
        if cfg.random.random_force:
            burst = torch.div(state.step_idx, 150, rounding_mode="floor")
            phase_i = state.step_idx % 150
            active = (phase_i >= 75) & (phase_i < 85)
            u_phi = terrain._hash01(state.push_salt, burst)
            u_mag = terrain._hash01(state.push_salt ^ 0x5BF03635, burst)
            phi = 2 * np.pi * u_phi
            mag = u_mag * cfg.random.max_force * active.to(torch.float32)
            dyn = dyn.replace(external_force=torch.stack(
                [mag * torch.cos(phi), mag * torch.sin(phi),
                 torch.zeros((), device=dev)]))

        dyn_phys = dyn
        if cfg.sim.motor_overheat_protection:
            # latched-off motors exert zero torque (ApplyAction:938-947)
            on_f = state.motor_on.to(torch.float32)
            if self.control_mode == MotorControlMode.TORQUE:
                cmd = cmd * on_f
            elif self.control_mode == MotorControlMode.HYBRID:
                one = torch.ones_like(on_f)
                cmd = (cmd.reshape(12, 5) * torch.stack(
                    [one, on_f, one, on_f, on_f], dim=1)).reshape(60)
            else:
                dyn_phys = dyn.replace(motor_kp=dyn.motor_kp * on_f,
                                       motor_kd=dyn.motor_kd * on_f)
        rb = robot_mod.control_step(
            state.robot, cmd, dyn_phys, cfg.sim, self.h_fn,
            control_mode=self.control_mode)
        st = rb.state
        oh_counter, motor_on = state.oh_counter, state.motor_on
        if cfg.sim.motor_overheat_protection:
            over = torch.abs(rb.applied_torque) > \
                cfg.sim.overheat_shutdown_torque
            oh_counter = torch.where(over, oh_counter + 1.0,
                                     torch.zeros_like(oh_counter))
            limit = cfg.sim.overheat_shutdown_time / cfg.sim.control_dt
            motor_on = motor_on & (oh_counter <= limit)

        # reward ingredients
        dx = st.base_pos[0] - state.last_base_pos[0]
        R_b = math3d.quat_to_mat(st.base_quat)
        base_vel_w = R_b @ st.base_lin_vel
        velx = base_vel_w[0]
        up_z = R_b[2, 2]
        fp = rb.contact.foot_pos
        foot_h = fp[:, 2] - self.h_fn(fp[:, 0], fp[:, 1]) - a1.FOOT_RADIUS
        knee_contacts = rb.contact.knee_penetration > 0
        base_contact = rb.contact.base_penetration > 0

        rew, info = reward_mod.compute_reward(
            cfg.reward, dx, velx, up_z, st.base_ang_vel,
            rb.applied_torque, foot_h, swing.to(torch.float32),
            stance.to(torch.float32), rb.contact.in_contact,
            knee_contacts, base_contact,
            y_pos=st.base_pos[1],
            vel_y=base_vel_w[1],
            yaw=torch.atan2(R_b[1, 0], R_b[0, 0]))

        # termination: rollover / trunk too low / trunk touches ground
        local_h = self.h_fn(st.base_pos[0], st.base_pos[1])
        fallen = (up_z < 0.6) | (st.base_pos[2] - local_h <
                                 cfg.reward.done_height) | base_contact
        done = fallen | torch.as_tensor(donef, dtype=torch.bool, device=dev)

        new_state = EnvState(
            robot=rb, dyn=dyn, etg_w=state.etg_w, etg_b=state.etg_b,
            step_idx=state.step_idx + 1,
            last_base_pos=st.base_pos, init_rpy=state.init_rpy,
            filter_state=filt_state, done=done,
            push_salt=state.push_salt,
            oh_counter=oh_counter, motor_on=motor_on)
        # Post-step obs reflects the *next* step's ETG signal (the reference
        # increments iter before get_observation, EnvWrapper.py:103-120);
        # info["ETG_act"] stays the residual applied THIS step.
        etg_next, _, _, _ = self._etg_residual(
            state.etg_w, state.etg_b, new_state.step_idx)
        obs = self._observe(new_state, etg_next, obs_noise)
        info["ETG_act"] = etg_act
        info["success"] = (velx >= 0.3).to(torch.float32)
        return new_state, obs, rew, done, info

    # -- autoreset -----------------------------------------------------------

    def step_autoreset(self, state: EnvState, action: torch.Tensor,
                       donef=False, draws: Optional[EnvDraws] = None,
                       obs_noise: Optional[torch.Tensor] = None):
        """Step; where ``done``, replace the next state by a fresh reset
        (branch-free). The returned ``done`` marks the boundary; the obs
        after a done is the fresh episode's first (the Brax/Isaac
        convention). ``draws`` feeds the fresh reset (fresh dynamics under
        ``random_dynamics``, the x_noise spawn jitter, a fresh push salt,
        which ``random_force`` needs; without it the unused salt is kept);
        ``obs_noise`` the observation returned."""
        nstate, obs, rew, done, info = self.step(state, action, donef,
                                                 obs_noise)
        keep_dyn = None if self.cfg.random.random_dynamics else state.dyn
        rstate, robs = self.reset(state.etg_w, state.etg_b, dyn=keep_dyn,
                                  x_noise=self.cfg.train.x_noise,
                                  draws=draws, obs_noise=obs_noise)
        if draws is None:                  # no fresh salt: keep the old one
            rstate = rstate.replace(push_salt=state.push_salt)
        next_state = _select(done, rstate, nstate)
        next_obs = torch.where(done, robs, obs)
        return next_state, next_obs, rew, done, info
