"""Batch-native quadruped env over the SoA physics hot path (PyTorch).

Port of the JAX package's ``envs/batched_env.py``: a batch of B envs
advances together in batch-minor layout (sim state (k, B), obs/reward as
(B,) elementwise math, branch-free per-env autoreset). The physics control
step goes through ``ops/physics_step.control_step``: the hand-written CUDA
kernel for tensors on the card, its plain PyTorch version on the CPU.

API (batch-first, RL-friendly):
    env = BatchedQuadrupedEnv(config, num_envs)             # on cuda
    env = BatchedQuadrupedEnv(config, num_envs, device="cpu")
    state, obs = env.reset(generator)           # obs (B, obs_dim)
    state, obs, rew, done, info = env.step(state, actions)   # actions (B,12)

Randomness comes from an explicit ``torch.Generator`` carried in the state.
JAX's threefry keys and torch's generators never give the same numbers, so
``reset`` also takes the push salt and the dynamics as arguments, for a
caller that must reproduce another run exactly.

On a mesh (``BatchedQuadrupedEnv(config, num_envs, mesh=mesh)``) the env
holds this env rank's columns ``[off, off + w)`` of the global batch
(``parallel/sharding.columns``; ``self.B`` is ``w``, ``self.cols`` the
columns). Every random draw is made at the global shape from the shared
generator and cut to the columns, and the per-env push hash and spawn
selection take the global column index, so the sharded env is those columns
of the one-process env (the generator does the whole batch's draws on every
rank, which is cheap next to the step).

Spans (``utils/profiler.annotate``; off unless ``enable_spans`` switched
them on): construction is ``setup.env`` (the ETG fit included); each
``step`` is a root span ``env.step`` holding, in order, ``env.command``
(the action's transpose), ``env.etg`` (the ETG residual), ``env.command``
(the action to the position target: filter, clamp, push, overheat gains),
``env.physics`` (``ops/physics_step.control_step``, whose CUDA path opens
``physics.args`` and ``physics.ring``), ``env.reward`` (reward and done
flags), ``env.autoreset`` (with ``autoreset``; the DR draw included),
``env.etg`` (the next residual) and ``env.observe`` (observation and info).
They change no operation and no order of operations.

On the card ``step`` replays the step as a CUDA graph, one per key,
captured on the key's first call (``envs/step_graph``; ``graph_stats``
counts captures, replays and eager calls by reason). A replayed call's
``env.step`` span holds ``env.graph.copy_in``, ``env.graph.replay`` and
``env.graph.copy_out`` instead of the phase spans above, which only an
eager call (``_step``) opens. So that the step can be captured it copies
nothing from the host: the autoreset selects from a standing start built
once per env, a Python ``donef`` is a device constant, and the ring's
indices and ages are device constants per ring head (``sim/sbatch``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.envs import action_filter as af
from paddlerobotics_torch.envs import randomize, sensors, step_graph
from paddlerobotics_torch.envs import reward as reward_mod
from paddlerobotics_torch.etg import fit as etg_fit
from paddlerobotics_torch.etg import model as etg_model
from paddlerobotics_torch.etg import oscillator
from paddlerobotics_torch.ops import etg_residual, physics_step
from paddlerobotics_torch.ops import smallalg as sa
from paddlerobotics_torch.parallel import sharding
from paddlerobotics_torch.sim import a1_model as a1
from paddlerobotics_torch.sim import sbatch, terrain
from paddlerobotics_torch.sim.sbatch import BDynParams, BRobot, F32
from paddlerobotics_torch.utils import profiler

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class BEnvState:
    robot: BRobot
    dyn: BDynParams
    etg_w: torch.Tensor      # (3,H,B)
    etg_b: torch.Tensor      # (3,B)
    step_idx: torch.Tensor   # (B,) int32
    rng: torch.Generator     # advanced by every random draw of the env
    last_x: torch.Tensor     # (B,) previous base x
    done: torch.Tensor       # (B,) bool
    filter_z: torch.Tensor   # (2,12,B) Butterworth carry (action filter)
    push_salt: int           # seed for burst-indexed random pushes (a
                             # device scalar in a graph's static state)
    oh_counter: torch.Tensor  # (12,B) consecutive over-torque control steps
    motor_on: torch.Tensor    # (12,B) bool, overheat latch (False = off)
    dr_scale: torch.Tensor    # () DR scale on the normalized dynamics sample

    def replace(self, **kw) -> "BEnvState":
        return dataclasses.replace(self, **kw)

    def leaves(self) -> list:
        """Every tensor of the state, in the order ``from_leaves`` takes."""
        rb, s, c = self.robot, self.robot.s, self.robot.contact
        return [s.pos, s.quat, s.w, s.v, s.q, s.qd, rb.last_action, rb.tau,
                c.foot_pos, c.foot_contact, c.knee_contact, c.base_contact,
                rb.obs_hist, *self.dyn, self.etg_w, self.etg_b,
                self.step_idx, self.last_x, self.done, self.filter_z,
                self.oh_counter, self.motor_on, self.dr_scale]

    @classmethod
    def from_leaves(cls, leaves, hist_head: int, rng,
                    push_salt) -> "BEnvState":
        """The state whose tensors are ``leaves`` (``leaves()``'s order)."""
        (pos, quat, w, v, q, qd, last_action, tau, foot_pos, foot_contact,
         knee_contact, base_contact, obs_hist) = leaves[:13]
        n = 13 + len(BDynParams._fields)
        (etg_w, etg_b, step_idx, last_x, done, filter_z, oh_counter,
         motor_on, dr_scale) = leaves[n:]
        robot = BRobot(
            s=sbatch.BQuadState(pos=pos, quat=quat, w=w, v=v, q=q, qd=qd),
            last_action=last_action, tau=tau,
            contact=sbatch.BContact(
                foot_pos=foot_pos, foot_contact=foot_contact,
                knee_contact=knee_contact, base_contact=base_contact),
            obs_hist=obs_hist, hist_head=hist_head)
        return cls(robot=robot, dyn=BDynParams(*leaves[13:n]), etg_w=etg_w,
                   etg_b=etg_b, step_idx=step_idx, rng=rng, last_x=last_x,
                   done=done, filter_z=filter_z, push_salt=push_salt,
                   oh_counter=oh_counter, motor_on=motor_on,
                   dr_scale=dr_scale)


class BatchedQuadrupedEnv:
    def __init__(self, config: QuadrupedConfig, num_envs: int,
                 device: str | torch.device | None = None, mesh=None):
        with profiler.annotate("setup.env"):
            self._setup(config, num_envs, device, mesh)

    def _setup(self, config, num_envs, device, mesh):
        self.cfg = config
        self.cols = sharding.columns(mesh, num_envs)
        self.B = self.cols.width
        self.device = resolve_device(device)
        sharding.check_mesh(mesh, self.device)
        dev = self.device
        self.h_fn = terrain.height_fn(config.task)
        # Policy-obs latency blend reach (SimConfig.obs_latency_taps): the
        # full ring under DR (control_latency randomized 0-80 ms), else
        # just enough taps for the static nominal latency.
        t = config.sim.obs_latency_taps
        if t == 0:
            if config.random.random_dynamics:
                t = None
            else:
                t = max(2, 1 + math.ceil(
                    config.sim.control_latency / config.sim.substep_dt))
        self._obs_taps = t
        # Ring length: one control step's snapshot stack when every reader
        # fits in it, else the latency buffer rounded up to a multiple of n
        # so block writes never wrap.
        n = config.sim.action_repeat
        pd = sbatch.pd_delay_taps(config.sim, 10 ** 9)
        need = (config.sim.latency_buffer_len if t is None
                else max(t, pd[0] if pd else 1))
        self._hist_len = need if need <= n else -(-need // n) * n
        self._etg_cfg = etg_model.resolve_pairing(config.etg,
                                                  config.task.task_mode)
        self._w0, self._b0 = etg_fit.opt_with_points(config.etg, device=dev)
        mode = config.train.act_mode
        self.act_offset = np.zeros(12, np.float32)
        if mode == "pose":
            self.act_bound = np.array([0.1, 0.7, 0.7] * 4, np.float32)
        elif mode == "torque":
            self.act_bound = np.array([10.0] * 12, np.float32)
        elif mode == "hybrid":
            # Per motor (pos, kp, q̇*, kd, τ_ff) (laikago_motor.py:33-37).
            kp0 = np.asarray(a1.MOTOR_KP, np.float32)
            kd0 = np.asarray(a1.MOTOR_KD, np.float32)
            self.act_bound = np.stack([
                np.full(12, config.train.act_bound, np.float32),
                0.5 * kp0, np.full(12, 2.0, np.float32),
                0.5 * kd0, np.full(12, 5.0, np.float32)], axis=1
            ).reshape(60)
            self.act_offset = np.stack([
                np.zeros(12, np.float32), kp0,
                np.zeros(12, np.float32), kd0,
                np.zeros(12, np.float32)], axis=1).reshape(60)
        else:
            self.act_bound = np.full(12, config.train.act_bound, np.float32)
        self.torque_mode = mode == "torque"
        self.hybrid_mode = mode == "hybrid"
        h0 = float(self.h_fn(torch.zeros(()), torch.zeros(())))
        self._spawn_height = 0.27 + h0
        self._fb, self._fa = af.butter_lowpass_coeffs(
            1.0 / config.sim.control_dt)
        # per-leg stance offsets, step_y-parameterized
        lat = (etg_model.STANCE_OFFSET_Y +
               (config.etg.step_y - etg_model.REFERENCE_STEP_Y) *
               np.asarray(etg_model.LATERAL_SIGN)).astype(np.float32)
        col = lambda a: torch.as_tensor(
            np.asarray(a, np.float32), device=dev)[:, None]
        feet = etg_model.default_foot_positions().astype(np.float32)
        hips = a1.HIP_OFFSETS.astype(np.float32)
        self._q0 = col(a1.INIT_MOTOR_ANGLES)
        self._etg = etg_residual.Consts.pack(
            config.etg,
            centers=torch.as_tensor(
                oscillator.centers(config.etg).astype(np.float32),
                device=dev),
            sel_a=torch.as_tensor(
                etg_model.leg_phase_group(self._etg_cfg.pairing) == 0,
                device=dev)[:, None],
            stx=col(etg_model.STANCE_OFFSET_X), lat=col(lat),
            feet=[col(feet[:, i]) for i in range(3)],
            hips=[col(hips[:, i]) for i in range(3)],
            l_hip=col(a1.HIP_SIGNS.astype(np.float32)) * a1.L_HIP,
            q0=self._q0)
        self._lo = col(a1.MOTOR_LOWER)
        self._hi = col(a1.MOTOR_UPPER)
        self._etg_mean = col(sensors.ETG_MEAN)
        self._etg_std = col(sensors.ETG_STD)
        # device constants a step reads instead of copying from the host
        # (so a step can be captured): the standing start the autoreset
        # selects from, and a Python donef
        self._fresh = self._fresh_robot()
        self._donef = {f: torch.as_tensor(f, device=dev)
                       for f in (False, True)}
        self._graphs = step_graph.StepGraphs(self)

    @property
    def obs_dim(self) -> int:
        return self.cfg.sensors.base_obs_dim

    @property
    def action_dim(self) -> int:
        return 60 if self.hybrid_mode else 12

    @property
    def graph_stats(self) -> dict:
        """Captures, replays and eager calls by reason of ``step``
        (``envs/step_graph``)."""
        return self._graphs.stats

    def default_etg(self):
        """Population-shared default (w, b) broadcast to (3,H,B)/(3,B)."""
        w = self._w0[..., None].repeat(1, 1, self.B)
        b = self._b0[:, None].repeat(1, self.B)
        return w, b

    # -- ETG (SoA) ------------------------------------------------------------

    def _etg_residual(self, etg_w, etg_b, step_idx):
        """ETG joint residual (12,B), swing/stance masks (4,B), V(t)
        (``ops/etg_residual``: one kernel launch on the card, the PyTorch
        composition on the CPU)."""
        return etg_residual.etg_residual(etg_w, etg_b, step_idx, self._etg)

    # -- reset ----------------------------------------------------------------

    def _fresh_robot(self) -> BRobot:
        return sbatch.init_robot(self.B, height=self._spawn_height,
                                 hist_len=self._hist_len, device=self.device)

    def _draw(self, fn, *rows: int, generator) -> torch.Tensor:
        """``fn`` (torch.rand / torch.randn) at the global batch-minor shape
        (*rows, total), cut to this env's columns."""
        return self.cols.cut(fn(rows + (self.cols.total,),
                                generator=generator, device=self.device))

    def _sample_dyn(self, gen, scale) -> BDynParams:
        jitter = self.cfg.random.dr_scale_jitter
        u = self.cols.cut(torch.rand(
            (self.cols.total, randomize.NUM_DYNAMIC_PARAMS), generator=gen,
            device=self.device) * 2.0 - 1.0, 0)
        ju = self._draw(torch.rand, generator=gen) if jitter else None
        return randomize.sample_dynamics(
            self.B, scale=scale, jitter=jitter, u=u, jitter_u=ju,
            device=self.device)

    def reset(self, generator: torch.Generator | None = None,
              etg_w: Optional[torch.Tensor] = None,
              etg_b: Optional[torch.Tensor] = None,
              dyn: Optional[BDynParams] = None,
              dr_scale: torch.Tensor | float | None = None,
              push_salt: int | None = None,
              ) -> Tuple[BEnvState, torch.Tensor]:
        """Start every env. `generator` (default: seeded with
        ``cfg.train.seed``) is carried in the state and drives every later
        draw. `dyn` and `push_salt` replace the drawn dynamics and push
        salt."""
        dev = self.device
        gen = generator
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.cfg.train.seed)
        if etg_w is None or etg_b is None:
            etg_w, etg_b = self.default_etg()
        if dr_scale is None:
            dr_scale = self.cfg.random.dynamics_scale
        dr_scale = torch.as_tensor(dr_scale, dtype=F32, device=dev)
        if dyn is None:
            if self.cfg.random.random_dynamics:
                dyn = self._sample_dyn(gen, dr_scale)
            else:
                dyn = BDynParams.default(self.B, device=dev)
        elif self._obs_taps is not None:
            # Injected latencies beyond the tapped blend reach would be
            # clipped silently by delayed_obs.
            reach = (self._obs_taps - 1) * self.cfg.sim.substep_dt
            lat_max = float(torch.max(dyn.control_latency))
            if lat_max > reach + 1e-9:
                import warnings
                warnings.warn(
                    f"reset(dyn=...) injects control_latency up to "
                    f"{lat_max * 1e3:.1f} ms but obs_latency_taps="
                    f"{self._obs_taps} only reaches {reach * 1e3:.1f} ms — "
                    f"the blend will clip. Set SimConfig.obs_latency_taps="
                    f"latency_buffer_len for injected latencies.",
                    stacklevel=2)
        dyn = BDynParams(*[x.to(device=dev, dtype=F32).contiguous()
                           for x in dyn])
        rb = self._fresh_robot()
        if self.cfg.train.x_noise:
            # reset-position jitter (train.py --x_noise)
            dxy = 0.02 * self._draw(torch.randn, 2, generator=gen)
            rb.s.pos[:2] += dxy
        if push_salt is None:
            push_salt = int(torch.randint(0, _INT32_MAX, (), generator=gen,
                                          device=dev))
        state = BEnvState(
            robot=rb, dyn=dyn, etg_w=etg_w, etg_b=etg_b,
            step_idx=torch.zeros((self.B,), dtype=torch.int32, device=dev),
            rng=gen, last_x=rb.s.pos[0].clone(),
            done=torch.zeros((self.B,), dtype=torch.bool, device=dev),
            filter_z=af.init_filter_state(self._fb, self._fa, rb.s.q),
            push_salt=int(push_salt),
            oh_counter=torch.zeros((12, self.B), dtype=F32, device=dev),
            motor_on=torch.ones((12, self.B), dtype=torch.bool, device=dev),
            dr_scale=dr_scale)
        etg_act, _, _, v_a = self._etg_residual(etg_w, etg_b, state.step_idx)
        return state, self._observe(state, etg_act, v_a)

    # -- observation (SoA → (B, obs_dim)) -------------------------------------

    def _observe(self, state: BEnvState, etg_act: torch.Tensor,
                 etg_features: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg.sensors
        rb = state.robot
        s = rb.s
        Rb = sbatch.quat_to_mat_cols(s.quat)
        vel_w = sa.mv(Rb, [s.v[0], s.v[1], s.v[2]])   # world base velocity
        # The reference delays the FULL policy observation — q, qd, base
        # quat and rpy-rate — at control_latency over the substep ring.
        q_obs, qd_obs, quat_obs, drpy = sbatch.delayed_obs(
            rb, state.dyn.control_latency, self.cfg.sim.substep_dt,
            taps=self._obs_taps)
        # rpy from the delayed quaternion, renormalized as pybullet's
        # getEulerFromQuaternion does
        inv_n = torch.rsqrt(torch.sum(quat_obs * quat_obs, dim=0) + 1e-12)
        qw, qx, qy, qz = (quat_obs[0] * inv_n, quat_obs[1] * inv_n,
                          quat_obs[2] * inv_n, quat_obs[3] * inv_n)
        roll = torch.atan2(2 * (qw * qx + qy * qz),
                           1 - 2 * (qx * qx + qy * qy))
        pitch = torch.asin(torch.clamp(2 * (qw * qy - qz * qx), -1.0, 1.0))
        yaw = torch.atan2(2 * (qw * qz + qx * qy),
                          1 - 2 * (qy * qy + qz * qz))

        vel_s = torch.stack(vel_w)
        rpy = torch.stack([roll, pitch, yaw])
        if cfg.noise:
            # Per-channel noise on RAW values before normalization
            # (sensors.NOISE_STD, minitaur._AddSensorNoise semantics).
            gen = state.rng

            def nz(x, std):
                return x + std * self._draw(torch.randn, *x.shape[:-1],
                                            generator=gen)

            vel_s = nz(vel_s, sensors.NOISE_STD["dis"])
            rpy = nz(rpy, sensors.NOISE_STD["rpy"])
            drpy = nz(drpy, sensors.NOISE_STD["drpy"])
            q_obs = nz(q_obs, sensors.NOISE_STD["q"])
            qd_obs = nz(qd_obs, sensors.NOISE_STD["qd"])

        parts = []  # each (k, B)
        if cfg.dis:
            parts.append(vel_s)
        if cfg.contact:
            parts.append(rb.contact.foot_contact.to(F32))
        if cfg.imu == 1:
            if cfg.normal:
                parts.append(torch.cat([rpy / 0.1, drpy / 0.5]))
            else:
                parts.append(torch.cat([rpy, drpy]))
        elif cfg.imu == 2:
            parts.append(drpy / 0.5 if cfg.normal else drpy)
        if cfg.motor == 1:
            qn = (q_obs - self._q0) / 0.1 if cfg.normal else q_obs
            parts.append(torch.cat([qn, qd_obs]))
        elif cfg.motor == 2:
            parts.append((q_obs - self._q0) / 0.1 if cfg.normal else q_obs)
        if cfg.etg:
            parts.append((etg_act - self._etg_mean) / self._etg_std
                         if cfg.normal else etg_act)
        if cfg.etg_obs and etg_features is not None:
            parts.append(etg_features)              # (H,B) phase features
        if cfg.footpose:
            # foot positions in base frame: R_bᵀ (p_w − base)  (3,4,B)→(12,B)
            fp = rb.contact.foot_pos
            dx = fp[0] - s.pos[0]
            dy = fp[1] - s.pos[1]
            dz = fp[2] - s.pos[2]
            bx = Rb[0][0] * dx + Rb[1][0] * dy + Rb[2][0] * dz
            by = Rb[0][1] * dx + Rb[1][1] * dy + Rb[2][1] * dz
            bz = Rb[0][2] * dx + Rb[1][2] * dy + Rb[2][2] * dz
            parts.append(torch.stack([bx, by, bz], dim=1).reshape(12, -1))
        if cfg.dynamic_vec:
            parts.append(randomize.dynamics_to_normalized(state.dyn))
        if cfg.force_vec:
            parts.append(state.dyn.external_force)
        obs = torch.cat(parts, dim=0)               # (obs_dim, B)
        return obs.T.contiguous()                   # (B, obs_dim)

    # -- step -----------------------------------------------------------------

    def step(self, state: BEnvState, actions: torch.Tensor,
             donef: torch.Tensor | bool = False, autoreset: bool = True):
        """actions (B,12), already scaled by act_bound (train.py:147).

        Returns (state, obs (B,obs), reward (B,), done (B,), info). On the
        card the step is replayed as a CUDA graph where it can be
        (``envs/step_graph``); ``_step`` is the eager step."""
        with profiler.annotate("env.step"):
            return self._graphs.step(state, actions, donef, autoreset)

    def _step(self, state, actions, donef, autoreset):
        cfg = self.cfg
        B = self.B
        dev = self.device
        gen = state.rng
        with profiler.annotate("env.command"):
            act = actions.T.to(F32).contiguous()        # (12,B)
        with profiler.annotate("env.etg"):
            etg_act, swing, stance, _ = self._etg_residual(
                state.etg_w, state.etg_b, state.step_idx)

        with profiler.annotate("env.command"):
            filter_z = state.filter_z
            qd_ref = tau_ff = None
            if self.torque_mode:
                cmd = act
            elif self.hybrid_mode:
                # (60,B) → per-motor (pos, kp, q̇*, kd, τ_ff); the position
                # target is init+ETG+residual, gains/vel/ff go to the hybrid
                # motor law (laikago_motor.py:152-166).
                a5 = act.reshape(12, 5, -1)
                cmd = self._q0 + etg_act + a5[:, 0]
                cmd = torch.clamp(cmd, self._lo, self._hi)
                qd_ref, tau_ff = a5[:, 2].contiguous(), a5[:, 4].contiguous()
            else:
                cmd = self._q0 + etg_act + act
                if cfg.train.enable_action_filter:
                    # Butterworth smoothing of the position target
                    # (ActionFilterWrapper, EnvWrapper.py:287-291)
                    cmd, filter_z = af.filter_step(self._fb, self._fa,
                                                   filter_z, cmd)
                cmd = torch.clamp(cmd, self._lo, self._hi)

            dyn = state.dyn
            if cfg.random.random_force:
                # Sporadic pushes: ~0.26 s push every ~3.9 s, direction and
                # magnitude a pure hash of (env, burst_index, episode_salt).
                burst = torch.div(state.step_idx, 150, rounding_mode="floor")
                phase = state.step_idx % 150
                # mid-cycle window so a fresh episode is never pushed at spawn
                active = (phase >= 75) & (phase < 85)
                env_ix = self.cols.index(dev).to(torch.int32)
                # Knuth multiplicative constant as signed int32
                seed = env_ix * -1640531535 + state.push_salt
                u_phi = terrain._hash01(seed, burst)
                u_mag = terrain._hash01(seed ^ 0x5BF03635, burst)
                phi = 2 * math.pi * u_phi
                mag = u_mag * cfg.random.max_force * active.to(F32)
                dyn = dyn._replace(external_force=torch.stack(
                    [mag * torch.cos(phi), mag * torch.sin(phi),
                     torch.zeros(B, device=dev)]))

            dyn_phys = dyn
            if self.hybrid_mode:
                # commanded gains drive the physics but are not persisted
                dyn_phys = dyn._replace(
                    motor_kp=torch.clamp(a5[:, 1], min=0.0),
                    motor_kd=torch.clamp(a5[:, 3], min=0.0))
            if cfg.sim.motor_overheat_protection:
                # latched-off motors exert zero torque (ApplyAction:938-947)
                on_f = state.motor_on.to(F32)
                if self.torque_mode:
                    cmd = cmd * on_f
                else:
                    dyn_phys = dyn_phys._replace(
                        motor_kp=dyn_phys.motor_kp * on_f,
                        motor_kd=dyn_phys.motor_kd * on_f)
                    if tau_ff is not None:
                        tau_ff = tau_ff * on_f
        with profiler.annotate("env.physics"):
            rb = physics_step.control_step(
                state.robot, cmd, dyn_phys, cfg.sim, self.h_fn,
                torque_mode=self.torque_mode, qd_ref=qd_ref, tau_ff=tau_ff)

        with profiler.annotate("env.reward"):
            s = rb.s

            dx = s.pos[0] - state.last_x
            Rb = sbatch.quat_to_mat_cols(s.quat)
            velx = Rb[0][0] * s.v[0] + Rb[0][1] * s.v[1] + Rb[0][2] * s.v[2]
            up_z = Rb[2][2]
            foot_h = (rb.contact.foot_pos[2] -
                      self.h_fn(rb.contact.foot_pos[0],
                                rb.contact.foot_pos[1]) -
                      a1.FOOT_RADIUS)                   # (4,B)
            vel_y = Rb[1][0] * s.v[0] + Rb[1][1] * s.v[1] + Rb[1][2] * s.v[2]
            yaw = torch.atan2(Rb[1][0], Rb[0][0])
            reward, rinfo = reward_mod.compute_reward(
                cfg.reward, dx, velx, up_z, s.w, rb.tau, foot_h,
                swing.to(F32), stance.to(F32),
                rb.contact.foot_contact, rb.contact.knee_contact,
                rb.contact.base_contact,
                y_pos=s.pos[1], vel_y=vel_y, yaw=yaw)

            local_h = self.h_fn(s.pos[0], s.pos[1])
            fallen = ((up_z < 0.6) |
                      (s.pos[2] - local_h < cfg.reward.done_height) |
                      rb.contact.base_contact)
            flag = (self._donef[donef] if isinstance(donef, bool)
                    else torch.as_tensor(donef, device=dev))
            done = fallen | flag.expand_as(fallen)

            oh_counter, motor_on = state.oh_counter, state.motor_on
            if cfg.sim.motor_overheat_protection:
                # per-CONTROL-step approximation of minitaur.py:894-901
                over = torch.abs(rb.tau) > cfg.sim.overheat_shutdown_torque
                oh_counter = torch.where(over, oh_counter + 1.0,
                                         torch.zeros_like(oh_counter))
                limit = cfg.sim.overheat_shutdown_time / cfg.sim.control_dt
                motor_on = motor_on & (oh_counter <= limit)

        new_state = BEnvState(
            robot=rb, dyn=dyn, etg_w=state.etg_w, etg_b=state.etg_b,
            step_idx=state.step_idx + 1, rng=gen,
            last_x=s.pos[0], done=done, filter_z=filter_z,
            push_salt=state.push_salt,
            oh_counter=oh_counter, motor_on=motor_on,
            dr_scale=state.dr_scale)

        if autoreset:
            with profiler.annotate("env.autoreset"):
                new_state = self._autoreset(new_state, done, gen)

        with profiler.annotate("env.etg"):
            etg_next, _, _, v_next = self._etg_residual(
                new_state.etg_w, new_state.etg_b, new_state.step_idx)
        with profiler.annotate("env.observe"):
            obs = self._observe(new_state, etg_next, v_next)
            info = {
                "torso": rinfo["torso"], "up": rinfo["up"],
                "feet": rinfo["feet"], "tau": rinfo["tau"],
                "stand": rinfo["stand"], "badfoot": rinfo["badfoot"],
                "footcontact": rinfo["footcontact"], "velx": velx,
                "rew": reward, "ETG_act": etg_act.T,
                "success": (velx >= 0.3).to(F32),
            }
        return new_state, obs, reward, done, info

    def _autoreset(self, st: BEnvState, done: torch.Tensor,
                   gen: torch.Generator) -> BEnvState:
        """Branch-free per-env reset of the envs that are done."""
        cfg = self.cfg
        dev = self.device
        fresh = self._fresh
        if cfg.train.x_noise:
            # reset-position jitter for auto-resetting envs (train.py --x_noise)
            pos = fresh.s.pos.clone()
            pos[:2] += 0.02 * self._draw(torch.randn, 2, generator=gen)
            fresh = fresh.replace(s=fresh.s.replace(pos=pos))
        if cfg.train.spawn_x_max > 0:
            # spawn-on-course curriculum (TrainConfig.spawn_x_max)
            on = (self.cols.index(dev) <
                  int(cfg.train.spawn_x_frac * self.cols.total)).to(F32)
            u = self._draw(torch.rand, 3, generator=gen)
            xs = on * (u[0] * cfg.train.spawn_x_max)
            ys = on * (u[1] * (2 * cfg.train.spawn_y) - cfg.train.spawn_y)
            pos = fresh.s.pos.clone()
            pos[0] += xs
            pos[1] += ys
            # terrain-relative spawn height
            pos[2] += self.h_fn(pos[0], pos[1])
            quat = fresh.s.quat
            if cfg.train.spawn_yaw > 0:
                psi = on * (u[2] * (2 * cfg.train.spawn_yaw)
                            - cfg.train.spawn_yaw)
                # fresh quat is identity → yaw-only rotation
                zero = torch.zeros_like(psi)
                quat = torch.stack([torch.cos(psi / 2), zero, zero,
                                    torch.sin(psi / 2)])
            fresh = fresh.replace(s=fresh.s.replace(pos=pos, quat=quat))

        def sel(f, n):
            return torch.where(done.reshape((1,) * (n.dim() - 1) + (-1,)), f, n)

        rb, fr = st.robot, fresh
        rb_next = BRobot(
            s=sbatch.BQuadState(*[sel(getattr(fr.s, k), getattr(rb.s, k))
                                  for k in ("pos", "quat", "w", "v", "q",
                                            "qd")]),
            last_action=sel(fr.last_action, rb.last_action),
            tau=sel(fr.tau, rb.tau),
            contact=sbatch.BContact(
                *[sel(getattr(fr.contact, k), getattr(rb.contact, k))
                  for k in ("foot_pos", "foot_contact", "knee_contact",
                            "base_contact")]),
            obs_hist=sel(fr.obs_hist, rb.obs_hist),
            # the head is shared by all envs; a fresh ring is row-uniform,
            # so the live head reads the same values for reset envs
            hist_head=rb.hist_head)
        fresh_fz = af.init_filter_state(self._fb, self._fa, fresh.s.q)
        dyn_next = st.dyn._replace(
            external_force=torch.where(done[None, :], 0.0,
                                       st.dyn.external_force))
        if cfg.random.random_dynamics:
            # Per-EPISODE domain randomization: each finished env draws a
            # fresh set of dynamics.
            fresh_dyn = self._sample_dyn(gen, st.dr_scale)
            dyn_next = BDynParams(*[sel(f, n).contiguous()
                                    for f, n in zip(fresh_dyn, dyn_next)])
        return st.replace(
            robot=rb_next,
            dyn=dyn_next,
            step_idx=torch.where(done, torch.zeros_like(st.step_idx),
                                 st.step_idx),
            last_x=torch.where(done, fresh.s.pos[0], st.last_x),
            filter_z=torch.where(done[None, None, :], fresh_fz, st.filter_z),
            oh_counter=torch.where(done[None, :], 0.0, st.oh_counter),
            motor_on=torch.where(done[None, :], True, st.motor_on))
