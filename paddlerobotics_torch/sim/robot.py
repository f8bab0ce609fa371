"""Robot control step of the per-env path: action repeat, interpolation,
latency, PD, dynamics (port of the JAX package's ``sim/robot.py``,
Minitaur.Step/_StepInternal/ApplyAction/ReceiveObservation,
minitaur.py:242-258, 904-947, 1151-1193).

One call advances a control step (default 26 ms) by ``action_repeat``
physics substeps; JAX's ``lax.scan`` over the substeps is a Python loop.
The latency ring buffers and the last action live in fixed-shape tensors
on ``RobotState``, so the functions run under ``torch.func.vmap``.
"""

from __future__ import annotations

import torch

from paddlerobotics_torch.core.config import SimConfig
from paddlerobotics_torch.core.types import ContactState, RobotState
from paddlerobotics_torch.sim import a1_model as a1
from paddlerobotics_torch.sim import contact as contact_mod
from paddlerobotics_torch.sim import dynamics, motor
from paddlerobotics_torch.sim.dynamics import DynamicsParams
from paddlerobotics_torch.sim.motor import MotorControlMode


def delayed_interp(hist: torch.Tensor, latency, substep_dt: float
                   ) -> torch.Tensor:
    """Latency-interpolated snapshot from a (L, …) newest-first ring
    (minitaur._GetDelayedObservation:1172-1193): linear interpolation
    between the two snapshots bracketing ``latency`` (quaternions blend
    componentwise, as the reference blends its flat observation)."""
    L = hist.shape[0]
    lat = torch.as_tensor(latency, dtype=torch.float32, device=hist.device)
    f = torch.clamp(lat / substep_dt, 0.0, L - 1.001)
    i0 = torch.floor(f).to(torch.int64)
    frac = f - i0
    h0 = torch.index_select(hist, 0, i0.reshape(1))[0]
    h1 = torch.index_select(hist, 0, torch.clamp(i0 + 1, max=L - 1)
                            .reshape(1))[0]
    return h0 * (1 - frac) + h1 * frac


def delayed_motor_obs(q_hist: torch.Tensor, qd_hist: torch.Tensor,
                      latency, substep_dt: float):
    """Latency-interpolated (q, qd) (minitaur._GetPDObservation)."""
    return (delayed_interp(q_hist, latency, substep_dt),
            delayed_interp(qd_hist, latency, substep_dt))


def init_robot_state(cfg: SimConfig, height=0.32, q0=None,
                     device=None) -> RobotState:
    """Standing-start RobotState with filled history buffers (``height`` a
    float or a tensor, whose device is then the state's)."""
    state = dynamics.default_state(height=height, motor_angles=q0,
                                   device=device)
    L = cfg.latency_buffer_len
    poses = dynamics.world_poses(state)
    dev = state.q.device
    zeros4 = torch.zeros(4, device=dev)
    contact = ContactState(
        foot_pos=poses["o_foot"], foot_vel=torch.zeros((4, 3), device=dev),
        forces=torch.zeros((4, 3), device=dev), penetration=zeros4,
        in_contact=zeros4 > 1, knee_penetration=zeros4.clone(),
        base_penetration=torch.zeros((), device=dev))
    return RobotState(
        state=state,
        q_hist=state.q[None, :].repeat(L, 1),
        qd_hist=torch.zeros((L, 12), device=dev),
        quat_hist=state.base_quat[None, :].repeat(L, 1),
        w_hist=torch.zeros((L, 3), device=dev),
        last_action=state.q,
        applied_torque=torch.zeros(12, device=dev),
        contact=contact)


def _push(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[None], h[:-1]], dim=0)


def substep(robot: RobotState, motor_command: torch.Tensor,
            params: DynamicsParams, cfg: SimConfig, h_fn,
            control_mode: MotorControlMode = MotorControlMode.POSITION
            ) -> RobotState:
    """One physics substep (minitaur._StepInternal:242-246)."""
    state = robot.state
    poses = dynamics.world_poses(state)

    # PD input at pd_latency (A1 leaves it at 0: the current pre-substep
    # state); control_latency delays only the policy observation.
    if cfg.pd_latency > 0.0:
        q_obs, qd_obs = delayed_motor_obs(
            robot.q_hist, robot.qd_hist, cfg.pd_latency, cfg.substep_dt)
    else:
        q_obs, qd_obs = state.q, state.qd
    limit = a1._c(a1.TORQUE_LIMIT, state.q)
    if control_mode == MotorControlMode.POSITION:
        tau = motor.pd_torque(motor_command, q_obs, qd_obs,
                              params.motor_kp, params.motor_kd, limit)
    elif control_mode == MotorControlMode.TORQUE:
        tau = motor.torque_passthrough(motor_command, limit)
    else:
        tau = motor.hybrid_torque(motor_command, q_obs, qd_obs, limit)

    contact_state, foot_f, knee_f, base_f = contact_mod.compute_contacts(
        state, poses, h_fn, params, cfg)
    a0, qdd = dynamics.forward_dynamics(
        state, tau, foot_f, knee_f, base_f, params, poses)
    new_state = dynamics.integrate(
        state, a0, qdd, cfg.substep_dt,
        max_joint_vel=cfg.max_joint_velocity,
        max_base_vel=cfg.max_base_velocity)
    if cfg.on_rack:
        # on-rack debug mode (minitaur.py:106, 418): the base is welded to
        # a rack — joints articulate, the trunk never moves.
        zero3 = torch.zeros_like(state.base_pos)
        new_state = new_state.replace(
            base_pos=state.base_pos, base_quat=state.base_quat,
            base_lin_vel=zero3, base_ang_vel=zero3)

    return RobotState(
        state=new_state,
        q_hist=_push(robot.q_hist, new_state.q),
        qd_hist=_push(robot.qd_hist, new_state.qd),
        quat_hist=_push(robot.quat_hist, new_state.base_quat),
        w_hist=_push(robot.w_hist, new_state.base_ang_vel),
        last_action=robot.last_action, applied_torque=tau,
        contact=contact_state)


def control_step(robot: RobotState, action: torch.Tensor,
                 params: DynamicsParams, cfg: SimConfig, h_fn,
                 control_mode: MotorControlMode = MotorControlMode.POSITION
                 ) -> RobotState:
    """One control step = ``action_repeat`` substeps with action
    interpolation (minitaur.Step:248-258 + ProcessAction lerp:1384-1401)."""
    if cfg.enable_clip_motor_commands and \
            control_mode == MotorControlMode.POSITION:
        # a1._ClipMotorCommands:440-457: clamp the change per control step
        q = robot.state.q
        action = torch.minimum(torch.maximum(
            action, q - cfg.max_motor_angle_change),
            q + cfg.max_motor_angle_change)

    prev_action = robot.last_action
    n = cfg.action_repeat
    hybrid = control_mode == MotorControlMode.HYBRID
    # HYBRID: interpolate only the position slot; gains/vel/ff are held
    # over the repeat window; last_action stays the (12,) position target.
    a5 = action.reshape(12, 5) if hybrid else None
    q_des = a5[:, 0] if hybrid else action
    for i in range(n):
        if cfg.enable_action_interpolation and \
                control_mode != MotorControlMode.TORQUE:
            t = (i + 1.0) / n
            q_t = prev_action + t * (q_des - prev_action)
        else:
            q_t = q_des
        cmd = (torch.cat([q_t[:, None], a5[:, 1:]], dim=1).reshape(60)
               if hybrid else q_t)
        robot = substep(robot, cmd, params, cfg, h_fn, control_mode)
    return robot.replace(last_action=q_des)
