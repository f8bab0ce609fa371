"""Motor models: PD (Laikago/A1) and DC (Minitaur) torque laws as pure
functions of tensors (port of the JAX package's ``sim/motor.py``,
laikago_motor.py:103-175 and minitaur_motor.py:40-191)."""

from __future__ import annotations

import enum

import torch


class MotorControlMode(enum.IntEnum):
    """Mirrors rlschool robot_config.MotorControlMode."""

    POSITION = 0
    TORQUE = 1
    HYBRID = 2
    PWM = 3


# Hybrid command layout (laikago_motor.py:33-37): per motor 5-tuple
# (position, position_gain, velocity, velocity_gain, torque).
HYBRID_DIM = 5


def _limit(tau, torque_limits):
    if torque_limits is None:
        return tau
    lim = torch.as_tensor(torque_limits, dtype=tau.dtype, device=tau.device)
    return torch.minimum(torch.maximum(tau, -lim), lim)


def pd_torque(motor_commands: torch.Tensor,
              motor_angle: torch.Tensor,
              motor_velocity: torch.Tensor,
              kp: torch.Tensor,
              kd: torch.Tensor,
              torque_limits: torch.Tensor | None = None,
              strength_ratios: torch.Tensor | float = 1.0) -> torch.Tensor:
    """POSITION-mode PD torque: τ = −kp (q − q*) − kd q̇
    (laikago_motor.py:165-175), on the latency-delayed observations."""
    tau = -kp * (motor_angle - motor_commands) - kd * motor_velocity
    return _limit(strength_ratios * tau, torque_limits)


def hybrid_torque(motor_commands: torch.Tensor,
                  motor_angle: torch.Tensor,
                  motor_velocity: torch.Tensor,
                  torque_limits: torch.Tensor | None = None,
                  strength_ratios: torch.Tensor | float = 1.0
                  ) -> torch.Tensor:
    """HYBRID-mode torque from a (..., 60) command vector
    (laikago_motor.py:152-166)."""
    cmd = motor_commands.reshape(motor_commands.shape[:-1] + (-1, HYBRID_DIM))
    q_des, kp, qd_des, kd, tau_ff = cmd.unbind(-1)
    tau = -kp * (motor_angle - q_des) - kd * (motor_velocity - qd_des) + tau_ff
    return _limit(strength_ratios * tau, torque_limits)


def torque_passthrough(motor_commands: torch.Tensor,
                       torque_limits: torch.Tensor | None = None,
                       strength_ratios: torch.Tensor | float = 1.0
                       ) -> torch.Tensor:
    """TORQUE mode (laikago_motor.py:136-139)."""
    return _limit(strength_ratios * motor_commands, torque_limits)


def dc_motor_torque(pwm: torch.Tensor,
                    true_motor_velocity: torch.Tensor,
                    voltage: float = 16.0,
                    resistance: float = 0.186,
                    torque_constant: float = 0.0954,
                    viscous_damping: float = 0.0,
                    current_limit: float = 57.0) -> torch.Tensor:
    """Minitaur DC motor torque from PWM (minitaur_motor.py:27-64): voltage
    clip → back-EMF → current → torque, with viscous damping."""
    observed_voltage = torch.clamp(pwm * voltage, -voltage, voltage)
    back_emf = (torque_constant + viscous_damping) * true_motor_velocity
    current = (observed_voltage - back_emf) / resistance
    current = torch.clamp(current, -current_limit, current_limit)
    return current * torque_constant
