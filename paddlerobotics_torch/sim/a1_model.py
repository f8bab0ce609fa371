"""Unitree A1 robot constants (numpy), an own copy of the JAX package's.

Geometry/gain constants mirror the reference's A1 description
(QuadrupedalRobots/ETGRL/deployment/robots/a1.py:62-91) and the public
Unitree a1.urdf (mass/inertia blocks), and the leg kinematics (FK, IK,
analytic Jacobian) as plain functions on float32 tensors with a trailing
component axis. The batched env's ETG residual does its own SoA leg IK
(``ops/etg_residual.soa_ik``); these serve the per-env residual
(``etg/model.etg_joint_residual``), the deployment estimator and the tests.

Leg order everywhere: 0=FR, 1=FL, 2=RR, 3=RL (a1.py MOTOR_NAMES).
Each leg: [abduction(hip, rot-x), hip pitch(upper, rot-y), knee(lower, rot-y)].
"""

from __future__ import annotations

import numpy as np
import torch

NUM_LEGS = 4
NUM_MOTORS = 12

# --- geometry (a1.py:63-73 + unitree a1.urdf joint origins) ------------------
L_UP = 0.2          # upper (thigh) link length
L_LOW = 0.2         # lower (calf) link length
L_HIP = 0.08505     # hip (abduction) lateral offset
FOOT_RADIUS = 0.02  # foot collision sphere radius

COM_OFFSET = -np.array([0.012731, 0.002186, 0.000515])
HIP_OFFSETS = np.array(
    [[0.183, -0.047, 0.0],
     [0.183, 0.047, 0.0],
     [-0.183, -0.047, 0.0],
     [-0.183, 0.047, 0.0]]) + COM_OFFSET

# +1 for left legs (FL, RL), -1 for right (FR, RR): l_hip_sign = (-1)**(i+1)
HIP_SIGNS = np.array([-1.0, 1.0, -1.0, 1.0])

# Default pose & limits (a1.py:83, ACTION_CONFIG:186-223, train.py:51)
INIT_MOTOR_ANGLES = np.array([0.0, 0.9, -1.8] * NUM_LEGS)
MOTOR_LOWER = np.array([-0.802851455917, -1.0471975512, -2.69653369433] * NUM_LEGS)
MOTOR_UPPER = np.array([0.802851455917, 4.18879020479, -0.916297857297] * NUM_LEGS)
INIT_POSITION = np.array([0.0, 0.0, 0.32])
MAX_MOTOR_ANGLE_CHANGE_PER_STEP = 0.2  # a1.py:62

# PD gains (a1.py:75-80)
MOTOR_KP = np.array([100.0, 100.0, 100.0] * NUM_LEGS)
MOTOR_KD = np.array([1.0, 2.0, 2.0] * NUM_LEGS)
TORQUE_LIMIT = np.full(NUM_MOTORS, 33.5)

# --- mass/inertia (public unitree a1.urdf) -----------------------------------
# Trunk
TRUNK_MASS = 4.713
TRUNK_INERTIA = np.array(
    [[0.01683993, 8.3902e-05, 0.000597679],
     [8.3902e-05, 0.056579028, 2.5075e-05],
     [0.000597679, 2.5075e-05, 0.064713601]])
TRUNK_COM = np.array([0.012731, 0.002186, 0.000515])  # vs geometric center

# Hip (abduction) link — values for a right-side leg; y mirrors for left.
HIP_MASS = 0.696
HIP_COM_R = np.array([-0.003311, -0.000635, 3.1e-05])
HIP_INERTIA = np.array(
    [[0.000469246, 9.409e-06, -3.42e-07],
     [9.409e-06, 0.00080749, -4.66e-07],
     [-3.42e-07, -4.66e-07, 0.000552929]])

# Thigh (upper) link — right side; y mirrors for left.
THIGH_MASS = 1.013
THIGH_COM_R = np.array([-0.003237, -0.022327, -0.027326])
THIGH_INERTIA = np.array(
    [[0.005529065, -4.825e-06, 0.000343869],
     [-4.825e-06, 0.005139339, -2.2448e-05],
     [0.000343869, -2.2448e-05, 0.001367788]])

# Calf (lower) link + rigidly attached foot sphere, combined.
CALF_MASS = 0.166
CALF_COM = np.array([0.006435, 0.0, -0.107388])
CALF_INERTIA = np.array(
    [[0.002997972, 0.0, -0.000141163],
     [0.0, 0.003014022, 0.0],
     [-0.000141163, 0.0, 3.2426e-05]])
FOOT_MASS = 0.06
FOOT_OFFSET_IN_CALF = np.array([0.0, 0.0, -L_LOW])

TOTAL_MASS = TRUNK_MASS + 4 * (HIP_MASS + THIGH_MASS + CALF_MASS + FOOT_MASS)

# Joint attachment points (parent-frame origins, from a1.urdf): the trunk
# frame sits at its URDF origin so hips sit at the raw offsets.
HIP_JOINT_IN_TRUNK = np.array(
    [[0.183, -0.047, 0.0],
     [0.183, 0.047, 0.0],
     [-0.183, -0.047, 0.0],
     [-0.183, 0.047, 0.0]])
# thigh joint in hip frame: lateral offset only (sign per side)
THIGH_JOINT_IN_HIP_Y = 0.08505
# calf joint in thigh frame
CALF_JOINT_IN_THIGH = np.array([0.0, 0.0, -L_UP])


def combined_calf_inertia():
    """Calf + foot sphere combined mass, COM and inertia (about joint frame).

    Returns (mass, com, inertia_about_com).
    """
    m1, m2 = CALF_MASS, FOOT_MASS
    c1, c2 = CALF_COM, FOOT_OFFSET_IN_CALF
    m = m1 + m2
    com = (m1 * c1 + m2 * c2) / m
    # foot sphere inertia about its own center
    i_foot = (2.0 / 5.0) * m2 * FOOT_RADIUS ** 2 * np.eye(3)

    def parallel_axis(inertia, mass, d):
        return inertia + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    inertia = (parallel_axis(CALF_INERTIA, m1, c1 - com)
               + parallel_axis(i_foot, m2, c2 - com))
    return m, com, inertia


def _c(a, like: torch.Tensor) -> torch.Tensor:
    """A numpy constant as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def foot_position_in_hip_frame(angles: torch.Tensor,
                               l_hip_sign) -> torch.Tensor:
    """FK: leg joint angles (...,3) → foot position in hip frame (...,3)
    (a1.py:113-129); ``l_hip_sign`` broadcasts against ``angles[..., 0]``."""
    theta_ab, theta_hip, theta_knee = angles[..., 0], angles[..., 1], \
        angles[..., 2]
    l_hip = L_HIP * torch.as_tensor(l_hip_sign, dtype=angles.dtype,
                                    device=angles.device)
    leg_distance = torch.sqrt(
        L_UP ** 2 + L_LOW ** 2 + 2 * L_UP * L_LOW * torch.cos(theta_knee))
    eff_swing = theta_hip + theta_knee / 2
    off_x = -leg_distance * torch.sin(eff_swing)
    off_z_hip = -leg_distance * torch.cos(eff_swing)
    off_y = torch.cos(theta_ab) * l_hip - torch.sin(theta_ab) * off_z_hip
    off_z = torch.sin(theta_ab) * l_hip + torch.cos(theta_ab) * off_z_hip
    return torch.stack([off_x, off_y, off_z], dim=-1)


def foot_position_in_hip_frame_to_joint_angle(
        foot_position: torch.Tensor, l_hip_sign) -> torch.Tensor:
    """IK: foot position in hip frame (...,3) → joint angles (...,3)
    (a1.py:97-110, the acos argument clipped)."""
    x, y, z = foot_position[..., 0], foot_position[..., 1], \
        foot_position[..., 2]
    l_hip = L_HIP * torch.as_tensor(l_hip_sign, dtype=foot_position.dtype,
                                    device=foot_position.device)
    cos_knee = (x ** 2 + y ** 2 + z ** 2 - l_hip ** 2 - L_LOW ** 2
                - L_UP ** 2) / (2 * L_LOW * L_UP)
    theta_knee = -torch.acos(torch.clamp(cos_knee, -1.0, 1.0))
    l = torch.sqrt(torch.clamp(
        L_UP ** 2 + L_LOW ** 2 + 2 * L_UP * L_LOW * torch.cos(theta_knee),
        min=1e-12))
    theta_hip = torch.asin(torch.clamp(-x / l, -1.0, 1.0)) - theta_knee / 2
    c1 = l_hip * y - l * torch.cos(theta_hip + theta_knee / 2) * z
    s1 = l * torch.cos(theta_hip + theta_knee / 2) * y + l_hip * z
    theta_ab = torch.atan2(s1, c1)
    return torch.stack([theta_ab, theta_hip, theta_knee], dim=-1)


def foot_positions_in_base_frame(motor_angles: torch.Tensor) -> torch.Tensor:
    """All-legs FK: (...,12) motor angles → (...,4,3) foot positions in the
    base (COM) frame (a1.py:167-173)."""
    angles = motor_angles.reshape(motor_angles.shape[:-1] + (4, 3))
    pos = foot_position_in_hip_frame(angles, _c(HIP_SIGNS, motor_angles))
    return pos + _c(HIP_OFFSETS, motor_angles)


def joint_angles_from_foot_positions(foot_positions: torch.Tensor
                                     ) -> torch.Tensor:
    """All-legs IK: (...,4,3) foot positions in the base frame → (...,12)
    angles (a1.py:464-497)."""
    rel = foot_positions - _c(HIP_OFFSETS, foot_positions)
    angles = foot_position_in_hip_frame_to_joint_angle(
        rel, _c(HIP_SIGNS, foot_positions))
    return angles.reshape(foot_positions.shape[:-2] + (12,))


def analytical_leg_jacobian(leg_angles: torch.Tensor,
                            l_hip_sign) -> torch.Tensor:
    """Analytic 3×3 foot Jacobian per leg (a1.py:132-159): (...,3) angles
    → (...,3,3)."""
    t1, t2, t3 = leg_angles[..., 0], leg_angles[..., 1], leg_angles[..., 2]
    l_hip = L_HIP * torch.as_tensor(l_hip_sign, dtype=leg_angles.dtype,
                                    device=leg_angles.device)
    l_eff = torch.sqrt(L_UP ** 2 + L_LOW ** 2
                       + 2 * L_UP * L_LOW * torch.cos(t3))
    t_eff = t2 + t3 / 2
    s1, c1 = torch.sin(t1), torch.cos(t1)
    s_eff, c_eff = torch.sin(t_eff), torch.cos(t_eff)
    dl = L_LOW * L_UP * torch.sin(t3) / l_eff
    zero = torch.zeros_like(t1)
    row0 = torch.stack([zero, -l_eff * c_eff,
                        dl * s_eff - l_eff * c_eff / 2], dim=-1)
    row1 = torch.stack([-l_hip * s1 + l_eff * c1 * c_eff,
                        -l_eff * s1 * s_eff,
                        -dl * s1 * c_eff - l_eff * s1 * s_eff / 2], dim=-1)
    row2 = torch.stack([l_hip * c1 + l_eff * s1 * c_eff,
                        l_eff * s_eff * c1,
                        dl * c1 * c_eff + l_eff * s_eff * c1 / 2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
