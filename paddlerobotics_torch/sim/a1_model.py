"""Unitree A1 robot constants (numpy), an own copy of the JAX package's.

Geometry/gain constants mirror the reference's A1 description
(QuadrupedalRobots/ETGRL/deployment/robots/a1.py:62-91) and the public
Unitree a1.urdf (mass/inertia blocks). Only the constants are ported: the
batched env does its own leg IK (``envs/batched_env._soa_ik``).

Leg order everywhere: 0=FR, 1=FL, 2=RR, 3=RL (a1.py MOTOR_NAMES).
Each leg: [abduction(hip, rot-x), hip pitch(upper, rot-y), knee(lower, rot-y)].
"""

from __future__ import annotations

import numpy as np

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
