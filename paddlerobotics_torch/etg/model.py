"""ETG gait constants: leg phase pairing, stance offsets, default feet.

Port of the constants and host helpers of the JAX package's
``etg/model.py``; the batched env computes the joint residual itself
(``envs/batched_env._etg_residual``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from paddlerobotics_torch.core.config import ETGConfig
from paddlerobotics_torch.sim import a1_model as a1

# Diagonal trot pairing: FR(0) & RL(3) in phase, FL(1) & RR(2) half-period.
LEG_PHASE_GROUP = np.array([0, 1, 1, 0])
# Pairings of the 2-phase cycle (leg order FR FL RR RL): trot mirrors
# diagonals; bound mirrors front vs rear pairs (the gallop task's gait).
PAIRINGS = {"trot": LEG_PHASE_GROUP, "bound": np.array([0, 0, 1, 1])}
# Lateral offset sign: right legs (FR, RR) outward is −y, left legs +y.
LATERAL_SIGN = np.array([-1.0, 1.0, -1.0, 1.0])

# Per-leg stance-foot offsets relative to FK(INIT_MOTOR_ANGLES), recovered
# from the reference's golden gait at step_y=0.05; the y column is
# parameterized as measured + sign·(step_y−0.05).
STANCE_OFFSET_X = np.array([0.0, 0.0, 0.006, 0.006])     # FR FL RR RL
STANCE_OFFSET_Y = np.array([-0.015764, 0.018136, -0.005764, 0.005136])
REFERENCE_STEP_Y = 0.05


def leg_phase_group(pairing: str) -> np.ndarray:
    """(4,) phase-group indices for a pairing name ('auto' = trot)."""
    if pairing == "auto":
        pairing = "trot"
    try:
        return PAIRINGS[pairing]
    except KeyError:
        raise ValueError(f"unknown ETG pairing {pairing!r}; choose from "
                         f"{('auto', *PAIRINGS)}") from None


def resolve_pairing(etg_cfg: ETGConfig, task_mode: str) -> ETGConfig:
    """Resolve pairing='auto' against the task: the gallop flat task
    trains the bound gait, every other task the reference trot."""
    if etg_cfg.pairing != "auto":
        leg_phase_group(etg_cfg.pairing)   # validate eagerly
        return etg_cfg
    return dataclasses.replace(
        etg_cfg, pairing="bound" if task_mode == "gallop" else "trot")


def default_foot_positions() -> np.ndarray:
    """Foot positions in base frame at the default standing pose, (4,3)."""
    q = a1.INIT_MOTOR_ANGLES.reshape(4, 3)
    out = np.zeros((4, 3))
    for i in range(4):
        t_ab, t_hip, t_knee = q[i]
        l_hip = a1.L_HIP * a1.HIP_SIGNS[i]
        leg = np.sqrt(a1.L_UP**2 + a1.L_LOW**2 +
                      2 * a1.L_UP * a1.L_LOW * np.cos(t_knee))
        eff = t_hip + t_knee / 2
        off_x = -leg * np.sin(eff)
        off_z_hip = -leg * np.cos(eff)
        off_y = np.cos(t_ab) * l_hip - np.sin(t_ab) * off_z_hip
        off_z = np.sin(t_ab) * l_hip + np.cos(t_ab) * off_z_hip
        out[i] = [off_x, off_y, off_z]
    return out + a1.HIP_OFFSETS
