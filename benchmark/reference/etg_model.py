"""ETG readout → per-leg foot deltas → joint-space residual gait.

Port of the JAX package's ``etg/model.py``: the leg phase pairing, the
stance offsets, the default feet, and the per-env functions ``foot_deltas``
and ``etg_joint_residual`` (readout w·V(t)+b → foot offsets → IK − default
pose, the reference's ETG_act). The batched env computes the same residual
in its own SoA form (``envs/batched_env._etg_residual``); ``gait_table``
runs that form over the steps of an episode, so an exported table replays
the env's residual bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.config import ETGConfig
from benchmark.reference.device import resolve_device
from benchmark.reference import oscillator
from benchmark.reference import a1_model as a1

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


def foot_deltas(w: torch.Tensor, b: torch.Tensor, v_a: torch.Tensor,
                v_b: torch.Tensor, cfg: ETGConfig) -> torch.Tensor:
    """Per-leg (4,3) foot-position deltas from the readout w (3,H), b (3,)
    and the two phase features V(t), V(t+T/2) (H,)."""
    d_a = w @ v_a + b          # (3,) for phase group 0
    d_b = w @ v_b + b          # (3,) for phase group 1
    group = torch.as_tensor(leg_phase_group(cfg.pairing), device=w.device)
    d = torch.where(group[:, None] == 0, d_a[None, :], d_b[None, :])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=w.device)
    lateral = f32(STANCE_OFFSET_Y) + \
        (cfg.step_y - REFERENCE_STEP_Y) * f32(LATERAL_SIGN)
    return d + torch.stack([f32(STANCE_OFFSET_X), lateral,
                            torch.zeros(4, device=w.device)], dim=1)


def etg_joint_residual(w: torch.Tensor, b: torch.Tensor, v_a: torch.Tensor,
                       v_b: torch.Tensor, cfg: ETGConfig) -> torch.Tensor:
    """12-dim joint-space gait residual, the reference's ETG_act."""
    feet = torch.as_tensor(default_foot_positions().astype(np.float32),
                           device=w.device) + foot_deltas(w, b, v_a, v_b, cfg)
    q = a1.joint_angles_from_foot_positions(feet)
    return q - torch.as_tensor(a1.INIT_MOTOR_ANGLES.astype(np.float32),
                               device=w.device)


def phase_tables(cfg: ETGConfig, n_steps: int, device=None):
    """(V(t_k), V(t_k+T/2)) for the control steps of an episode, (n,H)
    each, on ``resolve_device(device)``."""
    ts = torch.arange(n_steps, device=resolve_device(device)) * cfg.dt
    return oscillator.update(ts, cfg), oscillator.update(ts + cfg.T / 2.0,
                                                         cfg)


def gait_table(w: torch.Tensor, b: torch.Tensor, cfg: ETGConfig,
               n_steps: int) -> torch.Tensor:
    """(n_steps, 12) ETG_act table for the readout w (3,H), b (3,), on w's
    device, the deployment replay table of env_test.py. Row t is the
    residual a one-env batched env applies at step t
    (``BatchedQuadrupedEnv._etg_residual``, column 0), computed by that
    function step by step: its readout's sum order depends on the batch, so
    this is what makes the table equal the env's residual bit for bit."""
    from benchmark.reference.config import QuadrupedConfig
    from benchmark.reference.env import BatchedQuadrupedEnv

    dev = w.device
    env = BatchedQuadrupedEnv(QuadrupedConfig(etg=cfg), 1, device=dev)
    w1 = w.to(torch.float32)[..., None]
    b1 = b.to(device=dev, dtype=torch.float32)[:, None]
    return torch.stack([
        env._etg_residual(w1, b1, torch.full((1,), t, dtype=torch.int32,
                                             device=dev))[0][:, 0]
        for t in range(n_steps)])
