"""Shaped reward with the reference's per-channel structure.

Port of the JAX package's ``envs/reward.py``: channel names and weights
from Param_Dict (ETGRL/train.py:255-261), the global scale from --reward_p,
the velocity target from --vel_d; every channel is returned in `info`.
All reductions are over axis 0, so the batch-minor (k, B) layout flows
straight through.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference.config import RewardConfig

REWARD_CHANNELS = ("torso", "up", "feet", "tau", "stand", "badfoot",
                   "footcontact", "lateral", "velx", "rew")


def compute_reward(cfg: RewardConfig,
                   dx: torch.Tensor,
                   velx: torch.Tensor,
                   up_z: torch.Tensor,
                   drpy: torch.Tensor,
                   torques: torch.Tensor,
                   foot_clearance: torch.Tensor,
                   swing_mask: torch.Tensor,
                   stance_mask: torch.Tensor,
                   foot_contacts: torch.Tensor,
                   knee_contacts: torch.Tensor,
                   base_contact: torch.Tensor,
                   y_pos: torch.Tensor | float = 0.0,
                   vel_y: torch.Tensor | float = 0.0,
                   yaw: torch.Tensor | float = 0.0,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-step reward and info channels (see the JAX module for terms)."""
    f32 = torch.float32
    # torso: forward progress toward vel_d, capped
    r_torso = 2.0 * torch.clamp(dx, max=cfg.vel_d * 0.026 * 2.0)
    # up: uprightness + rotational calmness
    r_up = ((up_z - 1.0) - 0.05 * torch.sum(drpy[:2] ** 2, dim=0)) / 3.0
    # feet: swing feet should clear the ground (up to 6 cm counts)
    clear = torch.clamp(foot_clearance, 0.0, 0.06) / 0.06
    n_swing = torch.clamp(torch.sum(swing_mask, dim=0), min=1.0)
    r_feet = torch.sum(clear * swing_mask, dim=0) / n_swing * (0.026 * 5 / 3)
    # tau: energy penalty
    r_tau = -1e-4 * (5.0 / 7.0) * torch.sum(torques ** 2, dim=0)
    # stand: stillness shaping (weight 0 by default)
    r_stand = -torch.abs(velx) * 0.026
    # badfoot: knee or trunk illegal contact penalty
    r_badfoot = -(torch.sum(knee_contacts.to(f32), dim=0)
                  + base_contact.to(f32)) * 0.013
    # footcontact: stance feet must actually touch the ground
    miss = stance_mask * (1.0 - foot_contacts.to(f32))
    r_footcontact = -torch.sum(miss, dim=0) * 0.013
    # lateral: centerline tracking (balance-beam shaping; weight 0 default)
    r_lateral = -(torch.abs(torch.as_tensor(y_pos)) / 0.15
                  + 0.5 * torch.abs(torch.as_tensor(vel_y))
                  + 0.5 * torch.abs(torch.as_tensor(yaw))) * 0.026

    reward = cfg.reward_p * (
        cfg.torso * r_torso
        + cfg.up * r_up
        + cfg.feet * r_feet
        + cfg.tau * r_tau
        + cfg.stand * r_stand
        + cfg.badfoot * r_badfoot
        + cfg.footcontact * r_footcontact
        + cfg.lateral * r_lateral)

    info = {
        "torso": r_torso, "up": r_up, "feet": r_feet, "tau": r_tau,
        "stand": r_stand, "badfoot": r_badfoot, "footcontact": r_footcontact,
        "lateral": r_lateral, "velx": velx, "rew": reward,
    }
    return reward, info
