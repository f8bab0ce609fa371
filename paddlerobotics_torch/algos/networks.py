"""The SAC actor network (PyTorch port of the JAX package's Actor).

A 2×256 ReLU MLP with mean and clamped log-std heads (LOG_SIG_MIN/MAX
−20/2, mujoco_model.py:21-22). The four layers keep the flax module's
order (Dense_0..Dense_3) so ``convert.actor_from_flax`` maps one onto the
other. It runs on the card unless the caller asks for another device
(``core/device.resolve_device``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.utils.init import flax_default_

LOG_SIG_MIN = -20.0
LOG_SIG_MAX = 2.0


class Actor(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 256,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.dense = nn.ModuleList([
            nn.Linear(obs_dim, hidden, device=device),
            nn.Linear(hidden, hidden, device=device),
            nn.Linear(hidden, action_dim, device=device),   # mean
            nn.Linear(hidden, action_dim, device=device),   # log std
        ])
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.dense[0](obs))
        x = torch.relu(self.dense[1](x))
        mean = self.dense[2](x)
        log_std = torch.clamp(self.dense[3](x), LOG_SIG_MIN, LOG_SIG_MAX)
        return mean, log_std
