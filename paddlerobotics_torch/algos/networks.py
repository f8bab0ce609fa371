"""The SAC actor network (PyTorch port of the JAX package's Actor).

A 2×256 ReLU MLP with mean and clamped log-std heads (LOG_SIG_MIN/MAX
−20/2, mujoco_model.py:21-22). The four layers keep the flax module's
order (Dense_0..Dense_3) so ``convert.actor_from_flax`` maps one onto the
other.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

LOG_SIG_MIN = -20.0
LOG_SIG_MAX = 2.0


class Actor(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 256,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense = nn.ModuleList([
            nn.Linear(obs_dim, hidden, device=device),
            nn.Linear(hidden, hidden, device=device),
            nn.Linear(hidden, action_dim, device=device),   # mean
            nn.Linear(hidden, action_dim, device=device),   # log std
        ])
        if generator is not None:
            # flax's Dense default: lecun-normal kernels, zero biases
            with torch.no_grad():
                for lin in self.dense:
                    std = 1.0 / math.sqrt(lin.in_features)
                    w = torch.randn(lin.weight.shape, generator=generator,
                                    device=generator.device)
                    lin.weight.copy_(w * std)
                    lin.bias.zero_()

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.dense[0](obs))
        x = torch.relu(self.dense[1](x))
        mean = self.dense[2](x)
        log_std = torch.clamp(self.dense[3](x), LOG_SIG_MIN, LOG_SIG_MAX)
        return mean, log_std
