"""The deployment policy and the software-in-the-loop tick, written after
the port's ``deploy/policy_export.DeployPolicy`` and
``deploy/realtime.SimRobotIO`` (deployment/test.py:48-105): targets =
default pose + gait[i mod n] + tanh(mean(obs))·act_bound, applied to a B=1
env as the residual from the default pose, rounded once from float64."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference import a1_model as a1
from benchmark.reference import etg_model


class DeployPolicy(nn.Module):
    def __init__(self, actor: nn.Module, gait_table: torch.Tensor,
                 act_bound, device):
        super().__init__()
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                        device=device)
        self.actor = actor
        self.table = f32(gait_table)
        self.bound = f32(act_bound)
        self.base = f32(a1.INIT_MOTOR_ANGLES)

    def forward(self, obs: torch.Tensor, i: int) -> torch.Tensor:
        row = self.table[i % self.table.shape[0]]
        mean, _ = self.actor(obs[None, :])
        return self.base + row + torch.tanh(mean[0]) * self.bound


def gait_table(cfg, w, b, n_steps: int) -> torch.Tensor:
    """(n_steps, 12) residual table of the readout (w, b) under the
    configuration's pairing, computed by the reference env's residual as
    the port's ``export_gait_table`` is."""
    etg_cfg = etg_model.resolve_pairing(cfg.etg, cfg.task.task_mode)
    return etg_model.gait_table(w.float(), b.float(), etg_cfg, n_steps)


def residual_action(target: torch.Tensor, B: int) -> torch.Tensor:
    """The env's action for joint targets: target − default pose, in
    float64 and rounded once, for every env."""
    init = torch.as_tensor(a1.INIT_MOTOR_ANGLES, device=target.device)
    return (target.double() - init).float()[None, :].expand(B, 12)
