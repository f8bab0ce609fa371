"""Policy + gait export for deployment (PyTorch port of the JAX package's
``deploy/policy_export.py``).

- env_test.py:30-60 rolls a fixed ETG 600 steps and saves
  ``gait_action_list_*.npy`` (600,12) for on-robot replay →
  ``export_gait_table``.
- deployment/test.py:48-105 loads the SAC policy + gait npy and runs
  ``predict(obs)*act_bound + ETG[i]`` at a fixed rate → ``export_policy_fn``
  returns one module, (obs, i) → 12 joint targets, with the gait table
  held on the card; ``aot_compile_policy`` exports it ahead of time with
  ``torch.export`` (the JAX package's AOT ``lower().compile()``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.etg import model as etg_model
from paddlerobotics_torch.sim import a1_model as a1


def export_gait_table(cfg: QuadrupedConfig, etg_w, etg_b,
                      n_steps: int = 600, path: str | None = None,
                      device=None) -> np.ndarray:
    """(n_steps, 12) joint-space ETG_act table (env_test.py equivalent),
    computed on ``resolve_device(device)``.

    Resolves pairing='auto' against the task mode as the env does, so a
    gallop-trained policy exports the bound-gait table, not trot."""
    dev = resolve_device(device)
    etg_cfg = etg_model.resolve_pairing(cfg.etg, cfg.task.task_mode)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    table = etg_model.gait_table(f32(etg_w), f32(etg_b), etg_cfg,
                                 n_steps).cpu().numpy()
    if path:
        np.save(path, table)
    return table


class DeployPolicy(nn.Module):
    """policy(obs, i) → 12 joint targets = default pose + gait[i mod n] +
    tanh(mean(obs))·act_bound (deployment/test.py:95-99). ``obs`` is one
    observation (obs_dim,); ``i`` an int or a 0-d integer tensor."""

    def __init__(self, actor: nn.Module, gait_table, act_bound, device=None):
        super().__init__()
        dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        self.actor = actor
        self.register_buffer("table", f32(gait_table))
        self.register_buffer("bound", f32(act_bound))
        self.register_buffer("base", f32(a1.INIT_MOTOR_ANGLES))

    @property
    def device(self) -> torch.device:
        return self.table.device

    def forward(self, obs: torch.Tensor, i) -> torch.Tensor:
        i = torch.as_tensor(i, dtype=torch.int64, device=self.table.device)
        row = torch.index_select(self.table, 0,
                                 torch.remainder(i, self.table.shape[0])
                                 .reshape(1))[0]
        mean, _ = self.actor(obs[None, :])
        return self.base + row + torch.tanh(mean[0]) * self.bound


def export_policy_fn(actor: nn.Module, gait_table, act_bound,
                     device=None) -> DeployPolicy:
    """The real-time control function for a trained actor (e.g.
    ``SACState.actor``) on ``resolve_device(device)``. It holds a frozen
    copy of the actor, as the JAX function closes over its parameters: a
    learner that goes on updating ``actor`` does not change it."""
    dev = resolve_device(device)
    frozen = copy.deepcopy(actor).to(dev).requires_grad_(False)
    return DeployPolicy(frozen, gait_table, act_bound, device=dev).eval()


def aot_compile_policy(policy: DeployPolicy, obs_dim: int) -> nn.Module:
    """Ahead-of-time export for latency-critical serving (no first-call
    tracing in the control loop, deployment/test.py:93): ``torch.export``
    of the policy at one observation and a 0-d step index."""
    dev = policy.device
    prog = torch.export.export(
        policy, (torch.zeros(obs_dim, device=dev),
                 torch.zeros((), dtype=torch.int64, device=dev)))
    return prog.module()
