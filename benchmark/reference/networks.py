"""Actor and critic networks: the benchmark's frozen plain copy of the
port's ``algos/networks.py`` (the MLP actor and the twin critic; no mesh, no
recurrent actor).

Actor = 2×256 ReLU MLP with mean and clamped log-std heads (LOG_SIG_MIN/MAX
−20/2, mujoco_model.py:21-22); Critic = twin Q MLPs on concat(obs, act)
(mujoco_model.py:63-89), ``Dense_0..2`` = Q1, ``Dense_3..5`` = Q2.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from benchmark.reference.device import resolve_device
from benchmark.reference.columns import linear
from benchmark.reference.init import flax_default_

LOG_SIG_MIN = -20.0
LOG_SIG_MAX = 2.0
LN_EPS = 1e-6           # flax LayerNorm's epsilon


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
        x = torch.relu(linear(self.dense[0], obs))
        x = torch.relu(linear(self.dense[1], x))
        mean = linear(self.dense[2], x)
        log_std = torch.clamp(linear(self.dense[3], x), LOG_SIG_MIN,
                              LOG_SIG_MAX)
        return mean, log_std


class Critic(nn.Module):
    """Twin Q networks: Dense_0..2 = Q1, Dense_3..5 = Q2.

    ``layer_norm=True`` inserts LayerNorm (LN_0, LN_1 on Q1; LN_2, LN_3 on
    Q2) before each hidden ReLU, the plasticity fix for high update-to-data
    ratios (SACConfig.ln_critic)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 256,
                 layer_norm: bool = False,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.layer_norm = layer_norm
        i = obs_dim + action_dim
        dims = [(i, hidden), (hidden, hidden), (hidden, 1)] * 2
        for n, (a, b) in enumerate(dims):
            setattr(self, f"Dense_{n}", nn.Linear(a, b, device=device))
        if layer_norm:
            for n in range(4):
                setattr(self, f"LN_{n}",
                        nn.LayerNorm(hidden, eps=LN_EPS, device=device))
        if generator is not None:
            flax_default_(self, generator)

    def _q(self, x, dense, lns):
        ln = (lambda h, n: getattr(self, f"LN_{n}")(h)) if self.layer_norm \
            else (lambda h, n: h)
        d = lambda n, v: linear(getattr(self, f"Dense_{dense[n]}"), v)
        h = torch.relu(ln(d(0, x), lns[0]))
        h = torch.relu(ln(d(1, h), lns[1]))
        return d(2, h)

    def forward(self, obs: torch.Tensor, act: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs, act], dim=-1)
        return self._q(x, (0, 1, 2), (0, 1)), self._q(x, (3, 4, 5), (2, 3))


def critic_apply_fused(critic: Critic, obs: torch.Tensor, act: torch.Tensor,
                       bf16: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin-Q forward with the two Q-MLPs stacked into one batched product
    per layer (JAX ``critic_apply_fused``): the same function as
    ``critic(obs, act)`` on the same weights, in three products instead of
    six. LayerNorm is written out as ``(h−μ)·rsqrt(var+1e-6)·scale+bias``.

    ``bf16=True`` rounds each product's inputs to bfloat16 and multiplies
    them in float32, so the sums and the result stay float32 as XLA's
    ``preferred_element_type=float32`` keeps them (a bf16 ``torch.matmul``
    would round its output to bf16); parameters and LayerNorm stay float32.

    A pair of layers split over a mesh's model axis multiplies its rows and
    gathers the whole (2, b, out) output (``parallel/sharding``)."""
    x = torch.cat([obs, act], dim=-1)

    def stacked(a, b):
        la, lb = getattr(critic, f"Dense_{a}"), getattr(critic, f"Dense_{b}")
        return (torch.stack([la.weight, lb.weight]),
                torch.stack([la.bias, lb.bias])[:, None])

    def product(h, a, b, first=False):
        w, bias = stacked(a, b)
        return (torch.einsum("bi,koi->kbo", rnd(h), rnd(w)) if first else
                torch.bmm(rnd(h), rnd(w).transpose(1, 2))) + bias

    def rnd(t):
        return t.to(torch.bfloat16).to(torch.float32) if bf16 else t

    def ln(h, a, b):
        la, lb = getattr(critic, f"LN_{a}"), getattr(critic, f"LN_{b}")
        scale = torch.stack([la.weight, lb.weight])[:, None]
        bias = torch.stack([la.bias, lb.bias])[:, None]
        mu = torch.mean(h, dim=-1, keepdim=True)
        var = torch.mean((h - mu) ** 2, dim=-1, keepdim=True)
        return (h - mu) * torch.rsqrt(var + LN_EPS) * scale + bias

    h = product(x, 0, 3, first=True)            # weights (2, o, i)
    if critic.layer_norm:
        h = ln(h, 0, 2)
    h = torch.relu(h)
    h = product(h, 1, 4)
    if critic.layer_norm:
        h = ln(h, 1, 3)
    h = torch.relu(h)
    q = product(h, 2, 5)
    return q[0], q[1]
