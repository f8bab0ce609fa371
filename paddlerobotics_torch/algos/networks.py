"""Actor and critic networks (PyTorch port of the JAX package's networks).

Actor = 2×256 ReLU MLP with mean and clamped log-std heads (LOG_SIG_MIN/MAX
−20/2, mujoco_model.py:21-22); Critic = twin Q MLPs on concat(obs, act)
(mujoco_model.py:63-89); GRUActor = flax's ``GRUCell`` over an observation
history, then the actor's heads. The actor's four layers keep the flax
module's order (``dense.0..3`` = Dense_0..Dense_3, ``convert.actor_from_flax``);
the critic and the GRU actor keep the flax scope names themselves
(``Dense_0..Dense_5``, ``LN_0..LN_3``, ``GRUCell_0.{ir,iz,in,hr,hz,hn}``), so
``convert.load_flax`` maps a flax tree onto them by path. Every module runs
on the card unless the caller asks for another device
(``core/device.resolve_device``).

Every layer is applied through ``parallel.sharding.linear``: a layer that
``shard_params_tp`` split over a mesh's model axis (its dim-0 rows) gathers
its whole output, so LayerNorm and the next layer see the whole hidden
vector and the module computes the one-process function.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.parallel.sharding import (copy_to_model,
                                                    gather_from_model, linear)
from paddlerobotics_torch.utils.init import flax_default_

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
                torch.stack([la.bias, lb.bias])[:, None],
                getattr(la, "tp", None))

    def product(h, a, b, first=False):
        w, bias, tp = stacked(a, b)
        if tp is not None:
            h = copy_to_model(h, tp)
        out = (torch.einsum("bi,koi->kbo", rnd(h), rnd(w)) if first else
               torch.bmm(rnd(h), rnd(w).transpose(1, 2))) + bias
        return out if tp is None else gather_from_model(out, tp)

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


class GRUCell(nn.Module):
    """flax ``linen.GRUCell``: r and z gates from ``ir``/``iz`` (with bias)
    plus ``hr``/``hz`` (no bias); the candidate from ``in`` plus
    ``r * hn(h)`` (``hn`` with bias); ``h' = (1−z)·n + z·h``. Not
    ``nn.GRU``, whose biases and candidate differ."""

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_dim, hidden, device=device))
        for name in ("hr", "hz"):
            self.add_module(name, nn.Linear(hidden, hidden, bias=False,
                                            device=device))
        self.add_module("hn", nn.Linear(hidden, hidden, device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        g = lambda name, v: linear(getattr(self, name), v)
        r = torch.sigmoid(g("ir", x) + g("hr", h))
        z = torch.sigmoid(g("iz", x) + g("hz", h))
        n = torch.tanh(g("in", x) + r * g("hn", h))
        return (1.0 - z) * n + z * h


class GRUActor(nn.Module):
    """Recurrent actor for sensor_mode RNN='GRU' (EnvWrapper.py:216-217):
    a (…, T, obs) history (or its flat (…, T·obs) stack, the layout replay
    stores) through a GRU, then Dense_0 (ReLU) and the mean / log-std heads
    Dense_1 / Dense_2."""

    def __init__(self, frame_dim: int, action_dim: int, hidden: int = 256,
                 seq_len: int = 0, device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.seq_len, self.frame_dim = seq_len, frame_dim
        self.GRUCell_0 = GRUCell(frame_dim, hidden, device=device)
        self.Dense_0 = nn.Linear(hidden, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, action_dim, device=device)
        self.Dense_2 = nn.Linear(hidden, action_dim, device=device)
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, obs_seq: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.seq_len and obs_seq.shape[-1] == self.seq_len * self.frame_dim:
            obs_seq = obs_seq.reshape(obs_seq.shape[:-1]
                                      + (self.seq_len, self.frame_dim))
        h = obs_seq.new_zeros(obs_seq.shape[:-2]
                              + (self.GRUCell_0.hr.in_features,))
        for t in range(obs_seq.shape[-2]):
            h = self.GRUCell_0(h, obs_seq[..., t, :])
        x = torch.relu(linear(self.Dense_0, h))
        mean = linear(self.Dense_1, x)
        log_std = torch.clamp(linear(self.Dense_2, x), LOG_SIG_MIN,
                              LOG_SIG_MAX)
        return mean, log_std
