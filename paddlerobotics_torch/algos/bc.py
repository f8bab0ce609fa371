"""Behavior cloning, expert → student distillation (PyTorch port of the
JAX package's ``algos/bc.py``, rebuild of alg/BC.py).

BClearn (BC.py:53-72): the actor loss is −log N(expert action | student
Gaussian), the pre-tanh normal evaluated at the expert's tanh action; the
critic loss is the MSE distillation of the expert's twin-Q values at the
student's sampled action (after the actor's update). Like ``SAC``, the state
holds modules and ``torch.optim.Adam`` optimisers and ``learn`` updates it
in place; its one draw (the student's sample noise) comes pre-drawn or from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from paddlerobotics_torch.algos import sac
from paddlerobotics_torch.algos.networks import Actor, Critic
from paddlerobotics_torch.algos.sac import SACState
from paddlerobotics_torch.core.device import resolve_device

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass
class BCState:
    """The student's live state, updated in place by ``BC.learn``."""
    actor: Actor
    critic: Critic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam


class BC:
    def __init__(self, obs_dim: int, action_dim: int,
                 actor_lr: float = 3e-4, critic_lr: float = 3e-4,
                 hidden: int = 256, device: str | torch.device | None = None):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = hidden
        self.actor_lr = actor_lr
        self.critic_lr = critic_lr
        self.device = resolve_device(device)

    def init(self, generator: Optional[torch.Generator]) -> BCState:
        """Fresh student (flax's default initialisers drawn from
        ``generator``; PyTorch's own without one, for a caller that loads
        weights) with zeroed Adam states."""
        kw = dict(hidden=self.hidden, device=self.device, generator=generator)
        actor = Actor(self.obs_dim, self.action_dim, **kw)
        critic = Critic(self.obs_dim, self.action_dim, **kw)
        return BCState(actor, critic,
                       torch.optim.Adam(actor.parameters(), lr=self.actor_lr),
                       torch.optim.Adam(critic.parameters(),
                                        lr=self.critic_lr))

    def predict(self, actor: Actor, obs: torch.Tensor) -> torch.Tensor:
        """The student's deterministic action, tanh(mean)."""
        mean, _ = actor(obs)
        return torch.tanh(mean)

    def learn(self, state: BCState, batch: Dict[str, torch.Tensor],
              expert_state: SACState, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """One actor and one critic update, in place. batch: ``obs`` (the
        student's view), ``ref_obs`` (the expert's). ``noise`` (b, a), the
        standard normal draw of the student's sampled action (JAX's k2),
        is drawn from ``generator`` when not given. Returns the two losses
        as 0-d tensors."""
        obs, ref_obs = batch["obs"], batch["ref_obs"]
        with torch.no_grad():
            ref_action = sac.predict(expert_state.actor, ref_obs)

        # −log N(ref_action | mean, std) with the pre-tanh normal (BC.py:58)
        mean, log_std = state.actor(obs)
        var = torch.exp(2.0 * log_std)
        nll = 0.5 * ((ref_action - mean) ** 2 / var) + log_std + _HALF_LOG_2PI
        actor_loss = torch.mean(torch.sum(nll, dim=-1))
        state.actor_opt.zero_grad(set_to_none=True)
        actor_loss.backward()
        state.actor_opt.step()

        # critic distillation at the student's current sampled action
        with torch.no_grad():
            mean, log_std = state.actor(obs)
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device)
            action_now = torch.tanh(mean + torch.exp(log_std) * noise)
            rq1, rq2 = expert_state.critic(ref_obs, action_now)
        q1, q2 = state.critic(obs, action_now)
        critic_loss = (torch.mean((q1 - rq1) ** 2)
                       + torch.mean((q2 - rq2) ** 2))
        state.critic_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        state.critic_opt.step()
        return {"actor_loss": actor_loss.detach(),
                "critic_loss": critic_loss.detach()}
