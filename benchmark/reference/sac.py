"""Soft Actor-Critic (PyTorch port of the JAX package's ``algos/sac.py``).

The same recipe (alg/sac.py:24-118): tanh-squashed Gaussian policy with a
reparameterised sample and the −log(1−tanh²+1e−6) correction; twin-Q
targets min(Q1', Q2') − α·logπ bootstrapped through the ``terminal``
(1−done) mask; the actor updated against the critic after its update;
optional auto-α on the actor-loss noise; Polyak target sync with τ; Adam on
actor, critic and α. Unlike JAX's functional ``SACState``, the state here
holds modules and ``torch.optim.Adam`` optimisers, and ``learn`` and
``reset_critic`` update it in place and return no state: a caller that
keeps an earlier state takes a ``copy.deepcopy``. Every draw comes from an
explicit ``torch.Generator`` or is passed in pre-drawn, so a test can feed
JAX's draws.

On a mesh (``SAC(..., mesh=)``, ``parallel/sharding``) the actor and the
critics are column-parallel over the model axis, and ``learn`` is the
one-process update under data parallelism: every rank is given the global
batch (``replay.sample`` on a mesh) and the global noise, and takes its env
rank's contiguous share of the batch positions (``sharding.columns``); each
loss is its rows' partial sum over the global batch size, the gradients are
all-reduced (SUM) over the env axis before each optimiser step, and the
reported losses are all-reduced the same way. A batch that does not divide
over the env axis is replicated: every rank computes the whole update.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.networks import (Actor, Critic,
                                                 critic_apply_fused)
from benchmark.reference.config import SACConfig
from benchmark.reference.device import resolve_device
from benchmark.reference import columns as sharding

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass
class SACState:
    """The learner's live state, updated in place by ``SAC.learn`` and
    ``SAC.reset_critic``."""
    actor: nn.Module
    critic: Critic
    target_critic: Critic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    log_alpha: torch.Tensor          # () leaf; the live α when auto-tuned
    alpha_opt: torch.optim.Adam      # or host-annealed


def predict(actor: nn.Module, obs: torch.Tensor) -> torch.Tensor:
    """Deterministic action = tanh(mean) (sac.py:60-63)."""
    mean, _ = actor(obs)
    return torch.tanh(mean)


def sample(actor: nn.Module, obs: torch.Tensor,
           noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterised tanh-Gaussian sample and its log prob (sac.py:65-75).

    ``noise`` (the standard normal draw, shaped like the action) is drawn
    from ``generator`` when not given. The log prob takes the draw itself,
    −½·noise², not (x−mean)/std."""
    mean, log_std = actor(obs)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
    x_t = mean + torch.exp(log_std) * noise
    action = torch.tanh(x_t)
    log_prob = -0.5 * noise ** 2 - log_std - _HALF_LOG_2PI
    log_prob = log_prob - torch.log(1.0 - action ** 2 + 1e-6)
    return action, torch.sum(log_prob, dim=-1, keepdim=True)


class SAC:
    """Static config and module shapes; ``init`` makes a state."""

    def __init__(self, obs_dim: int, action_dim: int,
                 cfg: SACConfig = SACConfig(),
                 actor: Optional[Callable[..., nn.Module]] = None,
                 device: str | torch.device | None = None, mesh=None):
        """``actor`` overrides the default MLP policy: a factory called
        with ``device`` and ``generator`` that returns a module mapping obs
        → (mean, log_std), e.g. a ``GRUActor`` partial. ``mesh``: the
        ``("env", "model")`` device mesh to train over."""
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.device = resolve_device(device)
        sharding.check_mesh(mesh, self.device)
        self.mesh = mesh
        self._actor = actor or (lambda **kw: Actor(
            obs_dim, action_dim, hidden=cfg.hidden_dim, **kw))
        self.target_entropy = -float(action_dim)

    def _critic(self, generator) -> Critic:
        return Critic(self.obs_dim, self.action_dim, self.cfg.hidden_dim,
                      layer_norm=self.cfg.ln_critic, device=self.device,
                      generator=generator)

    def _critic_parts(self, critic: Critic):
        critic = sharding.shard_params_tp(self.mesh, critic)
        target = copy.deepcopy(critic).requires_grad_(False)
        return critic, target, torch.optim.Adam(critic.parameters(),
                                                lr=self.cfg.critic_lr)

    def init(self, generator: Optional[torch.Generator]) -> SACState:
        """Fresh weights (flax's default initialisers drawn from
        ``generator``; PyTorch's own without one, for a caller that loads
        weights), target = critic, zeroed Adam states, α = cfg.alpha."""
        cfg = self.cfg
        actor = sharding.shard_params_tp(
            self.mesh, self._actor(device=self.device, generator=generator))
        critic, target, critic_opt = self._critic_parts(
            self._critic(generator))
        log_alpha = torch.tensor(math.log(cfg.alpha), dtype=torch.float32,
                                 device=self.device, requires_grad=True)
        return SACState(
            actor=actor, critic=critic, target_critic=target,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.actor_lr),
            critic_opt=critic_opt, log_alpha=log_alpha,
            alpha_opt=torch.optim.Adam([log_alpha], lr=cfg.alpha_lr))

    def reset_critic(self, state: SACState,
                     generator: torch.Generator) -> None:
        """Full critic re-initialisation in place (primacy-bias reset):
        fresh twin-Q weights, target copy and optimiser state; the actor
        (and the replay buffer, held by the caller) untouched
        (SACConfig.critic_reset_steps)."""
        state.critic, state.target_critic, state.critic_opt = \
            self._critic_parts(self._critic(generator))

    # -- inference ------------------------------------------------------------

    def predict(self, actor: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """Deterministic action = tanh(mean) (sac.py:60-63); the module
        function ``predict``."""
        return predict(actor, obs)

    def sample(self, actor: nn.Module, obs: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reparameterised tanh-Gaussian sample and its log prob
        (sac.py:65-75); the module function ``sample``, drawing from
        ``generator`` unless ``noise`` is given."""
        return sample(actor, obs, noise=noise, generator=generator)

    def alpha(self, state: SACState):
        """The live temperature: exp(log_alpha) when auto-tuned or
        host-annealed (SACConfig.alpha_anneal_steps), else cfg.alpha."""
        cfg = self.cfg
        if cfg.auto_alpha or cfg.alpha_anneal_steps > 0:
            return torch.exp(state.log_alpha.detach())
        return cfg.alpha

    def _q(self, critic, obs, act):
        return critic_apply_fused(critic, obs, act,
                                  bf16=self.cfg.bf16_matmul)

    @staticmethod
    def _step(opt: torch.optim.Optimizer, cols: sharding.Columns) -> None:
        """All-reduce the gradients of ``opt``'s parameters over the env
        axis (when the batch is split over it), then step."""
        if cols.group is not None:
            sharding.all_reduce_grads(
                [p for g in opt.param_groups for p in g["params"]],
                cols.group)
        opt.step()

    def learn(self, state: SACState, batch: Dict[str, torch.Tensor],
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """One critic, actor, α and target update (sac.py:77-110), in place.

        batch: obs (b,o), act (b,a), rew (b,1), next_obs (b,o), terminal
        (b,1) in the 1−done convention (train.py:148-149); on a mesh the
        global batch, of which this rank takes its positions. ``noise`` =
        (next_noise, pi_noise), the two standard normal (b,a) draws of the
        target's and the actor loss's samples (JAX's k_next, k_pi); the
        auto-α update reuses pi_noise. Drawn from ``generator`` when not
        given. Returns the two losses (of the global batch) as 0-d
        tensors."""
        cfg = self.cfg
        b = batch["obs"].shape[0]
        if noise is None:
            noise = tuple(torch.randn((b, self.action_dim),
                                      generator=generator,
                                      device=batch["obs"].device)
                          for _ in range(2))
        # this rank's batch positions: all of them without a mesh
        cols = sharding.columns(self.mesh, b)
        batch = {k: cols.cut(v, 0) for k, v in batch.items()}
        next_noise, pi_noise = (cols.cut(x, 0) for x in noise)
        alpha = self.alpha(state)
        obs = batch["obs"]
        mean = cols.part_mean

        # critic update against the stop-gradient target
        with torch.no_grad():
            next_act, next_logp = sample(state.actor, batch["next_obs"],
                                         next_noise)
            q1_t, q2_t = self._q(state.target_critic, batch["next_obs"],
                                 next_act)
            target_q = torch.minimum(q1_t, q2_t) - alpha * next_logp
            target_q = batch["rew"] + cfg.gamma * batch["terminal"] * target_q
        q1, q2 = self._q(state.critic, obs, batch["act"])
        critic_loss = mean((q1 - target_q) ** 2) + mean((q2 - target_q) ** 2)
        state.critic_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        self._step(state.critic_opt, cols)

        # actor update against the updated critic (sac.py:77-82)
        act, logp = sample(state.actor, obs, pi_noise)
        q1, q2 = self._q(state.critic, obs, act)
        actor_loss = mean(alpha * logp - torch.minimum(q1, q2))
        state.actor_opt.zero_grad(set_to_none=True)
        actor_loss.backward(inputs=list(state.actor.parameters()))
        self._step(state.actor_opt, cols)

        # temperature update (auto-α, SAC v2) on the actor loss's noise
        if cfg.auto_alpha:
            with torch.no_grad():
                _, logp_now = sample(state.actor, obs, pi_noise)
            alpha_loss = -mean(torch.exp(state.log_alpha)
                               * (logp_now + self.target_entropy))
            state.alpha_opt.zero_grad(set_to_none=True)
            alpha_loss.backward()
            self._step(state.alpha_opt, cols)

        # Polyak sync (sac.py:112-118): (1−τ)·target + τ·critic
        with torch.no_grad():
            tgt = list(state.target_critic.parameters())
            torch._foreach_mul_(tgt, 1.0 - cfg.tau)
            torch._foreach_add_(tgt, torch._foreach_mul(
                list(state.critic.parameters()), cfg.tau))
        losses = cols.reduce(torch.stack([critic_loss.detach(),
                                          actor_loss.detach()]))
        return {"critic_loss": losses[0], "actor_loss": losses[1]}
