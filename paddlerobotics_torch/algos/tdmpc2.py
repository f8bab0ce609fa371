"""TD-MPC2 (Hansen, Su and Wang, "TD-MPC2: Scalable, Robust World Models for
Continuous Control", ICLR 2024, arXiv:2310.16828) as an A1 policy: the
world model of github.com/nicklashansen/tdmpc2 at its single-task preset
(``model_size`` 5) and its MPPI planner, batched over B envs.

The world model follows ``tdmpc2/common/world_model.py`` and
``tdmpc2/common/layers.py`` and keeps their module names (``_encoder``,
``_dynamics``, ``_reward``, ``_pi``, ``_Qs``), so one weight dict keyed by
them loads here and into the plain reference. Every hidden layer is a
``NormedLinear``: Linear → LayerNorm → Mish, run by
``ops/groupnorm_mish.linear_norm_act`` (on the card a bias-less GEMM and the
kernel's row path, which adds the bias per element):

- encoder ``_encoder.state``: obs → enc_dim, then → latent_dim with
  LayerNorm → SimNorm (a softmax over each group of ``simnorm_dim``);
- dynamics ``_dynamics``: z‖a → mlp_dim → mlp_dim → latent_dim, SimNorm;
- reward ``_reward``: z‖a → mlp_dim → mlp_dim → num_bins, a plain Linear;
- policy ``_pi``: z → mlp_dim → mlp_dim → 2·action_dim (mean, log-std);
- Q ensemble ``_Qs``: ``num_q`` such MLPs on z‖a, their parameters stacked
  in a ``ParameterList`` (``_Qs.params.0`` … ``.9``, as the published
  ``Ensemble`` keeps them); on the card each layer runs for all heads at
  once (``heads_linear_norm_act``; the output layer a ``baddbmm``).

Reward and Q logits are decoded by ``two_hot_inv`` (softmax over the bins
on [vmin, vmax], the expected bin, ``symexp``); the policy's log-std is
squashed into [log_std_min, log_std_max] by tanh, its action is
tanh(mean + ε·std); Q 'avg' averages two distinct heads drawn per call.

The planner (``TDMPC2Planner.plan``) is ``TDMPC2._plan`` in eval mode for B
envs at once, each env its own warm start, samples, Q pair and Gumbel draw:
encode; roll out ``num_pi_trajs`` policy trajectories; start from the
previous mean shifted by one (zero on an episode's first step, ``t0``) and
std ``max_std``; ``iterations`` times sample the other actions around the
mean, clamp them to [-1, 1], estimate every sequence's value (``horizon``
steps of reward and dynamics, discounted, then the policy and Q 'avg' on
the last latent), take the top ``num_elites``, weight them by
exp(temperature·(v − max)) and refit the mean and the std (clamped to
[min_std, max_std]); pick one elite by a Gumbel draw over the weights and
return its first action, and the mean for the next step's warm start.

All of a plan's noise comes in as one ``PlanNoise`` (``draw_noise``), so a
reference can be handed the same draws. Dropout (0.01 on each Q head's
first layer in training) is off: the planner is the agent in eval mode.
The target Q ensemble and the task embedding (training, multi-task) are
left out.

Spans (``utils/profiler.annotate``): ``policy.tdmpc2`` around a plan, inside
it ``policy.tdmpc2.encode``, ``policy.tdmpc2.pi_trajs``,
``policy.tdmpc2.value`` (each iteration's samples and their value
estimate), ``policy.tdmpc2.refit`` (each iteration's top-k, weights, mean
and std) and ``policy.tdmpc2.select``; counters ``plans`` and
``value_rollouts`` and, from the kernel's wrapper, ``norm_launches``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.ops.groupnorm_mish import (heads_linear_norm_act,
                                                     linear_norm_act)
from paddlerobotics_torch.utils import profiler

LN_EPS = 1e-5                       # nn.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class TDMPC2Config:
    """``tdmpc2/config.yaml`` with ``MODEL_SIZE[5]`` at the A1 task's
    widths (obs 49, action 12, one task)."""
    obs_dim: int = 49
    action_dim: int = 12
    enc_dim: int = 256
    num_enc_layers: int = 2
    mlp_dim: int = 512
    latent_dim: int = 512
    num_q: int = 5
    simnorm_dim: int = 8
    num_bins: int = 101
    vmin: float = -10.0
    vmax: float = 10.0
    log_std_min: float = -10.0
    log_std_max: float = 2.0
    horizon: int = 3
    iterations: int = 6
    num_samples: int = 512
    num_elites: int = 64
    num_pi_trajs: int = 24
    min_std: float = 0.05
    max_std: float = 2.0
    temperature: float = 0.5
    episode_length: int = 600
    discount_denom: int = 5
    discount_min: float = 0.95
    discount_max: float = 0.995

    @property
    def discount(self) -> float:
        """The published heuristic: (T/denom − 1)/(T/denom) clipped to
        [discount_min, discount_max]; 0.99167 at T = 600."""
        frac = self.episode_length / self.discount_denom
        return min(max((frac - 1) / frac, self.discount_min),
                   self.discount_max)


# --- the world model ---------------------------------------------------------

class NormedLinear(nn.Linear):
    """Linear → LayerNorm → Mish or SimNorm, the LayerNorm kept as ``ln``."""

    def __init__(self, inp: int, out: int, act: str = "mish",
                 simnorm_dim: int = 8, device=None):
        super().__init__(inp, out, device=device)
        self.ln = nn.LayerNorm(out, device=device)
        self.act, self.simnorm_dim = act, simnorm_dim

    def forward(self, x):
        return linear_norm_act(x, self.weight, self.bias, self.ln.weight,
                               self.ln.bias, self.ln.eps, self.act,
                               self.simnorm_dim)


def mlp(inp: int, hidden, out: int, act: Optional[str] = None,
        simnorm_dim: int = 8, device=None) -> nn.Sequential:
    """``layers.mlp``: NormedLinear (Mish) layers, then a NormedLinear with
    ``act`` or, without one, a plain Linear."""
    dims = [inp] + list(hidden) + [out]
    layers = [NormedLinear(a, b, device=device)
              for a, b in zip(dims[:-2], dims[1:-1])]
    layers.append(NormedLinear(dims[-2], dims[-1], act, simnorm_dim, device)
                  if act else nn.Linear(dims[-2], dims[-1], device=device))
    return nn.Sequential(*layers)


class Ensemble(nn.Module):
    """``num_q`` MLPs of two NormedLinear layers and a Linear, their
    parameters stacked by head: ``params`` holds, in the published
    ``Ensemble``'s order, each layer's weight (H, out, in), bias, and for the
    hidden layers the LayerNorm's weight and bias (H, out)."""

    def __init__(self, heads: int, inp: int, hidden, out: int, device=None):
        super().__init__()
        dims = [inp] + list(hidden) + [out]
        shapes = []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes += [(heads, b, a), (heads, b)]
            if i < len(dims) - 2:
                shapes += [(heads, b), (heads, b)]
        self.params = nn.ParameterList([
            nn.Parameter(torch.zeros(s, device=device)) for s in shapes])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, in) → logits (H, N, out)."""
        p = list(self.params)
        h = x
        while len(p) > 2:
            w, b, g, e = p[:4]
            p = p[4:]
            h = heads_linear_norm_act(h, w, b, g, e, LN_EPS)
        w, b = p
        if h.device.type == "cpu":
            return torch.stack([F.linear(h[k], w[k], b[k])
                                for k in range(w.shape[0])])
        return torch.baddbmm(b[:, None], h, w.transpose(1, 2))


class WorldModel(nn.Module):
    """The networks of ``world_model.WorldModel`` for one task, by their
    published names."""

    def __init__(self, cfg: TDMPC2Config, device=None):
        super().__init__()
        self.cfg = cfg
        Z, A, M = cfg.latent_dim, cfg.action_dim, cfg.mlp_dim
        sn = cfg.simnorm_dim
        self._encoder = nn.ModuleDict({"state": mlp(
            cfg.obs_dim, [cfg.enc_dim] * max(cfg.num_enc_layers - 1, 1), Z,
            "simnorm", sn, device)})
        self._dynamics = mlp(Z + A, [M, M], Z, "simnorm", sn, device)
        self._reward = mlp(Z + A, [M, M], cfg.num_bins, device=device)
        self._pi = mlp(Z, [M, M], 2 * A, device=device)
        self._Qs = Ensemble(cfg.num_q, Z + A, [M, M], cfg.num_bins, device)
        self.register_buffer("log_std_min", torch.tensor(
            cfg.log_std_min, device=device))
        self.register_buffer("log_std_dif", torch.tensor(
            cfg.log_std_max, device=device) - self.log_std_min)
        self.register_buffer("bins", torch.linspace(
            cfg.vmin, cfg.vmax, cfg.num_bins, device=device),
            persistent=False)

    def encode(self, obs):
        return self._encoder["state"](obs)

    def next(self, z, a):
        return self._dynamics(torch.cat([z, a], dim=-1))

    def reward(self, z, a):
        return self._reward(torch.cat([z, a], dim=-1))

    def pi(self, z, eps):
        """(tanh(mean), tanh(mean + ε·std)) with log-std squashed into
        [log_std_min, log_std_max]."""
        mu, log_std = self._pi(z).chunk(2, dim=-1)
        log_std = self.log_std_min + 0.5 * self.log_std_dif * (
            torch.tanh(log_std) + 1)
        return torch.tanh(mu), torch.tanh(mu + eps * log_std.exp())

    def two_hot_inv(self, x):
        """Logits over the bins → symexp of the expected bin, (..., 1)."""
        x = torch.sum(F.softmax(x, dim=-1) * self.bins, dim=-1, keepdim=True)
        return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)

    def q_avg(self, z, a, pair):
        """Q 'avg' for rows (b, s) of z (B·S, Z): the mean of the two heads
        ``pair[b]`` (B, 2) after ``two_hot_inv``; (B·S, 1). All heads are
        computed."""
        out = self._Qs(torch.cat([z, a], dim=-1))       # (H, B·S, bins)
        H, N, nb = out.shape
        B = pair.shape[0]
        idx = pair.t().reshape(2, B, 1, 1).expand(2, B, N // B, nb)
        q = self.two_hot_inv(torch.gather(out.view(H, B, N // B, nb), 0, idx))
        return (q.sum(0) / 2).reshape(N, 1)


# --- the planner -------------------------------------------------------------

class PlanNoise(NamedTuple):
    """Every draw of one plan for B envs (I iterations, H steps, S samples,
    P policy trajectories, E elites, A action dims)."""
    samples: torch.Tensor     # (I, H, B, S − P, A) standard normal
    pi_trajs: torch.Tensor    # (H, B, P, A): the policy's ε, trajectories
    pi_value: torch.Tensor    # (I, B, S, A): its ε at the last latent
    q_pair: torch.Tensor      # (I, B, 2) int64: the two Q heads averaged
    gumbel: torch.Tensor      # (B, E) Gumbel(0, 1): −log of an Exp(1) draw


class Refit(NamedTuple):
    elite_idx: torch.Tensor       # (B, E)
    elite_value: torch.Tensor     # (B, E)
    elite_actions: torch.Tensor   # (H, B, E, A)
    score: torch.Tensor           # (B, E), summing to 1
    mean: torch.Tensor            # (B, H, A)
    std: torch.Tensor             # (B, H, A)


def warm_start(prev_mean: torch.Tensor, t0: torch.Tensor) -> torch.Tensor:
    """The first mean of a plan: the previous step's (B, H, A) shifted by
    one, its last step zero; all zero for an env whose step is an episode's
    first (``t0``)."""
    mean = torch.zeros_like(prev_mean)
    mean[:, :-1] = prev_mean[:, 1:]
    return torch.where(t0[:, None, None], 0.0, mean)


def sample_actions(mean, std, r):
    """mean, std (B, H, A), r (H, B, S', A) → clamp(mean + std·r, −1, 1)."""
    m, s = mean.transpose(0, 1)[:, :, None], std.transpose(0, 1)[:, :, None]
    return (m + s * r).clamp(-1, 1)


def refit(value: torch.Tensor, actions: torch.Tensor,
          cfg: TDMPC2Config) -> Refit:
    """The top ``num_elites`` of value (B, S) over actions (H, B, S, A),
    weighted by exp(temperature·(v − max)), and the mean and std they
    refit, the std clamped to [min_std, max_std]."""
    H, B, S, A = actions.shape
    E = cfg.num_elites
    elite_idx = torch.topk(value, E, dim=1).indices
    elite_value = torch.gather(value, 1, elite_idx)
    elite_actions = torch.gather(
        actions, 2, elite_idx[None, :, :, None].expand(H, B, E, A))
    max_value = elite_value.max(1, keepdim=True).values
    score = torch.exp(cfg.temperature * (elite_value - max_value))
    score = score / score.sum(1, keepdim=True)
    w = score[None, :, :, None]
    denom = score.sum(1)[None, :, None] + 1e-9
    mean = (w * elite_actions).sum(dim=2) / denom                # (H, B, A)
    std = ((w * (elite_actions - mean[:, :, None]) ** 2).sum(dim=2)
           / denom).sqrt().clamp(cfg.min_std, cfg.max_std)
    return Refit(elite_idx, elite_value, elite_actions, score,
                 mean.transpose(0, 1), std.transpose(0, 1))


def select(elite_actions: torch.Tensor, score: torch.Tensor,
           gumbel: torch.Tensor) -> torch.Tensor:
    """``gumbel_softmax_sample`` over each env's weights, then the chosen
    elite's first action, clamped: (B, A)."""
    idx = (score.log() + gumbel).softmax(-1).argmax(-1)
    first = elite_actions[0]                                     # (B, E, A)
    a = torch.gather(first, 1, idx[:, None, None].expand(-1, 1,
                                                         first.shape[2]))
    return a[:, 0].clamp(-1, 1)


class TDMPC2Planner:
    """The world model (``model``, a ``WorldModel``: load a weight dict
    into it) and MPPI planning for B envs at once."""

    def __init__(self, cfg: TDMPC2Config = TDMPC2Config(),
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = WorldModel(cfg, self.device).requires_grad_(False)

    def draw_noise(self, B: int, generator: torch.Generator) -> PlanNoise:
        """One plan's draws for B envs from ``generator``, on its device."""
        c = self.cfg
        I, H, S, P = c.iterations, c.horizon, c.num_samples, c.num_pi_trajs
        A, dev = c.action_dim, generator.device
        randn = lambda *s: torch.randn(s, generator=generator, device=dev)
        samples = randn(I, H, B, S - P, A)
        pi_trajs = randn(H, B, P, A)
        pi_value = randn(I, B, S, A)
        q_pair = torch.rand(I, B, c.num_q, generator=generator,
                            device=dev).argsort(-1)[..., :2]
        u = torch.empty(B, c.num_elites, device=dev).exponential_(
            generator=generator)
        return PlanNoise(samples, pi_trajs, pi_value, q_pair, -u.log())

    def pi_trajectories(self, z: torch.Tensor, eps: torch.Tensor):
        """The policy's trajectories from z (B, Z): (H, B, P, A)."""
        H, B, P, A = eps.shape
        m = self.model
        _z = z.repeat_interleave(P, 0)
        out = []
        for t in range(H):
            a = m.pi(_z, eps[t].reshape(B * P, A))[1]
            out.append(a)
            if t < H - 1:
                _z = m.next(_z, a)
        return torch.stack(out).view(H, B, P, A)

    def estimate_value(self, z: torch.Tensor, actions: torch.Tensor,
                       eps: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
        """Values (B, S) of actions (H, B, S, A) from the rows of z
        (B·S, Z): the discounted rewards of ``horizon`` steps, then Q 'avg'
        of the policy's action (ε (B, S, A)) at the last latent."""
        H, B, S, A = actions.shape
        m, gamma = self.model, self.cfg.discount
        G, discount = 0, 1
        for t in range(H):
            za = torch.cat([z, actions[t].reshape(B * S, A)], dim=-1)
            reward = m.two_hot_inv(m._reward(za))
            z = m._dynamics(za)
            G = G + discount * reward
            discount = discount * gamma
        a = m.pi(z, eps.reshape(B * S, A))[1]
        return (G + discount * m.q_avg(z, a, pair)).view(B, S)

    @torch.no_grad()
    def plan(self, obs: torch.Tensor, t0: torch.Tensor,
             prev_mean: torch.Tensor, noise: PlanNoise,
             keep: Optional[dict] = None):
        """obs (B, obs_dim), t0 (B,) bool, prev_mean (B, H, A) → (the action
        to execute, (B, A) in [-1, 1]; the mean, (B, H, A), for the next
        step's warm start). ``keep``, where given, is filled with the
        plan's inner tensors (``z``, ``pi_actions``, ``mean0``, the final
        ``refit`` and, for each iteration in ``keep["iterations"]``, its
        input mean and std, actions, values and ``Refit``)."""
        c = self.cfg
        B = obs.shape[0]
        H, S, P, A = c.horizon, c.num_samples, c.num_pi_trajs, c.action_dim
        iters = keep.get("iterations", ()) if keep is not None else ()
        with profiler.annotate("policy.tdmpc2"):
            profiler.count("plans")
            with profiler.annotate("policy.tdmpc2.encode"):
                z = self.model.encode(obs)
            with profiler.annotate("policy.tdmpc2.pi_trajs"):
                pi_actions = self.pi_trajectories(z, noise.pi_trajs)
            mean = warm_start(prev_mean, t0)
            std = torch.full_like(mean, c.max_std)
            actions = torch.empty(H, B, S, A, device=obs.device)
            actions[:, :, :P] = pi_actions
            zs = z.repeat_interleave(S, 0)
            if keep is not None:
                keep.update(z=z, pi_actions=pi_actions, mean0=mean, iters={})
            for i in range(c.iterations):
                with profiler.annotate("policy.tdmpc2.value"):
                    actions[:, :, P:] = sample_actions(mean, std,
                                                       noise.samples[i])
                    value = self.estimate_value(
                        zs, actions, noise.pi_value[i],
                        noise.q_pair[i]).nan_to_num(0)
                    profiler.count("value_rollouts")
                with profiler.annotate("policy.tdmpc2.refit"):
                    fit = refit(value, actions, c)
                if i in iters:
                    keep["iters"][i] = dict(mean=mean, std=std, value=value,
                                            actions=actions.clone(), fit=fit)
                mean, std = fit.mean, fit.std
            with profiler.annotate("policy.tdmpc2.select"):
                a = select(fit.elite_actions, fit.score, noise.gumbel)
            if keep is not None:
                keep.update(refit=fit, action=a)
            return a, mean
