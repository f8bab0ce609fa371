"""One control step of the ETG-RL training loop, written after the port's
``train/etg_rl.ETGRLTrainer`` (``init_carry`` and ``rollout_chunk``,
ETGRL/train.py:137-160): the policy's draw (or the warm-up's uniform and
gait draws), the env step with autoreset at the episode cap, the replay
write, one gather of K batches and K SAC updates, every draw from the
trainer's generator in the port's order.

``learn`` is the hook each update goes through: the check reads losses,
gradients and weights there, and a planted fault replaces it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from benchmark.reference import etg_fit, replay, sac as sac_mod
from benchmark.reference.env import BatchedQuadrupedEnv
from benchmark.reference.sac import SAC


def seeded(device, *key: int) -> torch.Generator:
    """The port's ``_seeded``: a generator seeded from the integer tuple
    ``key`` mixed by numpy's SeedSequence."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(list(key))
                      .generate_state(1, np.uint64)[0]))
    return g


@dataclasses.dataclass
class Carry:
    env_state: object
    obs: torch.Tensor
    sac_state: object
    buffer: replay.ReplayBuffer
    rng: torch.Generator


class Trainer:
    def __init__(self, cfg, num_envs: int, updates_per_step: int, device):
        self.cfg, self.B, self.K, self.device = (cfg, num_envs,
                                                 updates_per_step, device)
        self.env = BatchedQuadrupedEnv(cfg, num_envs, device=device)
        self.sac = SAC(self.env.obs_dim, self.env.action_dim, cfg.sac,
                       device=device)
        self.act_bound = torch.as_tensor(self.env.act_bound, device=device)
        self.act_offset = torch.as_tensor(self.env.act_offset,
                                          device=device)
        self._prior = torch.as_tensor(etg_fit.prior_points(cfg.etg),
                                      dtype=torch.float32, device=device)
        self._w0, self._b0 = etg_fit.opt_with_points(cfg.etg, device=device)
        self.learn: Callable = self.sac.learn

    def init(self, seed: int, actor_params: List[torch.Tensor],
             critic_params: List[torch.Tensor]) -> Carry:
        """``init_carry(seed)`` on the zero-offset gait, with the given
        weights for the actor and for both the critic and its target."""
        from benchmark.harness import load_params

        dev, B = self.device, self.B
        pts = self._prior + torch.zeros(
            self.cfg.es.num_params, device=dev).reshape(6, 2)
        w, b = etg_fit.opt_with_points(self.cfg.etg, points=pts,
                                       w0=self._w0, b0=self._b0)
        w_env = w[..., None].expand(*w.shape, B).contiguous()
        b_env = b[..., None].expand(*b.shape, B).contiguous()
        env_state, obs = self.env.reset(seeded(dev, seed, 0), etg_w=w_env,
                                        etg_b=b_env)
        buf = replay.create(self.cfg.sac.memory_size, self.env.obs_dim,
                            self.env.action_dim, device=dev)
        st = self.sac.init(None)
        load_params(st.actor, actor_params)
        load_params(st.critic, critic_params)
        load_params(st.target_critic, critic_params)
        return Carry(env_state, obs, st, buf, seeded(dev, seed, 2))

    def step(self, carry: Carry, e_step: int, warm: bool) -> None:
        """One control step, in place."""
        env, cfg, B, dev = self.env, self.cfg, self.B, self.device
        a_dim = env.action_dim
        gen, state, obs = carry.rng, carry.sac_state, carry.obs
        first = lambda frac: (torch.arange(B, device=dev)
                              < int(frac * B))[:, None]
        with torch.no_grad():
            if warm:
                noise = torch.randn((B, a_dim), generator=gen, device=dev)
                action, _ = sac_mod.sample(state.actor, obs, noise)
                if int(cfg.sac.det_rollout_frac * B) > 0:
                    action = torch.where(first(cfg.sac.det_rollout_frac),
                                         sac_mod.predict(state.actor, obs),
                                         action)
            else:
                action = torch.rand((B, a_dim), generator=gen,
                                    device=dev) * 2.0 - 1.0
                if int(cfg.sac.warmup_gait_frac * B) > 0:
                    on_gait = torch.clamp(
                        cfg.sac.warmup_gait_sigma * torch.randn(
                            (B, a_dim), generator=gen, device=dev),
                        -1.0, 1.0)
                    action = torch.where(first(cfg.sac.warmup_gait_frac),
                                         on_gait, action)
            donef = (carry.env_state.step_idx + 1) > e_step
            carry.env_state, nobs, rew, done, _ = env.step(
                carry.env_state, action * self.act_bound + self.act_offset,
                donef)
            terminal = 1.0 - done.to(torch.float32)
            replay.add_rows(carry.buffer, replay.rows(obs, action, rew, nobs,
                                                      terminal))
        if warm and self.K > 0:
            batches = replay.sample_many(carry.buffer, self.K,
                                         cfg.sac.batch_size, generator=gen)
            for k in range(self.K):
                self.learn(state, {f: v[k] for f, v in batches.items()},
                           generator=gen)
        carry.obs = nobs


def adam_grads(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Each leaf's first gradient as Adam received it, from its state after
    one step: exp_avg = (1 − β1)·g; zero for a leaf Adam never stepped."""
    out = []
    for group in opt.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = opt.state.get(p, {})
            out.append(st["exp_avg"] / (1.0 - b1) if "exp_avg" in st
                       else torch.zeros_like(p))
    return out


def snapshot(modules) -> List[torch.Tensor]:
    return [p.detach().clone() for m in modules for p in m.parameters()]
