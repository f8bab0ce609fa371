"""ES-only ETG pretraining (PyTorch port of the JAX package's
``train/pretrain.py``, rebuild of ETGRL/pretrain.py).

The reference optimizes the 12 ETG control-point offsets with SimpleGA
on zero-policy rollouts (pretrain.py:220-277), one serial 400-step
episode per candidate. Here the whole population rides the env batch:
one rollout per generation, policy ≡ 0, one physics-kernel launch per
control step on the card.

Fitness is the episode reward sum PLUS a per-step alive bonus
(``alive_bonus``, default 1.0), summed while alive: the calibrated reward
shapes are net-negative per step for slow open-loop gaits, which would
make falling forward fast the optimum of the plain sum (see the JAX
module's docstring). Among surviving candidates the bonus is a constant
offset and leaves the ranking unchanged.

Candidate p runs on the contiguous envs [p·B/P, (p+1)·B/P), so its
fitness is a reshape and a sum over that segment: the same function as
JAX's ``segment_sum`` up to float rounding, in a fixed order (no atomics),
so the kernel and the plain physics give bit-equal fitness.
"""

from __future__ import annotations

import torch

from paddlerobotics_torch.algos import es as es_mod
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.etg import fit as etg_fit
from paddlerobotics_torch.train import metrics as metrics_mod


class ETGPretrainer:
    def __init__(self, config: QuadrupedConfig, num_envs: int | None = None,
                 outdir: str = "pretrain_log", alive_bonus: float = 1.0,
                 device: str | torch.device | None = None):
        """Runs on the card unless ``device`` says otherwise."""
        self.cfg = config
        self.alive_bonus = float(alive_bonus)
        self.B = num_envs or max(config.es.popsize * 8, config.es.popsize)
        if self.B % config.es.popsize != 0:
            raise ValueError(f"num_envs {self.B} is not a multiple of the "
                             f"popsize {config.es.popsize}")
        self.device = dev = resolve_device(device)
        self.env = BatchedQuadrupedEnv(config, self.B, device=dev)
        ecfg = config.es
        self.solver = es_mod.SimpleGA(
            ecfg.num_params, sigma_init=max(ecfg.sigma_init, 0.02),
            sigma_decay=ecfg.sigma_decay, sigma_limit=ecfg.sigma_limit,
            popsize=ecfg.popsize, elite_ratio=ecfg.elite_ratio,
            weight_decay=ecfg.weight_decay)
        self._prior = torch.as_tensor(etg_fit.prior_points(config.etg),
                                      dtype=torch.float32, device=dev)
        self._w0, self._b0 = etg_fit.opt_with_points(config.etg, device=dev)
        self.logger = metrics_mod.MetricsLogger(outdir, use_tensorboard=False)

    @torch.no_grad()
    def _rollout_population(self, solutions: torch.Tensor,
                            generator: torch.Generator | None,
                            n_steps: int) -> torch.Tensor:
        """(P,12) candidates → (P,) fitness, one batched rollout with the
        policy at 0 and no autoreset; ``generator`` drives the reset."""
        P, B, dev = self.cfg.es.popsize, self.B, self.device
        pts = self._prior[None] + solutions.to(dev).reshape(P, 6, 2)
        ws, bs = etg_fit.batched_opt_with_points(
            self.cfg.etg, pts, self._w0, self._b0, device=dev)
        w_env = ws.repeat_interleave(B // P, dim=0).movedim(0, -1)
        b_env = bs.repeat_interleave(B // P, dim=0).movedim(0, -1)
        state, _ = self.env.reset(generator, etg_w=w_env.contiguous(),
                                  etg_b=b_env.contiguous())
        zeros = torch.zeros((B, 12), device=dev)
        ret = torch.zeros(B, device=dev)
        alive = torch.ones(B, device=dev)
        for _ in range(n_steps):
            state, _, rew, done, _ = self.env.step(state, zeros,
                                                   autoreset=False)
            ret = ret + (rew + self.alive_bonus) * alive
            alive = alive * (1.0 - done.to(torch.float32))
        return ret.view(P, B // P).sum(dim=1) / (B // P)

    def train(self, generations: int = 100, episode_len: int = 400,
              seed: int = 0):
        """``generations`` of ask / rollout / tell; returns (best params
        (12,), best fitness, (w (3,H), b (3,)) refitted to them)."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        state = self.solver.init(torch.zeros(self.cfg.es.num_params,
                                             device=dev), device=dev)
        for g in range(generations):
            sols, state = self.solver.ask(state, gen)
            fitness = self._rollout_population(sols, gen, episode_len)
            state = self.solver.tell(state, fitness)
            fit_host = fitness.tolist()
            self.logger.add_scalar("ES/episode_reward",
                                   sum(fit_host) / len(fit_host), g)
            self.logger.add_scalar("ES/episode_maxre", max(fit_host), g)
        best, best_r, *_ = self.solver.result(state)
        w, b = etg_fit.opt_with_points(
            self.cfg.etg, points=self._prior + best.reshape(6, 2),
            w0=self._w0, b0=self._b0)
        return best, float(best_r), (w, b)
