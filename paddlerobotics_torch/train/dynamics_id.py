"""Sim-to-real dynamics identification (PyTorch port of the JAX package's
``train/dynamics_id.py``; rebuild of ETGRL/Dynamic_train.py +
model/Dynamic_parallel_model.py).

The reference fans an ES population of 48 normalized dynamics parameters
across RPC workers, each replaying a fixed gait in its own PyBullet and
scoring the std-normalized mismatch of joint-angle + gyro traces against
real-robot logs (loss_func, Dynamic_parallel_model.py:29-41). Here the
population IS the env batch: each candidate's 48 parameters become its
column of the batch-minor ``BDynParams`` (``envs/randomize.param2dynamic``)
injected by ``reset(dyn=...)``, so one batched rollout evaluates the whole
population, one physics-kernel launch per control step on the card.

On a mesh (``DynamicsIdentifier(mesh=)``, ``parallel/sharding``) the
population is split over the env axis, the reference's fan-out across
workers (Dynamic_parallel_model.py:95-99): each rank rolls its candidates'
columns and the fitness is all-gathered, so every rank holds the whole
population's and the ES solver takes the same step everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from paddlerobotics_torch.algos import es as es_mod
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.envs import randomize
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.parallel import sharding
from paddlerobotics_torch.sim.sbatch import BDynParams
from paddlerobotics_torch.train import metrics as metrics_mod


def _zero_etg(env):
    """The zeroed ETG readout: the reference replays raw gait positions in
    an ETG=0 env (Dynamic_parallel_model.py:49,61)."""
    H, B, dev = env.cfg.etg.H, env.B, env.device
    return (torch.zeros((3, H, B), device=dev),
            torch.zeros((3, B), device=dev))


@torch.no_grad()
def generate_trace(env: BatchedQuadrupedEnv, gait: torch.Tensor,
                   dyn: BDynParams, generator: torch.Generator | None,
                   noise_q: float = 0.0, noise_gyro: float = 0.0,
                   noise: Optional[dict] = None):
    """Replay ``gait`` (T,12) open-loop under ``dyn`` with the env's ETG
    zeroed and record the joint-angle + gyro response, the "real robot
    log" of recoverability studies, with optional measurement noise
    (standard normal ``noise["q"]`` (T,B,12) and ``noise["gyro"]``
    (T,B,3), drawn from ``generator`` when not given).

    Returns (q (T,B,12), gyro (T,B,3))."""
    B, dev = env.B, env.device
    gait = torch.as_tensor(gait, dtype=torch.float32, device=dev)
    zw, zb = _zero_etg(env)
    state, _ = env.reset(generator, etg_w=zw, etg_b=zb, dyn=dyn)
    qs, gs = [], []
    for t in range(gait.shape[0]):
        state, _, _, _, _ = env.step(state, gait[t][None, :].expand(B, 12),
                                     autoreset=False)
        s = state.robot.s
        qs.append(s.q.T)
        gs.append(s.w.T)
    q, gyro = torch.stack(qs), torch.stack(gs)
    if noise_q > 0.0 or noise_gyro > 0.0:
        noise = noise or {}
        draw = lambda k, x: noise[k].to(dev) if k in noise else torch.randn(
            x.shape, generator=generator, device=dev)
        q = q + noise_q * draw("q", q)
        gyro = gyro + noise_gyro * draw("gyro", gyro)
    return q, gyro


def trace_loss(sim_q, sim_gyro, real_q, real_gyro):
    """Std-normalized max-of-mean-squared-diff loss (loss_func,
    Dynamic_parallel_model.py:29-41); the std is the population one, as
    ``jnp.std``. Lower is better; fitness = −loss."""
    q_std = torch.std(real_q, dim=0, correction=0) + 1e-6        # (12,)
    g_std = torch.std(real_gyro, dim=0, correction=0) + 1e-6     # (3,)
    q_err = torch.mean(((sim_q - real_q) / q_std) ** 2, dim=0)
    g_err = torch.mean(((sim_gyro - real_gyro) / g_std) ** 2, dim=0)
    return torch.maximum(torch.mean(q_err), torch.mean(g_err))


class DynamicsIdentifier:
    def __init__(self, config: QuadrupedConfig, gait_actions,
                 real_q, real_gyro, popsize: int = 40, sigma: float = 0.5,
                 outdir: str = "dyn_id_log",
                 device: str | torch.device | None = None, mesh=None):
        """gait_actions (T,12) or (G,T,12): recorded joint-space commands
        (deltas from the default pose, like the gait_action_list npys);
        real_q (…,T,12) / real_gyro (…,T,3): the recorded responses.
        Several gaits are fitted jointly, their losses averaged, as the
        reference replays two gaits per candidate
        (Dynamic_parallel_model.py:70-77). Runs on the card unless
        ``device`` says otherwise; ``mesh`` splits the population over its
        env axis."""
        self.cfg = config
        self.P = popsize
        self.B = popsize
        self.device = dev = resolve_device(device)
        # candidate dynamics carry the full 0-80 ms latency range whatever
        # cfg.random says: the policy-obs blend must reach the whole ring
        config = dataclasses.replace(config, sim=dataclasses.replace(
            config.sim, obs_latency_taps=config.sim.latency_buffer_len))
        self.env = BatchedQuadrupedEnv(config, self.B, device=dev, mesh=mesh)
        self.cols = self.env.cols
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        gait = f32(gait_actions)
        if gait.dim() == 2:
            gait = gait[None]
        self.gait = gait                              # (G,T,12)
        self.G, self.T = gait.shape[0], gait.shape[1]
        self.real_q = f32(real_q).reshape(self.G, -1, 12)
        self.real_gyro = f32(real_gyro).reshape(self.G, -1, 3)
        self.solver = es_mod.SimpleGA(
            randomize.NUM_DYNAMIC_PARAMS, sigma_init=sigma,
            sigma_decay=0.99, sigma_limit=0.01, popsize=popsize,
            elite_ratio=0.1, weight_decay=0.0)
        self.logger = (metrics_mod.MetricsLogger(outdir,
                                                 use_tensorboard=False)
                       if sharding.is_writer() else metrics_mod.NullLogger())

    @torch.no_grad()
    def _fitness(self, solutions: torch.Tensor,
                 generator: torch.Generator | None) -> torch.Tensor:
        """(P,48) candidates → (P,) fitness, one batched replay rollout per
        gait; every gait's reset draws from the same ``generator`` state. On
        a mesh each rank rolls its candidates and the fitness is
        all-gathered."""
        cols, w = self.cols, self.env.B
        dyn = randomize.param2dynamic(cols.cut(solutions.to(self.device).T))
        zw, zb = _zero_etg(self.env)
        gen_state = None if generator is None else generator.get_state()
        losses = []
        for g in range(self.G):
            if gen_state is not None:
                generator.set_state(gen_state)
            state, _ = self.env.reset(generator, etg_w=zw, etg_b=zb, dyn=dyn)
            q_err = torch.zeros((w, 12), device=self.device)
            g_err = torch.zeros((w, 3), device=self.device)
            for t in range(self.T):
                state, _, _, _, _ = self.env.step(
                    state, self.gait[g, t][None, :].expand(w, 12),
                    autoreset=False)
                s = state.robot.s
                dq = s.q.T - self.real_q[g, t][None, :]         # (B,12)
                dg = s.w.T - self.real_gyro[g, t][None, :]      # (B,3)
                q_err = q_err + dq * dq
                g_err = g_err + dg * dg
            q_std = torch.std(self.real_q[g], dim=0, correction=0) + 1e-6
            g_std = torch.std(self.real_gyro[g], dim=0, correction=0) + 1e-6
            q_loss = torch.mean(q_err / self.T / q_std[None, :] ** 2, dim=1)
            g_loss = torch.mean(g_err / self.T / g_std[None, :] ** 2, dim=1)
            losses.append(torch.maximum(q_loss, g_loss))
        # mean over gaits (the reference averages the exp/ori rewards,
        # Dynamic_parallel_model.py:75)
        return cols.gather(-torch.mean(torch.stack(losses), dim=0))

    def score(self, solutions, generator: torch.Generator | None = None
              ) -> torch.Tensor:
        """Trace loss per candidate (N,48) against this identifier's traces,
        held-out scoring for recoverability studies; the candidates are
        tiled up to the population (the env batch). ``generator`` defaults
        to one seeded 0."""
        sols = torch.as_tensor(solutions, dtype=torch.float32,
                               device=self.device)
        sols = sols.reshape(-1, sols.shape[-1])
        n = sols.shape[0]
        tiled = sols.repeat(-(-self.P // n), 1)[:self.P]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return -self._fitness(tiled, generator)[:n]

    def identify(self, epochs: int = 50, seed: int = 0):
        """SimpleGA over the 48 parameters; returns (best (48,), its
        ``BDynParams`` at B=1)."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = self.solver.init(
            torch.zeros(randomize.NUM_DYNAMIC_PARAMS, device=dev),
            device=dev)
        for e in range(epochs):
            sols, state = self.solver.ask(state, gen)
            fit = self._fitness(sols, gen)
            state = self.solver.tell(state, fit)
            self.logger.add_scalar("dyn_id/best_loss", -float(fit.max()), e)
        best = self.solver.result(state)[0]
        return best, randomize.param2dynamic(best[:, None])
