"""ETG-RL dual-loop trainer: SAC residual policy + ES-optimised gait
(PyTorch port of the JAX package's ``train/etg_rl.py``).

The reference recipe (ETGRL/train.py:252-449) as batched autoreset
rollouts: a training chunk is a host loop over control steps, each one
policy draw, one env step (one physics-kernel launch on the card), one
replay write, one gather of K batches and K SAC updates, with every output
kept on the card until the chunk ends. The ES phase evaluates the whole
population in one batched rollout, each candidate gait fitted in one
batched solve and given a slice of the ES envs.

Schedule parity (train.py:34-47, 354-437):
- SAC: batch 256, γ .99, τ .005, α .2, lr 3e-4, warmup 1e4 env steps,
  replay 1e6; episode cap e_step 400 → +50 per eval window → 600.
- ES: every 5e4 env steps, 10 generations of SimpleGA (popsize 40,
  σ 0.02→0.005 ×0.99, elite 10%, weight decay 0.005) over 12 control-
  point offsets; ES rollouts optionally written to replay (--es_rpm,
  train.py:240-241).
- eval every 1e4 env steps (600-step deterministic episodes) with a
  ``torch.save`` checkpoint (``train/checkpoints.py``).

``evaluate`` (the function) is the deterministic rollout that evaluation
and deployment share (run_evaluate_episodes, train.py:182-211).

Randomness: every draw comes from an explicit ``torch.Generator``;
``rollout_chunk`` also takes its draws pre-drawn, step by step, so a test
can feed it JAX's.

State: unlike the JAX trainer's functional carry, ``TrainCarry``, the SAC
state and the replay buffer are updated in place (``rollout_chunk``,
``SAC.learn``, ``replay.add_batch``); none of them returns a new one. A
caller that keeps an earlier state takes a ``copy.deepcopy``, as
``keep_best_eval`` does.

Mesh (``ETGRLTrainer(mesh=)``, ``parallel/sharding``): every rank runs this
program on its env columns, the JAX trainer's placement made explicit
(``init_carry``; JAX's ``_place_on_mesh``, ``train/etg_rl.py:597-621``). The
env and the ES env hold the rank's columns and draw at the global shape; the
trainer's own draws (actions, warm-up, replay indices, learner noise, ES
candidates) come from the shared generator at the global shape too, and a
column that carries meaning (``det_rollout_frac``, ``warmup_gait_frac``, a
candidate, the ES replay sub-sample) is the global index. A step's
transitions are all-gathered over env and each rank keeps its replay row
block; ``SAC.learn`` all-reduces its gradients. Per-step means are global
means (one all-reduce per chunk), ES fitness a partial sum all-reduced (not
when the ES batch is replicated). Only rank 0 writes metrics and
checkpoints; a checkpoint holds the one-process layout. A mesh run computes
what the one-process run does, within float reordering.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlerobotics_torch.algos import es as es_mod
from paddlerobotics_torch.algos import replay, sac
from paddlerobotics_torch.algos.networks import GRUActor
from paddlerobotics_torch.algos.sac import SAC, SACState
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.envs.wrappers import ObsHistoryWrapper
from paddlerobotics_torch.etg import fit as etg_fit
from paddlerobotics_torch.parallel import sharding
from paddlerobotics_torch.train import checkpoints
from paddlerobotics_torch.train import metrics as metrics_mod

INFO_CHANNELS = ("torso", "up", "feet", "tau", "stand", "badfoot",
                 "footcontact", "velx", "success")
_NO_RNN = ("None", "none", "", None)


@torch.no_grad()
def evaluate(env, actor, etg_w: torch.Tensor, etg_b: torch.Tensor,
             n_steps: int, generator: torch.Generator | None = None,
             dr_scale: float | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Deterministic eval of the (3,H)/(3,) ETG readout shared by all envs.

    Returns (mean return, mean episode length, info-channel means summed
    over steps) as 0-d tensors on the env's device; envs stop counting
    once done (no autoreset). On a mesh the means are over the global batch
    (one all-reduce at the end)."""
    dev = env.device
    B, cols = env.B, env.cols
    w_env = etg_w.to(dev)[..., None].repeat(1, 1, B)
    b_env = etg_b.to(dev)[:, None].repeat(1, B)
    state, obs = env.reset(generator, etg_w=w_env, etg_b=b_env,
                           dr_scale=dr_scale)
    bound = torch.as_tensor(env.act_bound, device=dev)
    offset = torch.as_tensor(env.act_offset, device=dev)
    ret = torch.zeros(B, device=dev)
    alive = torch.ones(B, device=dev)
    steps = torch.zeros(B, device=dev)
    infos = {k: torch.zeros((), device=dev) for k in INFO_CHANNELS}
    for _ in range(n_steps):
        action = sac.predict(actor, obs)
        state, obs, rew, done, info = env.step(
            state, action * bound + offset, autoreset=False)
        ret = ret + rew * alive
        steps = steps + alive
        infos = {k: infos[k] + cols.part_mean(info[k] * alive)
                 for k in INFO_CHANNELS}
        alive = alive * (1.0 - done.to(torch.float32))
    out = cols.reduce(torch.stack([cols.part_mean(ret), cols.part_mean(steps),
                                   *infos.values()]))
    return out[0], out[1], dict(zip(INFO_CHANNELS, out[2:]))


def _seeded(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer tuple ``key``
    (mixed by numpy's SeedSequence, so (s, 1) and (s + 1, 0) differ)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(list(key))
                      .generate_state(1, np.uint64)[0]))
    return g


class AdaptiveDRController:
    """Success-gated DR-scale schedule (ADR-style alternative to the
    linear anneal): widen the randomisation scale while the EMA success
    rate clears `hi`, back off below `lo`, within
    [dr_scale_start, dynamics_scale]. Host-side logic on the carried
    ``BEnvState.dr_scale``."""

    def __init__(self, rcfg, ema_decay: float = 0.9):
        self.scale = rcfg.dr_scale_start
        self.lo = rcfg.dr_success_lo
        self.hi = rcfg.dr_success_hi
        self.step_up = rcfg.dr_step_up
        self.step_down = rcfg.dr_step_down
        self.min_scale = rcfg.dr_scale_start
        self.max_scale = rcfg.dynamics_scale
        self.ema_decay = ema_decay
        self.ema = None

    def update(self, success: float) -> float:
        """Feed one rollout chunk's mean success; returns the new scale."""
        self.ema = (success if self.ema is None else
                    self.ema_decay * self.ema +
                    (1.0 - self.ema_decay) * success)
        if self.ema >= self.hi:
            self.scale += self.step_up
        elif self.ema < self.lo:
            self.scale -= self.step_down
        self.scale = min(max(self.scale, self.min_scale), self.max_scale)
        return self.scale


def _build_solver(ecfg):
    """The configured ES solver (train.py uses SimpleGA; all five
    selectable via ESConfig.solver)."""
    name = ecfg.solver
    if name == "simple_ga":
        return es_mod.SimpleGA(
            ecfg.num_params, sigma_init=ecfg.sigma_init,
            sigma_decay=ecfg.sigma_decay, sigma_limit=ecfg.sigma_limit,
            popsize=ecfg.popsize, elite_ratio=ecfg.elite_ratio,
            weight_decay=ecfg.weight_decay)
    if name == "simple_es":
        return es_mod.SimpleES(
            ecfg.num_params, popsize=ecfg.popsize,
            sigma_init=ecfg.sigma_init, sigma_decay=ecfg.sigma_decay,
            sigma_limit=ecfg.sigma_limit, weight_decay=ecfg.weight_decay)
    if name == "open_es":
        return es_mod.OpenES(
            ecfg.num_params, sigma_init=ecfg.sigma_init,
            sigma_decay=ecfg.sigma_decay, sigma_limit=ecfg.sigma_limit,
            popsize=ecfg.popsize, weight_decay=ecfg.weight_decay)
    if name == "pepg":
        return es_mod.PEPG(
            ecfg.num_params, sigma_init=ecfg.sigma_init,
            sigma_decay=ecfg.sigma_decay, sigma_limit=ecfg.sigma_limit,
            popsize=ecfg.popsize, weight_decay=ecfg.weight_decay)
    if name == "cma_es":
        return es_mod.CMAES(ecfg.num_params, sigma_init=ecfg.sigma_init,
                            popsize=ecfg.popsize,
                            weight_decay=ecfg.weight_decay)
    raise ValueError(f"unknown ES solver {name!r}")


@dataclasses.dataclass
class TrainCarry:
    """The training loop's live state, updated in place."""
    env_state: object            # BEnvState (or ObsHistoryState)
    obs: torch.Tensor
    sac_state: SACState
    buffer: replay.ReplayBuffer
    rng: torch.Generator         # the trainer's draws (the env has its own)


class ETGRLTrainer:
    def __init__(self, config: QuadrupedConfig, num_envs: int | None = None,
                 outdir: str = "train_log", updates_per_step: int = 1,
                 use_tensorboard: bool = False, mesh=None,
                 device: str | torch.device | None = None):
        """Runs on the card unless ``device`` says otherwise; ``mesh``, a
        ``parallel.sharding.make_mesh`` over ranks on the same device type,
        trains over its env and model axes (``B`` stays the global batch)."""
        self.cfg = config
        self.B = num_envs or config.train.num_envs
        self.device = dev = resolve_device(device)
        self.mesh = mesh
        self.env = BatchedQuadrupedEnv(config, self.B, device=dev, mesh=mesh)
        self.cols = self.env.cols
        # Temporal observation modes (SENSOR_MODE['RNN'], train.py:273-277):
        # 'stack' flattens a (T+1)-frame history for the MLP policy; 'GRU'
        # keeps the same stacked storage and encodes it with a recurrent
        # actor.
        actor = None
        rnn_mode = config.sensors.rnn_mode
        if rnn_mode not in _NO_RNN:
            if rnn_mode not in ("stack", "GRU"):
                raise ValueError(f"unknown RNN_mode {rnn_mode!r} "
                                 "(expected None|stack|GRU)")
            base_dim = self.env.obs_dim
            self.env = self._wrap(self.env)
            if rnn_mode == "GRU":
                actor = functools.partial(
                    GRUActor, base_dim, self.env.action_dim,
                    hidden=config.sac.hidden_dim,
                    seq_len=config.sensors.rnn_time_steps + 1)
        self.sac = SAC(self.env.obs_dim, self.env.action_dim, config.sac,
                       actor=actor, device=dev, mesh=mesh)
        ecfg = config.es
        # Dedicated (smaller) env batch for ES population rollouts
        # (ESConfig.es_num_envs), with the training env's wrappers.
        if ecfg.es_num_envs and 0 < ecfg.es_num_envs < self.B \
                and ecfg.popsize > 0:
            B_es = max(ecfg.popsize,
                       (ecfg.es_num_envs // ecfg.popsize) * ecfg.popsize)
            es_env = BatchedQuadrupedEnv(config, B_es, device=dev,
                                         mesh=mesh)
            if rnn_mode not in _NO_RNN:
                es_env = self._wrap(es_env)
            self.es_env, self.es_B = es_env, B_es
        else:
            self.es_env, self.es_B = self.env, self.B
        self.solver = _build_solver(ecfg)
        self.updates_per_step = updates_per_step
        self.outdir = outdir
        self._restore_from = None
        self.logger = (metrics_mod.MetricsLogger(outdir, use_tensorboard)
                       if sharding.is_writer() else metrics_mod.NullLogger())
        self.act_bound = torch.as_tensor(self.env.act_bound, device=dev)
        self.act_offset = torch.as_tensor(self.env.act_offset, device=dev)
        self._prior_points = torch.as_tensor(
            etg_fit.prior_points(config.etg), dtype=torch.float32,
            device=dev)
        self._w0, self._b0 = etg_fit.opt_with_points(config.etg, device=dev)

    def _wrap(self, env):
        s = self.cfg.sensors
        return ObsHistoryWrapper(env, time_steps=s.rnn_time_steps,
                                 time_interval=s.rnn_time_interval,
                                 mode="stack")

    def restore(self, target: str):
        """Arm a checkpoint restore for the next train() call (the
        reference's --load, train.py:333-334)."""
        self._restore_from = target
        return self

    # -- ETG fitting ---------------------------------------------------------

    def fit_etg(self, param12: torch.Tensor):
        """12 ES params → proximally refitted (w, b) (train.py:350-352)."""
        pts = self._prior_points + torch.as_tensor(
            param12, dtype=torch.float32, device=self.device).reshape(6, 2)
        return etg_fit.opt_with_points(self.cfg.etg, points=pts,
                                       w0=self._w0, b0=self._b0)

    def fit_etg_population(self, params: torch.Tensor):
        """(P,12) → (P,3,H), (P,3)."""
        pts = self._prior_points[None] + params.reshape(-1, 6, 2)
        return etg_fit.batched_opt_with_points(
            self.cfg.etg, pts, self._w0, self._b0, device=self.device)

    @staticmethod
    def _inner(env_state):
        return getattr(env_state, "env_state", env_state)

    def _set_inner(self, env_state, **kw):
        inner = self._inner(env_state).replace(**kw)
        if hasattr(env_state, "env_state"):          # ObsHistoryState
            return env_state._replace(env_state=inner)
        return inner

    def _set_etg(self, env_state, w_env, b_env):
        """Swap the carried ETG readout, through the (optional)
        observation-history wrapper state."""
        return self._set_inner(env_state, etg_w=w_env, etg_b=b_env)

    def _set_dr_scale(self, env_state, scale: float):
        """Set the DR curriculum scale (the carried BEnvState field)."""
        return self._set_inner(env_state, dr_scale=torch.as_tensor(
            scale, dtype=torch.float32, device=self.device))

    def _broadcast_etg(self, w, b, B: int | None = None):
        """(3,H)/(3,) → batch-minor (3,H,B)/(3,B) (this rank's columns)."""
        B = B or self.env.B
        return (w[..., None].expand(*w.shape, B).contiguous(),
                b[..., None].expand(*b.shape, B).contiguous())

    # -- SAC rollout+learn chunk ---------------------------------------------

    def init_carry(self, seed: int, init_etg_param=None
                   ) -> Tuple[TrainCarry, torch.Tensor, torch.Tensor]:
        """The start of training from ``seed``: fresh SAC state, env reset
        on the gait fitted to ``init_etg_param`` (zeros by default), empty
        replay; returns (carry, w, b). On a mesh this is the placement of
        JAX's ``_place_on_mesh``: the env reset is the rank's columns of
        the one-process reset, the learner column-parallel over model and
        the same on every env rank, the replay the rank's row block."""
        cfg, dev = self.cfg, self.device
        if init_etg_param is None:
            init_etg_param = torch.zeros(cfg.es.num_params, device=dev)
        w, b = self.fit_etg(init_etg_param)
        w_env, b_env = self._broadcast_etg(w, b)
        env_state, obs = self.env.reset(_seeded(dev, seed, 0), etg_w=w_env,
                                        etg_b=b_env)
        buf = replay.create(cfg.sac.memory_size, self.env.obs_dim,
                            self.env.action_dim, device=dev, mesh=self.mesh)
        sac_state = self.sac.init(_seeded(dev, seed, 1))
        for m in (sac_state.actor, sac_state.critic, sac_state.target_critic):
            sharding.replicate(self.mesh, m)
        carry = TrainCarry(env_state, obs, sac_state, buf,
                           _seeded(dev, seed, 2))
        return carry, w, b

    def rollout_chunk(self, carry: TrainCarry, e_step: int, n_steps: int,
                      warm: bool, draws: Optional[Sequence[dict]] = None
                      ) -> Dict[str, torch.Tensor]:
        """``n_steps`` control steps of rollout + replay write + (warm) K
        SAC updates each, advancing ``carry`` in place; returns the
        per-step means averaged over the chunk (0-d tensors on the card;
        nothing is read back to the host inside the loop).

        ``draws``: one dict per step replacing the carry's generator —
        warm: ``act`` (B,a) standard normal, ``idx`` (K·batch,) replay
        rows, ``learn`` K pairs (next_noise, pi_noise); cold: ``uniform``
        (B,a) in [−1, 1), ``gait`` (B,a) standard normal. On a mesh they
        are the global batch's; each rank takes its columns."""
        env, cfg, B, K = self.env, self.cfg, self.B, self.updates_per_step
        a_dim, dev, cols = self.env.action_dim, self.device, self.cols
        env_state, obs = carry.env_state, carry.obs
        state, buf, gen = carry.sac_state, carry.buffer, carry.rng
        first = lambda frac: (cols.index(dev) < int(frac * B))[:, None]

        def draw(key, fn):
            # a draw of the global (B, a) batch (or the caller's), cut to
            # this rank's columns
            x = d.get(key)
            if x is None:
                x = fn((B, a_dim), generator=gen, device=dev)
            return cols.cut(x.to(dev), 0)

        outs = []
        for i in range(n_steps):
            d = draws[i] if draws is not None else {}
            with torch.no_grad():
                if warm:
                    action, _ = sac.sample(state.actor, obs,
                                           draw("act", torch.randn))
                    if int(cfg.sac.det_rollout_frac * B) > 0:
                        # the first envs roll the mean action so replay
                        # covers the eval-time state distribution
                        action = torch.where(
                            first(cfg.sac.det_rollout_frac),
                            sac.predict(state.actor, obs), action)
                else:
                    action = draw("uniform", lambda *a, **k: torch.rand(
                        *a, **k) * 2.0 - 1.0)
                    if int(cfg.sac.warmup_gait_frac * B) > 0:
                        # the first envs roll the open-loop gait (a small
                        # residual) so replay sees walking from step one
                        on_gait = torch.clamp(
                            cfg.sac.warmup_gait_sigma
                            * draw("gait", torch.randn), -1.0, 1.0)
                        action = torch.where(first(cfg.sac.warmup_gait_frac),
                                             on_gait, action)
                donef = (self._inner(env_state).step_idx + 1) > e_step
                env_state, nobs, rew, done, info = env.step(
                    env_state, action * self.act_bound + self.act_offset,
                    donef)
                terminal = 1.0 - done.to(torch.float32)  # train.py:148-149
                replay.add_rows(buf, cols.gather(replay.rows(
                    obs, action, rew, nobs, terminal)))
            out = {"reward": cols.part_mean(rew),
                   "done_frac": cols.part_mean(done.to(torch.float32)),
                   **{k: cols.part_mean(info[k]) for k in INFO_CHANNELS}}
            if warm and K > 0:
                # K updates per batched env step, their batches gathered in
                # one pass (the buffer does not change between them)
                batches = replay.sample_many(buf, K, cfg.sac.batch_size,
                                             generator=gen, idx=d.get("idx"))
                losses = []
                for k in range(K):
                    losses.append(self.sac.learn(
                        state, {f: v[k] for f, v in batches.items()},
                        noise=d["learn"][k] if "learn" in d else None,
                        generator=gen))
                for name in ("critic_loss", "actor_loss"):
                    out[name] = torch.mean(torch.stack(
                        [l_k[name] for l_k in losses]))
            else:
                out["critic_loss"] = out["actor_loss"] = \
                    torch.zeros((), device=dev)
            outs.append(out)
            obs = nobs
        carry.env_state, carry.obs = env_state, obs
        res = {k: torch.mean(torch.stack([o[k] for o in outs]))
               for k in outs[0]}
        # the env's means summed over the ranks in one collective (the
        # learner's losses are global already)
        env_keys = [k for k in res if k not in ("critic_loss", "actor_loss")]
        res.update(zip(env_keys, cols.reduce(
            torch.stack([res[k] for k in env_keys]))))
        return res

    # -- ES population evaluation --------------------------------------------

    @torch.no_grad()
    def es_eval(self, actor, etg_w_pop, etg_b_pop, generator, n_steps: int,
                popsize: int, buffer: replay.ReplayBuffer | None = None):
        """Evaluate a population in one batched rollout.

        etg_w_pop (P,3,H), etg_b_pop (P,3). Candidate p runs on envs
        [p·B/P, (p+1)·B/P) (the remainder on the last) with the frozen
        deterministic policy (run_EStrain_episode, train.py:213-249).
        Returns per-candidate mean return and mean episode length; with
        ``buffer`` (--es_rpm, train.py:240-241) the first env of each
        candidate also feeds replay (P transitions per step, written in
        place). On a mesh the candidates ride the ES env's columns (global
        indices), the P replay rows are cut from the all-gathered step, and
        the per-candidate sums are all-reduced unless the ES batch is
        replicated."""
        B, P, dev = self.es_B, popsize, self.device
        cols = self.es_env.cols
        per = B // P
        cand = torch.clamp(cols.index(dev) // per, max=P - 1)
        w_env = torch.movedim(etg_w_pop[cand], 0, -1).contiguous()  # (3,H,B)
        b_env = torch.movedim(etg_b_pop[cand], 0, -1).contiguous()  # (3,B)
        # dr_scale=es_dyn_scale (default 0: nominal dynamics) so ES fitness
        # does not ride the training draws (ESConfig.es_nominal_dyn)
        dr0 = (self.cfg.es.es_dyn_scale
               if (self.cfg.es.es_nominal_dyn
                   and self.cfg.random.random_dynamics) else None)
        state, obs = self.es_env.reset(generator, etg_w=w_env, etg_b=b_env,
                                       dr_scale=dr0)
        sub = torch.arange(P, device=dev) * per      # replay sub-sample
        ret = torch.zeros(cols.width, device=dev)
        alive = torch.ones(cols.width, device=dev)
        steps = torch.zeros(cols.width, device=dev)
        for _ in range(n_steps):
            action = sac.predict(actor, obs)
            state, nobs, rew, done, _ = self.es_env.step(
                state, action * self.act_bound + self.act_offset,
                autoreset=False)
            if buffer is not None:
                replay.add_rows(buffer, cols.gather(replay.rows(
                    obs, action, rew, nobs,
                    1.0 - done.to(torch.float32)))[sub])
            ret = ret + rew * alive
            steps = steps + alive
            alive = alive * (1.0 - done.to(torch.float32))
            obs = nobs
        seg = lambda x: torch.zeros(P, device=dev).index_add_(0, cand, x)
        out = cols.reduce(torch.stack([seg(ret), seg(steps)]))
        return out[0] / per, out[1] / per

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, actor, etg_w, etg_b, n_steps: int,
                 generator: torch.Generator | None = None, dr_scale=None):
        """Deterministic eval on the training env's batch (the function
        ``evaluate``; run_evaluate_episodes, train.py:182-211)."""
        return evaluate(self.env, actor, etg_w, etg_b, n_steps,
                        generator=generator, dr_scale=dr_scale)

    def _es_baseline(self, carry, w, b):
        """Current-gait baseline episode (train.py:395)."""
        dr0 = (self.cfg.es.es_dyn_scale
               if (self.cfg.es.es_nominal_dyn
                   and self.cfg.random.random_dynamics) else None)
        ret, steps, _ = self.evaluate(
            carry.sac_state.actor, w, b, self.cfg.es.es_episode_len,
            dr_scale=dr0)
        return float(ret), float(steps)

    # -- main loop -----------------------------------------------------------

    def train(self, max_steps: int | None = None, chunk_steps: int = 50,
              seed: int = 0, checkpoint: bool = True, init_etg_param=None):
        """init_etg_param: 12 control-point offsets to start the gait from
        (the reference's --ETG_path npz "param", train.py:281-295)."""
        cfg, dev = self.cfg, self.device
        tcfg = cfg.train
        max_steps = max_steps or tcfg.max_steps
        restored = None
        if self._restore_from:
            restored = checkpoints.restore(self._restore_from, device=dev)
            init_etg_param = restored["etg_param"]
        if init_etg_param is not None:
            init_etg_param = torch.as_tensor(
                init_etg_param, dtype=torch.float32, device=dev)
        carry, w, b = self.init_carry(seed, init_etg_param)
        if restored is not None:
            checkpoints.load_sac_state(carry.sac_state, restored["sac"])
        etg_best_param = torch.zeros(cfg.es.num_params, device=dev) \
            if init_etg_param is None else init_etg_param
        es_state = self.solver.init(etg_best_param, device=dev)

        total_steps = 0
        e_step = tcfg.e_step
        test_flag = es_flag = es_gen = reset_flag = 0
        # eval-peak artifact tracking (TrainConfig.keep_best_eval)
        best_key = (-math.inf, -math.inf)
        best_snap = None

        anneal = cfg.sac.alpha_anneal_steps
        if anneal > 0 and cfg.sac.auto_alpha:
            raise ValueError("alpha_anneal_steps and auto_alpha are "
                             "mutually exclusive")

        rcfg = cfg.random
        dr_adaptive = rcfg.random_dynamics and rcfg.dr_adaptive
        dr_curr = (rcfg.random_dynamics and rcfg.dr_curriculum_steps > 0
                   and not dr_adaptive)
        adr = AdaptiveDRController(rcfg) if dr_adaptive else None
        if dr_curr or dr_adaptive:
            carry.env_state = self._set_dr_scale(carry.env_state,
                                                 rcfg.dr_scale_start)

        while total_steps < max_steps:
            warm = total_steps >= cfg.sac.warmup_steps
            if anneal > 0:
                frac = min(1.0, total_steps / anneal)
                a_now = cfg.sac.alpha + frac * (cfg.sac.alpha_final -
                                                cfg.sac.alpha)
                with torch.no_grad():
                    carry.sac_state.log_alpha.fill_(math.log(a_now))
            if dr_curr:
                frac = min(1.0, total_steps / rcfg.dr_curriculum_steps)
                scale = rcfg.dr_scale_start + frac * (
                    rcfg.dynamics_scale - rcfg.dr_scale_start)
                carry.env_state = self._set_dr_scale(carry.env_state, scale)
                self.logger.add_scalar("train/dr_scale", scale, total_steps)
            out = self.rollout_chunk(carry, e_step, chunk_steps, warm)
            out = dict(zip(out, torch.stack(list(out.values())).tolist()))
            if adr is not None:
                scale = adr.update(out["success"])
                carry.env_state = self._set_dr_scale(carry.env_state, scale)
                self.logger.add_scalar("train/dr_scale", scale, total_steps)
            total_steps += chunk_steps * self.B
            self.logger.add_scalar("train/episode_reward", out["reward"],
                                   total_steps)
            for k in INFO_CHANNELS:
                self.logger.add_scalar(f"train/mean_{k}", out[k],
                                       total_steps)
            if warm:
                self.logger.add_scalar("train/critic_loss",
                                       out["critic_loss"], total_steps)

            # periodic critic reset (plasticity stabiliser,
            # SACConfig.critic_reset_steps; actor and replay kept)
            rst = cfg.sac.critic_reset_steps
            if rst > 0 and total_steps // rst > reset_flag and warm:
                reset_flag = total_steps // rst
                # on a mesh the fresh critic is column-parallel again
                # (JAX re-shards it, train/etg_rl.py:508-515)
                self.sac.reset_critic(carry.sac_state,
                                      _seeded(dev, 911, reset_flag))
                self.logger.add_scalar("train/critic_reset", 1.0,
                                       total_steps)

            # eval window (train.py:370-390)
            if (total_steps + 1) // tcfg.eval_every_steps > test_flag:
                test_flag = (total_steps + 1) // tcfg.eval_every_steps
                avg_ret, avg_steps, _ = self.evaluate(
                    carry.sac_state.actor, w, b, tcfg.eval_episode_len)
                avg_ret, avg_steps = float(avg_ret), float(avg_steps)
                self.logger.add_scalar("eval/episode_reward", avg_ret,
                                       total_steps)
                self.logger.add_scalar("eval/episode_step", avg_steps,
                                       total_steps)
                if tcfg.keep_best_eval and (avg_steps, avg_ret) > best_key:
                    best_key = (avg_steps, avg_ret)
                    # the live state moves on in place: keep a copy
                    best_snap = (copy.deepcopy(carry.sac_state), w, b,
                                 etg_best_param, total_steps)
                if e_step < tcfg.e_step_max:
                    e_step += tcfg.e_step_growth
                if checkpoint:        # every rank gathers, rank 0 writes
                    checkpoints.save(self.outdir, carry.sac_state, w, b,
                                     etg_best_param, total_steps)

            # ES phase (train.py:392-437)
            if (cfg.es.popsize > 0 and
                    (total_steps + 1) // cfg.es.es_every_steps > es_flag and
                    total_steps >= cfg.sac.warmup_steps):
                es_flag = (total_steps + 1) // cfg.es.es_every_steps
                best_reward, _ = self._es_baseline(carry, w, b)
                best_param = etg_best_param
                for _ in range(cfg.es.es_train_steps):
                    solutions, es_state = self.solver.ask(es_state,
                                                          carry.rng)
                    ws, bs = self.fit_etg_population(solutions)
                    fitness, _ = self.es_eval(
                        carry.sac_state.actor, ws, bs, carry.rng,
                        cfg.es.es_episode_len, cfg.es.popsize,
                        carry.buffer if cfg.es.es_rpm else None)
                    es_state = self.solver.tell(es_state, fitness)
                    fit_host = fitness.tolist()
                    gen_best = int(np.argmax(fit_host))
                    if fit_host[gen_best] > best_reward:
                        best_reward = fit_host[gen_best]
                        best_param = solutions[gen_best]
                    es_gen += 1
                    self.logger.add_scalar("ES/episode_reward",
                                           float(np.mean(fit_host)), es_gen)
                    self.logger.add_scalar("ES/episode_maxre",
                                           max(fit_host), es_gen)
                    self.logger.add_scalar(
                        "ES/sigma", float(torch.mean(es_state.sigma)),
                        es_gen)
                etg_best_param = best_param
                w, b = self.fit_etg(etg_best_param)
                if hasattr(self.solver, "reset"):
                    es_state = self.solver.reset(es_state, etg_best_param)
                # refresh the env's ETG for the following SAC rollouts
                w_env, b_env = self._broadcast_etg(w, b)
                carry.env_state = self._set_etg(carry.env_state, w_env,
                                                b_env)

        if tcfg.keep_best_eval and best_snap is not None:
            # a final eval-window check so the last policy competes too
            avg_ret, avg_steps, _ = self.evaluate(
                carry.sac_state.actor, w, b, tcfg.eval_episode_len)
            if (float(avg_steps), float(avg_ret)) < best_key:
                sac_best, w, b, etg_best_param, at = best_snap
                carry.sac_state = sac_best
                self.logger.add_scalar("train/best_eval_restored_from",
                                       float(at), total_steps)
        return carry, (w, b, etg_best_param)
