"""Behavior-cloning distillation trainer (PyTorch port of the JAX package's
``train/bc_train.py``, rebuild of ETGRL/BCtrain.py).

Reference semantics (BCtrain.py):
- The STUDENT rolls the env (``agent.sample(agent_obs)``,
  BCtrain.py:102-106, DAgger-style on-policy collection), storing paired
  (student_obs, expert_obs) transitions; the first phase's actions are
  uniform random (BCtrain.py:34, 102-104).
- Student obs = expert obs without the 3 BaseDisplacement dims
  (cal_agent_obs, BCtrain.py:77-81), optionally noised (obs2noise,
  BCtrain.py:53-58: rpy/drpy/q/q̇ slices) during both collection and eval.
- Every 1024 collected samples: ``distill_epochs`` × (batches in the
  buffer, bucketed to a power of two, at most 64) BC updates at batch 1024
  (BCtrain.py:38-40, 123-137), then a final full-buffer pass.
- Headline metric: the ratio of the student's to the expert's
  deterministic return ("ref_ratio", BCtrain.py:183-186).

Collection is a batched rollout (B envs together, one physics-kernel
launch per control step on the card). Every draw comes from an explicit
``torch.Generator`` or is passed pre-drawn, so a test can feed JAX's.

On a mesh (``BCTrainer(mesh=)``, ``parallel/sharding``) each env rank rolls
its columns of the batch, every draw made at the global shape and cut;
``collect`` returns the all-gathered (global) views, so the BC buffer and the
distillation are the one process's on every rank, and ``evaluate``'s means
are global.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from paddlerobotics_torch.algos import replay
from paddlerobotics_torch.algos.bc import BC, BCState
from paddlerobotics_torch.algos import sac
from paddlerobotics_torch.algos.sac import SACState
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.parallel import sharding
from paddlerobotics_torch.train import metrics as metrics_mod

# obs2noise (BCtrain.py:53-58) in the TRUNCATED (obs[3:]) layout, with
# the reference's raw-σ/normalizer folded into normalized-obs units:
# rpy[4:7] 6e-2/0.1, drpy[7:10] 1e-1/0.5, q[10:22] 1e-2/0.1, q̇[22:34] 0.5.
_NOISE_SLICES = ((4, 7, 0.6), (7, 10, 0.2), (10, 22, 0.1), (22, 34, 0.5))
NOISE_LO, NOISE_HI = _NOISE_SLICES[0][0], _NOISE_SLICES[-1][1]
NOISE_DIM = NOISE_HI - NOISE_LO
REF_BATCH = 1024          # BCtrain.py:38-40: samples per phase, batch size
MAX_BUCKET = 64           # the distill phase's batch count is capped here


def student_view(obs: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cal_agent_obs (BCtrain.py:77-81): drop BaseDisplacement; with
    ``noise`` (…, NOISE_DIM) standard normal draws, add σ·noise to the
    view's columns [NOISE_LO, NOISE_HI) (``_NOISE_SLICES``' σ per slice)."""
    s = obs[..., 3:]
    if noise is None:
        return s
    sigma = torch.cat([torch.full((hi - lo,), sd, device=obs.device)
                       for lo, hi, sd in _NOISE_SLICES])
    return torch.cat([s[..., :NOISE_LO],
                      s[..., NOISE_LO:NOISE_HI] + sigma * noise,
                      s[..., NOISE_HI:]], dim=-1)


def distill_updates(steps: int, capacity: int, distill_epochs: int) -> int:
    """BC updates of the distill phase after ``steps`` collected samples:
    the reference sweeps the whole buffer ``distill_epochs`` times
    (BCtrain.py:129-131), so the count grows with the buffer; its batch
    count is bucketed to a power of two and capped at ``MAX_BUCKET``."""
    n_batches = max(min(steps, capacity) // REF_BATCH, 1)
    bucket = 1 << max(n_batches - 1, 0).bit_length()
    return distill_epochs * min(bucket, MAX_BUCKET)


class BCTrainer:
    def __init__(self, config: QuadrupedConfig, expert_state: SACState,
                 etg_w: Optional[torch.Tensor] = None,
                 etg_b: Optional[torch.Tensor] = None,
                 num_envs: int = 256, outdir: str = "bc_log",
                 sensor_noise: bool = False,
                 device: str | torch.device | None = None, mesh=None):
        """Runs on the card unless ``device`` says otherwise; the expert
        (a ``SACState``) on the same device. ``mesh``: roll the batch's
        columns over its env axis (``num_envs`` stays the global batch)."""
        self.cfg = config
        self.B = num_envs
        self.device = dev = resolve_device(device)
        self.env = BatchedQuadrupedEnv(config, self.B, device=dev, mesh=mesh)
        self.cols = self.env.cols
        self.expert_state = expert_state
        self.student_obs_dim = self.env.obs_dim - 3
        self.bc = BC(self.student_obs_dim, 12, device=dev)
        self.sensor_noise = sensor_noise
        self.logger = (metrics_mod.MetricsLogger(outdir,
                                                 use_tensorboard=False)
                       if sharding.is_writer() else metrics_mod.NullLogger())
        self.act_bound = torch.as_tensor(self.env.act_bound, device=dev)
        self.act_offset = torch.as_tensor(self.env.act_offset, device=dev)
        # the expert's trained gait: (3,H)/(3,) → batch-minor (3,H,B)/(3,B)
        self._etg_w = self._etg_b = None
        if etg_w is not None:
            f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                            device=dev)
            self._etg_w = f32(etg_w)[..., None].repeat(1, 1, self.env.B)
            self._etg_b = f32(etg_b)[:, None].repeat(1, self.env.B)

    def reset(self, generator: torch.Generator | None = None):
        return self.env.reset(generator, etg_w=self._etg_w,
                              etg_b=self._etg_b)

    def _draw(self, d: dict, key: str, fn, width: int, generator):
        """``d[key]`` or ``fn`` at the global (B, width), cut to this rank's
        rows."""
        x = d.get(key)
        if x is None:
            x = fn((self.B, width), generator=generator, device=self.device)
        return self.cols.cut(x.to(self.device), 0)

    def _noise(self, d: dict, key: str, generator) -> Optional[torch.Tensor]:
        if not self.sensor_noise:
            return None
        return self._draw(d, key, torch.randn, NOISE_DIM, generator)

    @torch.no_grad()
    def collect(self, bc_state: BCState, env_state, obs: torch.Tensor,
                n_steps: int, warmup: bool,
                generator: torch.Generator | None = None,
                draws: Optional[Sequence[dict]] = None):
        """Roll the STUDENT ``n_steps`` with autoreset (BCtrain.py:102-106).
        Returns (env_state, obs, (student views (n·B, d_s), expert views
        (n·B, d_e))), step-major. ``draws``: one dict per step replacing
        ``generator`` — ``act`` (B,12), uniform in [−1, 1) in the warm-up,
        else the student's standard normal sample noise; ``noise``
        (B, NOISE_DIM) for the student view, with sensor noise. On a mesh
        the env state and obs are this rank's columns, the views the
        global batch's (all-gathered)."""
        s_list, e_list = [], []
        uniform = lambda *a, **k: torch.rand(*a, **k) * 2.0 - 1.0
        for i in range(n_steps):
            d = draws[i] if draws is not None else {}
            s_obs = student_view(obs, self._noise(d, "noise", generator))
            if warmup:
                act = self._draw(d, "act", uniform, 12, generator)
            else:
                act, _ = sac.sample(bc_state.actor, s_obs, self._draw(
                    d, "act", torch.randn, 12, generator))
            env_state, nobs, _, _, _ = self.env.step(
                env_state, act * self.act_bound + self.act_offset)
            s_list.append(s_obs)
            e_list.append(obs)
            obs = nobs
        views = [self.cols.gather(torch.stack(v), 1).flatten(0, 1)
                 for v in (s_list, e_list)]
        return env_state, obs, tuple(views)

    def distill(self, bc_state: BCState, buf: replay.BCReplayBuffer,
                n_updates: int, batch_size: int = REF_BATCH,
                generator: torch.Generator | None = None,
                draws: Optional[Sequence[dict]] = None
                ) -> Dict[str, torch.Tensor]:
        """``n_updates`` × BClearn at the reference batch (BCtrain.py:40),
        in place; returns the mean losses (0-d tensors). ``draws``: one
        dict per update with ``idx`` (batch,) rows and ``noise`` (batch,
        12) sample noise."""
        losses = []
        for i in range(n_updates):
            d = draws[i] if draws is not None else {}
            batch = replay.bc_sample(buf, batch_size, generator, d.get("idx"))
            losses.append(self.bc.learn(bc_state, batch, self.expert_state,
                                        noise=d.get("noise"),
                                        generator=generator))
        return {k: torch.mean(torch.stack([l_[k] for l_ in losses]))
                for k in ("actor_loss", "critic_loss")}

    @torch.no_grad()
    def evaluate(self, actor, who: str, n_steps: int = 600,
                 generator: torch.Generator | None = None):
        """Deterministic eval (run_evaluate_episodes, BCtrain.py:148-176),
        no autoreset: who='student' predicts on the (optionally noised)
        truncated view, who='expert' on the full obs. The reset draws come
        from ``generator`` (default: seeded 0), the view's noise from a
        generator seeded 17. Returns 0-d tensors (mean return, mean
        steps, velx and success per step)."""
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        noise_gen = torch.Generator(device=dev).manual_seed(17)
        state, obs = self.reset(generator)
        cols = self.cols
        ret = torch.zeros(self.env.B, device=dev)
        alive = torch.ones(self.env.B, device=dev)
        steps = torch.zeros(self.env.B, device=dev)
        velx = torch.zeros((), device=dev)
        succ = torch.zeros((), device=dev)
        for _ in range(n_steps):
            if who == "student":
                action = sac.predict(actor, student_view(
                    obs, self._noise({}, "noise", noise_gen)))
            else:
                action = sac.predict(actor, obs)
            state, obs, rew, done, info = self.env.step(
                state, action * self.act_bound + self.act_offset,
                autoreset=False)
            ret = ret + rew * alive
            steps = steps + alive
            velx = velx + cols.part_mean(info["velx"] * alive)
            succ = succ + cols.part_mean(info["success"] * alive)
            alive = alive * (1.0 - done.to(torch.float32))
        ret, steps, velx, succ = cols.reduce(torch.stack([
            cols.part_mean(ret), cols.part_mean(steps), velx, succ]))
        mean_steps = torch.clamp(steps, min=1.0)
        return ret, steps, velx / mean_steps, succ / mean_steps

    def train(self, total_steps: int = 200_000, distill_epochs: int = 10,
              final_epochs: int = 10, seed: int = 0,
              eval_every: int = 50_000) -> Tuple[BCState, dict]:
        """Collect/distill on the reference cadence: per 1024 new samples,
        ``distill_updates`` BC updates; then ``final_epochs`` full-buffer
        sweeps. Returns (student state, the last losses as floats)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        env_state, obs = self.reset(gen)
        bc_state = self.bc.init(gen)
        cap = max(total_steps, REF_BATCH)
        buf = replay.bc_create(cap, self.student_obs_dim, self.env.obs_dim,
                               device=self.device)
        # chunk ≈ TRAIN_PER_STEPS samples per phase (BCtrain.py:38)
        chunk = max(REF_BATCH // self.B, 1)
        steps, warmed = 0, False
        next_eval = eval_every
        while steps < total_steps:
            env_state, obs, (s_obs, e_obs) = self.collect(
                bc_state, env_state, obs, chunk, not warmed, gen)
            warmed = True
            replay.bc_add_batch(buf, s_obs, e_obs)
            steps += chunk * self.B
            losses = self.distill(
                bc_state, buf, distill_updates(steps, cap, distill_epochs),
                generator=gen)
            if steps >= next_eval:
                next_eval += eval_every
                ret, es, _, _ = self.evaluate(bc_state.actor, "student")
                self.logger.add_scalar("bc/eval_return", float(ret), steps)
                self.logger.add_scalar("bc/eval_steps", float(es), steps)
            self.logger.add_scalar("bc/actor_loss",
                                   float(losses["actor_loss"]), steps)
            self.logger.add_scalar("bc/critic_loss",
                                   float(losses["critic_loss"]), steps)
        # consolidated full-buffer sweeps (BCtrain.py:129-131)
        n_final = final_epochs * max(min(steps, cap) // REF_BATCH, 1)
        losses = self.distill(bc_state, buf, n_final, generator=gen)
        return bc_state, {k: float(v) for k, v in losses.items()}

    def ratio_report(self, bc_state: BCState, n_steps: int = 600) -> dict:
        """The reference headline: student/expert deterministic reward
        ratio (ref_ratio, BCtrain.py:183-186), same env batch."""
        s_ret, s_steps, s_velx, s_succ = [float(x) for x in self.evaluate(
            bc_state.actor, "student", n_steps)]
        e_ret, e_steps, e_velx, e_succ = [float(x) for x in self.evaluate(
            self.expert_state.actor, "expert", n_steps)]
        return {
            "student_return": round(s_ret, 2),
            "student_steps": round(s_steps, 1),
            "student_velx": round(s_velx, 3),
            "student_success": round(s_succ, 3),
            "expert_return": round(e_ret, 2),
            "expert_steps": round(e_steps, 1),
            "expert_velx": round(e_velx, 3),
            "expert_success": round(e_succ, 3),
            "ref_ratio": round(s_ret / max(e_ret, 1e-9), 4),
        }
