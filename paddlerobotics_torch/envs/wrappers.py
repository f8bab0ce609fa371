"""Batched env wrappers over ``BatchedQuadrupedEnv``, batch-first.

``ObsHistoryWrapper``: temporal observation history (PyTorch port of the
JAX package's ``envs/wrappers.py``), a rebuild of the reference
ObservationWrapper (deployment/envs/EnvWrapper.py:195-241;
SENSOR_MODE['RNN'] = {time_steps, time_interval, mode ∈ {None, stack, GRU}}
at train.py:273-277): keeps a rolling history of base observations and
emits either a flat stack (obs_dim × (time_steps+1)) or a (time_steps+1,
obs_dim) sequence for the GRU actor.

``ChunkRunner``: the loop of a policy that plans a chunk of actions, such
as ``algos/diffusion_policy.DiffusionPolicy`` (port-only).

``PlanRunner``: the loop of a planner that plans at every control step,
``algos/tdmpc2.TDMPC2Planner`` (port-only).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from paddlerobotics_torch.utils import profiler


class ObsHistoryState(NamedTuple):
    env_state: object
    history: torch.Tensor    # (B, time_steps*interval, obs_dim)


class ObsHistoryWrapper:
    def __init__(self, env, time_steps: int = 5, time_interval: int = 1,
                 mode: str = "stack"):
        if mode not in ("stack", "GRU"):
            raise ValueError(f"unknown history mode {mode!r}")
        self.env = env
        self.time_steps = time_steps
        self.time_interval = time_interval
        self.mode = mode
        self._idx = torch.arange(time_steps, device=env.device) \
            * time_interval

    @property
    def obs_dim(self):
        base = self.env.obs_dim
        if self.mode == "stack":
            return base * (self.time_steps + 1)
        return base

    # passthroughs so the wrapper is a drop-in env for the trainer
    @property
    def action_dim(self):
        return self.env.action_dim

    @property
    def act_bound(self):
        return self.env.act_bound

    @property
    def act_offset(self):
        return self.env.act_offset

    @property
    def cfg(self):
        return self.env.cfg

    @property
    def B(self):
        return self.env.B

    @property
    def cols(self):
        return self.env.cols

    @property
    def device(self):
        return self.env.device

    def default_etg(self):
        return self.env.default_etg()

    def _assemble(self, history, obs):
        """history (B,L,obs), obs (B,obs) → stacked / sequence output
        (EnvWrapper.py:209-219: every `time_interval`-th slot plus the
        current obs)."""
        seq = torch.cat([history[:, self._idx, :], obs[:, None, :]], dim=1)
        if self.mode == "stack":
            return seq.reshape(seq.shape[0], -1)
        return seq

    def reset(self, generator=None, etg_w=None, etg_b=None, **kw
              ) -> Tuple[ObsHistoryState, torch.Tensor]:
        env_state, obs = self.env.reset(generator, etg_w=etg_w, etg_b=etg_b,
                                        **kw)
        B = obs.shape[0]
        L = self.time_steps * self.time_interval
        history = obs.new_zeros((B, L, obs.shape[-1]))
        history[:, -1, :] = obs
        return ObsHistoryState(env_state, history), \
            self._assemble(history, obs)

    def step(self, state: ObsHistoryState, action, donef=False,
             autoreset: bool = True):
        env_state, obs, rew, done, info = self.env.step(
            state.env_state, action, donef, autoreset=autoreset)
        history = torch.cat([state.history[:, 1:, :], obs[:, None, :]],
                            dim=1)
        # a finished episode starts its history afresh
        fresh = torch.zeros_like(history)
        fresh[:, -1, :] = obs
        history = torch.where(done[:, None, None], fresh, history)
        out = self._assemble(history, obs)
        return ObsHistoryState(env_state, history), out, rew, done, info


class ChunkState(NamedTuple):
    env_state: object
    history: torch.Tensor    # (B, To, obs_dim), the newest last
    plan: torch.Tensor       # (B, Tp, action_dim), the last replan's
    held: torch.Tensor       # (B,) bool: reset since the last replan
    k: int                   # control steps since the last replan


def select_action(plan, held, k: int, n_obs_steps: int, bound, offset):
    """The env action of control step ``k`` of a chunk: plan step
    To−1+k in the env's range (× ``bound`` + ``offset``, as the SAC actor's
    tanh output is used); a held env gets ``offset``, the policy's zero
    residual (the ETG gait alone)."""
    a = plan[:, n_obs_steps - 1 + k] * bound + offset
    return torch.where(held[:, None], offset, a)


def next_history(history, obs, done):
    """The history after a step: shifted by the new observation; an env
    that reset starts again from its first observation, repeated
    (``MultiStepWrapper.stack_last_n_obs``)."""
    shifted = torch.cat([history[:, 1:], obs[:, None]], dim=1)
    fresh = obs[:, None].expand_as(history)
    return torch.where(done[:, None, None], fresh, shifted)


class ChunkRunner:
    """A chunked policy's loop over an env: every ``Ta`` control steps
    (the policy's ``cfg.n_action_steps``) all B envs replan together
    (``policy.predict_action(history, noise)``, the noise a fresh Gaussian
    (B, Tp, A) from ``noise_generator``), and each control step executes
    the plan's next action through ``env.step(state, a, autoreset=True)``.

    The history holds the last To observations (``cfg.n_obs_steps``),
    padded by repeating an episode's first one. An env that resets inside a
    chunk holds the zero residual until the next replan (the plan was made
    for the episode that ended), and its history restarts from its new
    first observation. The action keeps its shape and dtype whatever the
    mask, so the env step keeps one graph key.

    Spans: ``env.chunk`` twice a step, around the action's selection and
    around the hold and history update after ``env.step``. Counters:
    ``replans``, ``held_env_steps`` (env steps run on the held residual)
    and ``mid_chunk_resets`` (resets before a chunk's last step).
    """

    def __init__(self, env, policy, noise_generator: torch.Generator):
        cfg = policy.cfg
        self.env, self.policy = env, policy
        self.noise_generator = noise_generator
        self.To, self.Tp, self.Ta = (cfg.n_obs_steps, cfg.horizon,
                                     cfg.n_action_steps)
        dev = env.device
        self._bound = torch.as_tensor(env.act_bound, device=dev)
        self._offset = torch.as_tensor(env.act_offset, device=dev)

    def reset(self, generator=None) -> Tuple[ChunkState, torch.Tensor]:
        """``env.reset(generator)``; the history is the first observation
        repeated, and the first ``step`` replans."""
        env_state, obs = self.env.reset(generator)
        B = obs.shape[0]
        history = obs[:, None].repeat(1, self.To, 1)
        plan = obs.new_zeros((B, self.Tp, self.env.action_dim))
        held = torch.zeros(B, dtype=torch.bool, device=obs.device)
        return ChunkState(env_state, history, plan, held, 0), obs

    def step(self, state: ChunkState, donef: torch.Tensor | bool = False):
        """One control step (``donef`` as ``env.step`` takes it); returns
        (state, obs, reward, done, info), the env step's with the executed
        action as ``info["action"]``."""
        plan, held, k = state.plan, state.held, state.k
        if k == 0:
            noise = torch.randn(plan.shape, generator=self.noise_generator,
                                device=plan.device)
            plan = self.policy.predict_action(state.history, noise)
            held = torch.zeros_like(held)
            profiler.count("replans")
        with profiler.annotate("env.chunk"):
            a = select_action(plan, held, k, self.To, self._bound,
                              self._offset)
        env_state, obs, reward, done, info = self.env.step(
            state.env_state, a, donef, autoreset=True)
        with profiler.annotate("env.chunk"):
            history = next_history(state.history, obs, done)
            if profiler.spans_on:
                profiler.count("held_env_steps", held.sum())
                if k < self.Ta - 1:
                    profiler.count("mid_chunk_resets", done.sum())
            held = held | done
        info["action"] = a
        return (ChunkState(env_state, history, plan, held,
                           (k + 1) % self.Ta), obs, reward, done, info)


class PlanState(NamedTuple):
    env_state: object
    obs: torch.Tensor        # (B, obs_dim): what the next plan reads
    mean: torch.Tensor       # (B, H, action_dim): the last plan's mean
    t0: torch.Tensor         # (B,) bool: the next step is an episode's first


class PlanRunner:
    """A planner's loop over an env: every control step all B envs plan
    together (``planner.plan(obs, t0, mean, noise)``, the noise one
    ``planner.draw_noise`` from ``noise_generator``), and the planned
    action, in [-1, 1], runs through ``env.step(state, a · act_bound +
    act_offset, autoreset=True)``, the same call and graph key as the
    other policies' loops.

    The runner keeps each env's warm-start mean (the planner shifts it by
    one at the next plan) and its ``t0``: true from the reset and after an
    env's autoreset, so that its next plan starts cold, as the published
    agent's first step of an episode does.

    Span: ``env.plan`` around the reset mask's update after ``env.step``.
    Counter: ``planner_resets`` (envs whose next plan starts cold after an
    autoreset).
    """

    def __init__(self, env, planner, noise_generator: torch.Generator):
        self.env, self.planner = env, planner
        self.noise_generator = noise_generator
        dev = env.device
        self._bound = torch.as_tensor(env.act_bound, device=dev)
        self._offset = torch.as_tensor(env.act_offset, device=dev)

    def reset(self, generator=None) -> Tuple[PlanState, torch.Tensor]:
        """``env.reset(generator)``; every env's first plan starts cold."""
        env_state, obs = self.env.reset(generator)
        B = obs.shape[0]
        c = self.planner.cfg
        mean = obs.new_zeros((B, c.horizon, c.action_dim))
        t0 = torch.ones(B, dtype=torch.bool, device=obs.device)
        return PlanState(env_state, obs, mean, t0), obs

    def step(self, state: PlanState, donef: torch.Tensor | bool = False):
        """One control step (``donef`` as ``env.step`` takes it); returns
        (state, obs, reward, done, info), the env step's with the executed
        action as ``info["action"]``."""
        noise = self.planner.draw_noise(state.obs.shape[0],
                                        self.noise_generator)
        a, mean = self.planner.plan(state.obs, state.t0, state.mean, noise)
        action = a * self._bound + self._offset
        env_state, obs, reward, done, info = self.env.step(
            state.env_state, action, donef, autoreset=True)
        with profiler.annotate("env.plan"):
            t0 = done.clone()
            if profiler.spans_on:
                profiler.count("planner_resets", done.sum())
        info["action"] = action
        return PlanState(env_state, obs, mean, t0), obs, reward, done, info
