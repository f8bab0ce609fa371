"""Batched env wrappers: temporal observation history (PyTorch port of the
JAX package's ``envs/wrappers.py``).

Rebuild of the reference ObservationWrapper (deployment/envs/
EnvWrapper.py:195-241; SENSOR_MODE['RNN'] = {time_steps, time_interval,
mode ∈ {None, stack, GRU}} at train.py:273-277): keeps a rolling history
of base observations and emits either a flat stack (obs_dim ×
(time_steps+1)) or a (time_steps+1, obs_dim) sequence for the GRU actor.
Batch-first, over ``BatchedQuadrupedEnv``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


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
