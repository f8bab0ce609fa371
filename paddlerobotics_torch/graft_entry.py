"""The flagship step as one callable, and the mesh sweep (the port's
counterpart of the repo's ``__graft_entry__.py``).

- ``entry()``: the batched A1 env advanced one control step under the SAC
  policy: ``SAC.predict`` on the observation, then ``env.step`` with the
  action scaled by the env's bound (one physics kernel launch on the
  card);
- ``dryrun_multichip``: ``parallel/dryrun.dryrun_multichip``, the real
  trainer over every ``(env, model)`` mesh of the process group's world
  against the run without a mesh.
"""

from __future__ import annotations

import torch

from paddlerobotics_torch.algos.sac import SAC
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]


def entry(num_envs: int = 256, device=None):
    """Returns (fn, example_args): one policy + env control step.

    ``fn(env_state, actor, obs)`` → (next obs, reward, done, base position
    (3, B)), without grad. The example arguments are the env's reset state
    (generator seeded 1), a fresh actor (SAC's initialisers on a generator
    seeded 0) and the reset observation, on ``device`` (default the card;
    raises without one)."""
    cfg = QuadrupedConfig()
    env = BatchedQuadrupedEnv(cfg, num_envs=num_envs, device=device)
    dev = env.device
    sac = SAC(env.obs_dim, env.action_dim, cfg.sac, device=dev)
    sac_state = sac.init(torch.Generator(device=dev).manual_seed(0))
    state, obs = env.reset(torch.Generator(device=dev).manual_seed(1))
    act_bound = torch.as_tensor(env.act_bound, device=dev)

    @torch.no_grad()
    def fn(env_state, actor, obs):
        action = sac.predict(actor, obs)
        nstate, nobs, rew, done, _ = env.step(env_state, action * act_bound)
        return nobs, rew, done, nstate.robot.s.pos

    return fn, (state, sac_state.actor, obs)
