"""ETG-RL deterministic evaluation (PyTorch port).

``evaluate`` is the counterpart of the JAX package's
``ETGRLTrainer.evaluate`` (run_evaluate_episodes, train.py:182-211): the
deterministic policy tanh(actor(obs)) drives the batched env without
autoreset for ``n_steps`` control steps. Deployment runs the same loop.
The trainer class comes with the SAC learner.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paddlerobotics_torch.algos import sac
from paddlerobotics_torch.algos.networks import Actor
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

INFO_CHANNELS = ("torso", "up", "feet", "tau", "stand", "badfoot",
                 "footcontact", "velx", "success")


@torch.no_grad()
def evaluate(env: BatchedQuadrupedEnv, actor: Actor, etg_w: torch.Tensor,
             etg_b: torch.Tensor, n_steps: int,
             generator: torch.Generator | None = None,
             dr_scale: float | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Deterministic eval of the (3,H)/(3,) ETG readout shared by all envs.

    Returns (mean return, mean episode length, info-channel means summed
    over steps) as 0-d tensors on the env's device; envs stop counting
    once done (no autoreset)."""
    dev = env.device
    B = env.B
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
        infos = {k: infos[k] + torch.mean(info[k] * alive)
                 for k in INFO_CHANNELS}
        alive = alive * (1.0 - done.to(torch.float32))
    return torch.mean(ret), torch.mean(steps), infos
