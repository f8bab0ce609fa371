"""Real-time control loop (PyTorch port of the JAX package's
``deploy/realtime.py``; rebuild of deployment/test.py + the
ControlLoopWrapper pacing, EnvWrapper.py:243-268).

The hardware interface is abstracted behind ``RobotIO`` so the same loop
drives the batched simulator (software in the loop; on the card each tick
is one physics-kernel launch at B=1) or a real robot bridge (the reference
uses a Unitree LCM bridge, a1_robot.py:38; any object with read_state /
apply_action works).
"""

from __future__ import annotations

import time
from typing import Callable, Protocol

import numpy as np
import torch

from paddlerobotics_torch.sim import a1_model as a1


class RobotIO(Protocol):
    def read_state(self) -> dict: ...
    def apply_action(self, joint_targets) -> None: ...


class SimRobotIO:
    """Drives the batched simulator through the RobotIO protocol, every env
    given the same targets (deployment/test.py:83-90 builds a DIRECT
    PyBullet). The deployment policy folds the gait into its targets
    (``policy_export``), so the env is reset with a zero ETG readout and
    given the targets minus the default pose; build the env with
    step_y=0 for an exact passthrough."""

    def __init__(self, env, generator: torch.Generator | None = None):
        self.env = env
        dev = env.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        H = env.cfg.etg.H
        self.state, self.obs = env.reset(
            generator, etg_w=torch.zeros((3, H, env.B), device=dev),
            etg_b=torch.zeros((3, env.B), device=dev))
        self._init = torch.as_tensor(a1.INIT_MOTOR_ANGLES, device=dev)

    def read_state(self) -> dict:
        return {"obs": self.obs[0]}

    def apply_action(self, joint_targets) -> None:
        # the residual in float64, rounded once, as the reference's numpy
        target = torch.as_tensor(joint_targets, device=self.env.device)
        act = (target.double() - self._init).float()[None, :].expand(
            self.env.B, 12)
        self.state, self.obs, _, _, _ = self.env.step(self.state, act,
                                                      autoreset=False)


def run_control_loop(policy: Callable, io: RobotIO, dt: float = 0.026,
                     max_time: float = 1.0, log: bool = True):
    """Paced loop: policy(obs, i) → targets → robot, sleeping the rest of
    ``dt`` (deployment/test.py:93-103). ``obs`` goes to the policy's device
    (``policy.device`` where it has one). Returns the obs and target logs as
    numpy arrays (saved as npz by the reference, test.py:105)."""
    obs_list, act_list = [], []
    dev = getattr(policy, "device", None)
    n = int(max_time / dt)
    for i in range(n):
        t0 = time.perf_counter()
        state = io.read_state()
        obs = torch.as_tensor(state["obs"], dtype=torch.float32, device=dev)
        target = policy(obs, i)
        io.apply_action(target)
        if log:
            obs_list.append(obs.cpu().numpy())
            act_list.append(target.cpu().numpy())
        elapsed = time.perf_counter() - t0
        if dt - elapsed >= 5e-4:
            time.sleep(dt - elapsed)
    return np.asarray(obs_list), np.asarray(act_list)
