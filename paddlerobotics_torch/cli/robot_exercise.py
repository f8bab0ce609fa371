"""Sim/robot exercise probe: drive the same action sequence through the
simulator (or, over ``--udp``, a robot bridge) and log every state channel
(port of the JAX package's ``cli/robot_exercise.py``, the rebuild of
deployment/a1_robot_exercise.py:30-91).

Put the robot on the rack, blend slowly to the init pose, run a sinusoidal
hip exercise, and dump ``<suffix>_obs_sin.npz`` with motor_angle /
motor_velocity / foot_contact / v / imu / rpy / action traces. The robot is
anything implementing the ``RobotIO`` protocol (``deploy/realtime``):
``SimRobotIO`` over the batched env (one physics launch per command on the
card), or ``deploy/udp_bridge.A1UdpClient`` (``--udp host:port``, or
``--udp emulator`` for a local ``A1EmulatorServer``). Runs on the card
unless ``--device cpu``.

    python -m paddlerobotics_torch.cli.robot_exercise --udp emulator
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from paddlerobotics_torch.deploy.udp_bridge import quat_to_euler
from paddlerobotics_torch.sim import a1_model as a1


class ExerciseRecorder:
    """Collects the channels a1_robot_exercise.py logs (lines 52-83)."""

    def __init__(self):
        self.rows = {k: [] for k in (
            "motor_angle", "motor_velocity", "foot_contact", "v", "imu",
            "rpy", "action")}

    def record(self, state: dict, action: np.ndarray):
        self.rows["motor_angle"].append(state["q"])
        self.rows["motor_velocity"].append(state["qd"])
        self.rows["foot_contact"].append(state["foot_contact"])
        self.rows["v"].append(state["v"])
        self.rows["imu"].append(state["drpy"])
        self.rows["rpy"].append(state["rpy"])
        self.rows["action"].append(np.asarray(action))

    def save(self, path: str):
        np.savez(path, **{k: np.asarray(v) for k, v in self.rows.items()})


def read_full_state(io) -> dict:
    """Full debug state through RobotIO: ``SimRobotIO`` exposes env 0 of the
    batched state (one read-back); other IOs return these keys from
    ``read_state``."""
    if not hasattr(io, "state"):
        return io.read_state()
    rb = io.state.robot
    s = rb.s
    host = torch.cat([s.q[:, 0], s.qd[:, 0],
                      rb.contact.foot_contact[:, 0].to(torch.float32),
                      s.v[:, 0], s.w[:, 0], s.quat[:, 0]]).cpu().numpy()
    return {"q": host[0:12], "qd": host[12:24], "foot_contact": host[24:28],
            "v": host[28:31], "drpy": host[31:34],
            "rpy": quat_to_euler(host[34:38])}


def run_exercise(io, steps: int = 1000, blend_steps: int = 300,
                 freq: float = 0.5, amplitude: float = 0.2
                 ) -> ExerciseRecorder:
    """Blend to the init pose, then the sinusoidal hip exercise (logged);
    the loop is not paced (the JAX function's ``dt`` is unused there)."""
    init = np.asarray(a1.INIT_MOTOR_ANGLES, np.float64)
    start = read_full_state(io)["q"].astype(np.float64)
    # blend over the first 2/3 of blend_steps, then hold (the reference
    # ramps over 200 of its 300 steps, a1_robot_exercise.py:42-50): the
    # ramp stays gradual for any blend_steps, a hardware-safety feature
    ramp = max(1, (2 * blend_steps) // 3)
    for t in range(blend_steps):
        blend = min(t / ramp, 1.0)
        io.apply_action((1 - blend) * start + blend * init)

    rec = ExerciseRecorder()
    for t in range(steps):
        angle_hip = init[1] + amplitude * np.sin(
            2 * np.pi * freq * 0.01 * t)
        action = init.copy()
        action[1::3] = angle_hip
        action[2::3] = -2.0 * angle_hip
        io.apply_action(action)
        rec.record(read_full_state(io), action)
    return rec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--suffix", type=str, default="exercise")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--freq", type=float, default=0.5)
    p.add_argument("--amplitude", type=float, default=0.2)
    p.add_argument("--udp", type=str, default="",
                   help="host:port of a UDP robot bridge (deploy/udp_bridge "
                        "protocol); 'emulator' starts a local sim-backed "
                        "emulator server")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from paddlerobotics_torch.core.config import QuadrupedConfig

    server = None
    if args.udp:
        from paddlerobotics_torch.deploy.udp_bridge import (A1EmulatorServer,
                                                            A1UdpClient)
        if args.udp == "emulator":
            server = A1EmulatorServer(device=args.device)
            addr = server.addr
        else:
            host, port = args.udp.rsplit(":", 1)
            addr = (host, int(port))
        io = A1UdpClient(addr, timeout=30.0, device=args.device)
    else:
        from paddlerobotics_torch.deploy.realtime import SimRobotIO
        from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

        cfg = QuadrupedConfig()
        # rack the robot, as the reference insists (a1_robot_exercise.py:32)
        cfg = dataclasses.replace(
            cfg, sim=dataclasses.replace(cfg.sim, on_rack=True),
            etg=dataclasses.replace(cfg.etg, step_y=0.0))
        io = SimRobotIO(BatchedQuadrupedEnv(cfg, 1, device=args.device))
    try:
        rec = run_exercise(io, steps=args.steps, freq=args.freq,
                           amplitude=args.amplitude)
    finally:
        if args.udp:
            io.close()
        if server is not None:
            server.close()
    out = f"{args.suffix}_obs_sin.npz"
    rec.save(out)
    q = np.asarray(rec.rows["motor_angle"])
    print(f"saved {out}: motor_angle {q.shape}, hip range "
          f"[{q[:, 1].min():.3f}, {q[:, 1].max():.3f}] rad")


if __name__ == "__main__":
    main()
