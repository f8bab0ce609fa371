"""Time the physics kernel on the card, by CUDA events and by device time.

At B=4096 in the default configuration (ground, ring L=2, no DR), from a
seeded start near the standing pose, it prints one JSON line: CUDA-event
ms per ``physics_step.control_step`` call (the wrapper's host work and
ring update included), and under ``torch.profiler`` the device ms per
launch of the kernel alone and per wrapper call, beside the card's name
and power limit. ``--root`` imports ``paddlerobotics_torch`` from another
checkout with the same wrapper interface, so that two versions are timed
on one card within one call (run them as A, B, B, A):

    python3 paddlerobotics_torch/ops/physics_time.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

KERNEL = "control_step_kernel"
B = 4096
REPS = 200
ATTEMPTS = 3


def device_ms(fn, reps: int) -> tuple[float, float, float]:
    """(device ms per kernel launch, kernel launches per call, device ms
    of all kernels per call) over ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(ATTEMPTS):       # a window may catch no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        hits = [e.time_range.elapsed_us() for e in evs if KERNEL in e.name]
        if hits:
            total = sum(e.time_range.elapsed_us() for e in evs)
            return (sum(hits) / len(hits) / 1e3, len(hits) / reps,
                    total / reps / 1e3)
    raise RuntimeError(f"torch.profiler saw no {KERNEL} in {ATTEMPTS} windows")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout to import paddlerobotics_torch from")
    args = ap.parse_args()
    # this file's directory would shadow top-level names; the checkout
    # takes its place
    sys.path[0] = str(pathlib.Path(args.root).resolve())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("physics_time: no CUDA device", file=sys.stderr)
        return 1
    from paddlerobotics_torch.core.config import SimConfig, TaskConfig
    from paddlerobotics_torch.ops import physics_step
    from paddlerobotics_torch.sim import sbatch, terrain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def nrm(*shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    rb = sbatch.init_robot(B, 0.27, hist_len=2, device=dev)
    quat = rb.s.quat + nrm(4, B, scale=0.02)
    s = sbatch.BQuadState(pos=(rb.s.pos + nrm(3, B, scale=0.01)).contiguous(),
                          quat=(quat / quat.norm(dim=0)).contiguous(),
                          w=nrm(3, B, scale=0.2), v=nrm(3, B, scale=0.1),
                          q=rb.s.q + nrm(12, B, scale=0.05),
                          qd=nrm(12, B, scale=0.5))
    rb = rb.replace(s=s, obs_hist=sbatch._obs_row(s)[None].repeat(2, 1, 1))
    p = sbatch.BDynParams.default(B, device=dev)
    sim = SimConfig()
    h_fn = terrain.height_fn(TaskConfig())
    act = rb.s.q.clone()
    kern = lambda: physics_step.control_step(rb, act, p, sim, h_fn)

    physics_step.build()
    for _ in range(20):
        kern()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(REPS):
        kern()
    ev[1].record()
    torch.cuda.synchronize()
    per_launch, caught, per_call = device_ms(kern, 20)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": args.root, "B": B,
        "event_ms_per_call": ev[0].elapsed_time(ev[1]) / REPS,
        "device_ms_per_launch": per_launch,
        "launches_caught_per_call": caught,
        "device_ms_per_call": per_call, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
