"""Analytic terrain height fields for the ten task modes (PyTorch).

Port of the JAX package's ``sim/terrain.py``: every terrain is a closed-form
height function h(x, y) on tensors. ``height_fn`` returns a callable that
also carries the mode id and the float parameters, computed here on the
host in double precision exactly where the JAX version folds Python
floats, so the CUDA kernel (``ops/csrc/physics_step.cu``, ``terrain_h``)
evaluates the same function with the same constants.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.config import TaskConfig

TASK_MODES = (
    "ground", "gallop",
    "up_slope", "down_slope", "slopeslope",
    "up_stair", "down_stair", "stairstair",
    "obstacle", "balance_beam",
)
# Kernel ids (physics_step.cu TERRAIN_*); gallop runs on flat ground.
MODE_IDS = {"ground": 0, "gallop": 0, "up_slope": 1, "down_slope": 2,
            "slopeslope": 3, "up_stair": 4, "down_stair": 5,
            "stairstair": 6, "obstacle": 7, "balance_beam": 8}

_NUM_STEPS = 10      # steps in a staircase before plateau
_SLOPE_RUN = 3.0     # meters of slope before plateau

# Order of HeightFn.params (the kernel reads them by these indices).
PARAM_NAMES = ("x0", "step_height", "step_width", "slope",
               "x0_plus_run", "x1_stairstair", "beam_half_width",
               "x0_plus_beam_length")


def _hash01(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-random [0,1) per integer grid cell.

    int32 tensors wrap on overflow and shift right arithmetically, as the
    JAX int32 arrays do; only the low 23 bits reach the float."""
    h = ix * 374761393 + iy * 668265263
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    h = h & 0x7FFFFF
    return h.to(torch.float32) * (1.0 / float(0x800000))


class HeightFn:
    """h(x, y) for one task; shapes broadcast.

    ``mode_id`` and ``params`` (see PARAM_NAMES) are what the kernel
    wrapper passes on."""

    def __init__(self, task: TaskConfig):
        mode = task.task_mode
        if mode not in TASK_MODES:
            raise ValueError(
                f"unknown task_mode {mode!r}; choose from {TASK_MODES}")
        self.mode = mode
        self.mode_id = MODE_IDS[mode]
        x0 = task.terrain_start
        sh, sw, sl = task.step_height, task.step_width, task.slope
        self.params: Tuple[float, ...] = (
            x0, sh, sw, sl, x0 + _SLOPE_RUN, x0 + _NUM_STEPS * sw + 1.0,
            task.beam_width / 2, x0 + task.beam_length)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x0, sh, sw, sl, x0_run, x1, bw_half, x0_bl = self.params
        m = self.mode
        if m in ("ground", "gallop"):
            return torch.zeros_like(x)
        if m == "up_slope":
            return sl * torch.clamp(x - x0, 0.0, _SLOPE_RUN)
        if m == "down_slope":
            return -sl * torch.clamp(x - x0, 0.0, _SLOPE_RUN)
        if m == "slopeslope":
            # up then down (triangle profile)
            up = sl * torch.clamp(x - x0, 0.0, _SLOPE_RUN)
            down = sl * torch.clamp(x - x0_run, 0.0, _SLOPE_RUN)
            return up - down
        if m in ("up_stair", "down_stair"):
            n = torch.clamp(torch.floor((x - x0) / sw) + 1.0, 0.0,
                            float(_NUM_STEPS))
            return (sh if m == "up_stair" else -sh) * n
        if m == "stairstair":
            # staircase up then staircase down (1 m platform on top)
            n_up = torch.clamp(torch.floor((x - x0) / sw) + 1.0, 0.0,
                               float(_NUM_STEPS))
            n_dn = torch.clamp(torch.floor((x - x1) / sw) + 1.0, 0.0,
                               float(_NUM_STEPS))
            return sh * (n_up - n_dn)
        if m == "obstacle":
            # pseudo-random rectangular blocks on a 0.5 m grid
            gx = torch.floor((x - x0) / 0.5).to(torch.int32)
            gy = torch.floor(y / 0.5).to(torch.int32)
            r = _hash01(gx, gy)
            present = (r > 0.55) & (gx >= 0)
            hgt = sh * (0.5 + 0.5 * _hash01(gy + 7, gx + 13))
            return torch.where(present, hgt, torch.zeros_like(hgt))
        # balance_beam: a plank level with the approach over a drop that
        # keeps descending at 2:1 away from the beam
        over_gap = (x >= x0) & (x < x0_bl)
        off = torch.clamp(torch.abs(y) - bw_half, min=0.0)
        drop = -0.5 - 2.0 * off
        return torch.where(over_gap & (off > 0), drop, torch.zeros_like(drop))


def height_fn(task: TaskConfig) -> HeightFn:
    """Return h(x, y) for the configured task. Shapes broadcast."""
    return HeightFn(task)


def height_and_normal(h_fn, x: torch.Tensor, y: torch.Tensor,
                      eps: float = 0.01):
    """Height plus the finite-difference surface normal (unit, pointing up)
    of the per-env path's contacts (the JAX ``terrain.height_and_normal``)."""
    h = h_fn(x, y)
    dhdx = (h_fn(x + eps, y) - h_fn(x - eps, y)) / (2 * eps)
    dhdy = (h_fn(x, y + eps) - h_fn(x, y - eps)) / (2 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    return h, n
