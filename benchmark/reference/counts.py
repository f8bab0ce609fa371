"""The work counts the per-layer metrics divide by, and the card's peaks.

Every count is taken from the configuration's shapes and this folder's
frozen plain copy, never from the program, so a later change that fuses or
replaces a kernel does not move the yardstick.

Peaks: NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit: FP32
outside the tensor cores 67 TFLOP/s (a fused multiply-add counted as two
operations), TF32 495 TFLOP/s, HBM3 3.35 TB/s.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

# elementwise operations the plain physics issues (counted per output
# element), as the port's first roofline counted them
_ARITH = {"add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "sin", "cos",
          "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "floor",
          "abs", "reciprocal", "rsub", "where", "gt", "lt", "ge", "le",
          "bitwise_and", "bitwise_xor", "bitwise_or", "bitwise_right_shift"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in _ARITH and \
                isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def physics_ops_per_env(cfg) -> float:
    """Elementwise operations per env of one plain control step of the
    configuration's physics (``sbatch.control_step``), counted on the CPU
    at a batch of 8 with nominal dynamics."""
    from benchmark.reference import sbatch, terrain

    b = 8
    rb = sbatch.init_robot(b, 0.27, hist_len=2)
    p = sbatch.BDynParams.default(b)
    count = _Count()
    with count:
        sbatch.control_step(rb, rb.s.q.clone(), p, cfg.sim,
                            terrain.height_fn(cfg.task))
    return count.ops / b


def physics_bytes_per_env(cfg, ring_rows: int) -> int:
    """Bytes one control step must move per env: every input the step
    reads once (state, last and new action, the dynamics but the latency,
    which only the observation reads) and every output written once (state,
    torques, feet, contacts and the ``min(ring, substeps)`` snapshot rows
    of the observation ring)."""
    from benchmark.reference import sbatch

    rb = sbatch.init_robot(1, 0.27, hist_len=2)
    p = sbatch.BDynParams.default(1)
    s = rb.s
    state = sum(t.numel() for t in (s.pos, s.quat, s.w, s.v, s.q, s.qd))
    n_in = state + 2 * rb.last_action.numel() + sum(
        t.numel() for f, t in zip(p._fields, p) if f != "control_latency")
    rows = min(ring_rows, cfg.sim.action_repeat)
    n_out = (state + rb.tau.numel() + rb.contact.foot_pos.numel()
             + 2 * rb.contact.foot_contact.numel()
             + rb.contact.base_contact.numel() + rows * sbatch.OBS_ROW)
    return 4 * (n_in + n_out)


def physics_bound_s(cfg, B: int, ring_rows: int) -> float:
    """The least time one control step's physics could take on the card:
    the larger of its operations at the FP32 peak and its bytes at the HBM
    peak."""
    return max(physics_ops_per_env(cfg) * B / PEAK_FP32_FLOPS,
               physics_bytes_per_env(cfg, ring_rows) * B / PEAK_BYTES_PER_S)


def mlp_flops(b: int, dims) -> int:
    """Forward FLOPs of dense layers (in, out) at batch b (2·b·in·out)."""
    return sum(2 * b * i * o for i, o in dims)


def actor_layers(obs: int, act: int, hidden: int):
    return [(obs, hidden), (hidden, hidden), (hidden, act), (hidden, act)]


def critic_layers(obs: int, act: int, hidden: int):
    return [(obs + act, hidden), (hidden, hidden), (hidden, 1)] * 2


def sac_update_flops(b: int, obs: int, act: int, hidden: int) -> int:
    """Matrix FLOPs of one SAC update at batch b (``SAC.learn``): the
    target's actor sample and target critic, the critic's forward and its
    backward (weight gradients, and input gradients past the first
    layers), then the actor's sample, the critic on it and the backward
    through both to the actor's weights."""
    a_l, c_l = actor_layers(obs, act, hidden), critic_layers(obs, act, hidden)
    fa, fc = mlp_flops(b, a_l), mlp_flops(b, c_l)
    first_a = mlp_flops(b, a_l[:1])
    first_c = mlp_flops(b, c_l[:1]) + mlp_flops(b, c_l[3:4])
    critic_update = fa + fc + fc + fc + (fc - first_c)
    actor_update = fa + fc + fc + fa + (fa - first_a)
    return critic_update + actor_update
