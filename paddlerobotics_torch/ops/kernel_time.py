"""Time the port's six hand-written kernels on the card, each alone.

For each kernel and shape it prints one JSON line: the kernel's device ms
per launch under ``torch.profiler`` and its CUDA-event ms per wrapper call,
beside its plain version's ms, the library call's ms where there is one
(``F.scaled_dot_product_attention`` for attention, cuDNN's
``conv_transpose1d`` for ``upsample1d``, which is also that wrapper's plain
version), its bound from the card's peaks with what sets it, its launch
plan and its registers and spill bytes (``-Xptxas -v``). The shapes:

- ``control_step`` (``ops/csrc/physics_step.cu``) at B=4096 in the default
  configuration (ground, ring L=2, no DR) from a seeded start near the
  standing pose, with the wrapper's host µs per call and for
  ``launch_args`` alone; then at the deployment loop's B=1 and at dynamics
  ID's B=40 (each env its own draw, ring 40);
- ``flash_attention`` (``ops/csrc/attention.cu``) at one controller call
  (B=1, H=8, T=S=200, hd=64 under a window mask), with the wrapper's host
  cost; at 64 such windows; at ERNIE's layer 0 over a 317-row catalog
  padded to 64 tokens (12 heads of 64, the key-padding mask a stride-0
  view);
- ``track_match`` (``ops/csrc/track_match.cu``) at the tracker's T=32,
  D=20, on the inputs of the seventh update of a seeded 5-walker clip;
- ``upsample1d`` (``ops/csrc/upsample1d.cu``) at the Diffusion Policy
  U-Net's two shapes (C=512, L=4 and C=256, L=8) at B=4096;
- ``groupnorm_mish`` (``ops/csrc/groupnorm_mish.cu``) at the U-Net's five
  ``Conv1dBlock`` shapes (C, L) at B=4096, 8 groups, with each epilogue
  the U-Net runs there (FiLM, the residual with its 1×1 convolution's
  bias, none), each line with ``blocks_per_unet_call``, the number of the
  U-Net's 25 blocks it stands for; its plain version is PyTorch's chain
  the kernel replaced (the bias add, GroupNorm, Mish, the epilogue); then
  its row path (one group of length 1, LayerNorm) at the TD-MPC2
  planner's tails, 131,072 rows of 512 (256 envs × 512 samples): Mish,
  SimNorm, and the 5-head ensemble after its shared GEMM (head_div 1) and
  after its batched one (head_div 131,072), each with
  ``launches_per_iteration``, its plain version ``row_plain`` (the bias
  add, ``F.layer_norm``, the activation);
- ``etg_residual`` (``ops/csrc/etg_residual.cu``) at the rollout's B=4096,
  the deployment loop's B=1 and the ES envs' B=320 (H=20, the default
  constants, the fitted readout perturbed per env, step indices over ten
  gait periods), its plain version the env's PyTorch composition (~90
  kernels a call on the card), each line with the kernel's widest
  difference from it (``act_max_abs_diff``; ``v_a_equal``; ``mask_flips``,
  masks that differ). A checkout without the kernel prints no such line.

``--root`` imports ``paddlerobotics_torch`` from another checkout with the
same wrapper interfaces, so that two versions are timed on one card within
one call (run them as A, B, B, A)::

    python3 paddlerobotics_torch/ops/kernel_time.py [--root DIR]

The bound helpers (``count_ops_per_env``, ``attn_bound``,
``track_match_bound``, ``upsample_bound``, ``groupnorm_bound``,
``row_norm_bound``, ``etg_bound``) and the
inputs the kernels are timed on (``window_mask``, ``walker_clip``,
``dynid_dynamics``) are importable; the card's tests hold the kernels on
the same inputs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

# H100 SXM data sheet: HBM3 bandwidth, FP32 (non-tensor) and dense TF32
# tensor-core peaks.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# the FP32 rate when no operation is fused: the FMA peak counts a fused
# multiply-add as two operations, and the physics kernel is built without
# FMA contraction (bit equality with its plain version)
PEAK_FP32_NOFMA_OPS = PEAK_FP32_FLOPS / 2
B = 4096
ATTEMPTS = 3
LEAD = 5                                # calls that open a profiler session
WINDOW = "kernel_time.window"
HOST_CALLS = 1000                       # wrapper calls of the host cost
TRACK_HW = (360, 640)                   # the reference's view frames


# --- bounds ------------------------------------------------------------------

def _bound(n_bytes: float, ops: float, peak_ops: float) -> dict:
    b_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    b_ops = ops / peak_ops * 1e3
    return {"bytes": n_bytes, "bound_bytes_ms": b_bytes, "bound_ops_ms": b_ops,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def count_ops_per_env(sim, h_fn) -> float:
    """Elementwise arithmetic operations per env of one plain control step,
    counted on the CPU at a small batch (each op's output elements)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddlerobotics_torch.sim import sbatch

    arith = {"add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "sin", "cos",
             "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "floor",
             "abs", "reciprocal", "rsub", "where", "gt", "lt", "ge", "le",
             "bitwise_and", "bitwise_xor", "bitwise_or",
             "bitwise_right_shift"}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in arith and \
                    isinstance(out, torch.Tensor):
                Count.ops += out.numel()
            return out

    b = 8
    rb = sbatch.init_robot(b, 0.27, hist_len=2)
    p = sbatch.BDynParams.default(b)
    act = rb.s.q.clone()
    with Count():
        sbatch.control_step(rb, act, p, sim, h_fn)
    return Count.ops / b


def attn_bound(B: int, H: int, T: int, S: int, hd: int,
               mask_elems: int | None = None) -> dict:
    """Least time of one attention call on the card (ms): q, k, v, the mask
    and the output moved once each at the HBM rate; the two products,
    4·B·H·T·S·hd operations, at the fp32 CUDA-core peak (the figure of the
    first kernel, kept for continuity) and, as the kernel computes them, in
    three TF32 passes at the dense TF32 peak. The bound is the larger of
    the bytes and the tensor-core figure. ``mask_elems`` is the mask's
    stored size when it is a broadcast view (default B·T·S)."""
    flops = 4 * B * H * T * S * hd
    if mask_elems is None:
        mask_elems = B * T * S
    n_bytes = 4 * (2 * B * H * T * hd + 2 * B * H * S * hd + mask_elems)
    b_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    b_tc = 3 * flops / PEAK_TF32_FLOPS * 1e3
    return {"flops": flops, "bytes": n_bytes, "bound_bytes_ms": b_bytes,
            "bound_ops_fp32_ms": flops / PEAK_FP32_FLOPS * 1e3,
            "bound_ops_tc_ms": b_tc, "bound_ms": max(b_bytes, b_tc),
            "bound_by": "bytes" if b_bytes >= b_tc else "operations"}


def track_match_bound(T: int, D: int, scans: int, solves: int) -> dict:
    """Least time of one matching step on the card (ms): the two (T, D)
    cost matrices, status, age and the detection mask read once and the
    assignment and matched mask written once, at the HBM rate; and the
    plain version's arithmetic on these inputs at the FP32 peak: per
    Dijkstra scan 8 per column of the n = max(T, D) square (three adds, a
    compare, three selects, the argmin's compare), per solve the gating
    (a min and a select per entry) and the dual updates (5 per row)."""
    n = max(T, D)
    ops = scans * 8 * n + solves * (2 * n * n + 5 * n)
    return {"ops": ops, **_bound(4 * (2 * T * D + 2 * T) + D + 4 * T + D,
                                 ops, PEAK_FP32_FLOPS)}


def upsample_bound(B: int, C: int, L: int) -> dict:
    """Least time of one ``Upsample1d`` call (ms): 2·B·C²·(4L−2)
    operations (both phases; the zero taps at a sequence's ends, which the
    function never needs, left out) at the FP32 peak, against x, the weight
    and the bias read once and y written once at the HBM rate."""
    flops = 2 * B * C * C * (4 * L - 2)
    return {"flops": flops, **_bound(
        4 * (B * C * L + 4 * C * C + C + 2 * B * C * L), flops,
        PEAK_FP32_FLOPS)}


def groupnorm_bound(B: int, C: int, L: int, epilogue: str) -> dict:
    """Least time of one ``groupnorm_mish`` call (ms): the convolution's
    output read once and the block's output written once, FiLM's (B, 2C)
    or the residual's (B, C, L) read once, the per-channel vectors (the
    bias, GroupNorm's scale and shift, the residual's bias) once, at the
    HBM rate. Bytes only: a few dozen operations an element (Mish's three
    functions among them) leave it far below the FP32 line."""
    extra = {"none": 0, "film": 2 * B * C, "residual": B * C * L + C}
    return _bound(4 * (2 * B * C * L + 3 * C + extra[epilogue]), 0,
                  PEAK_FP32_FLOPS)


def row_norm_bound(R: int, C: int, heads: int) -> dict:
    """Least time of one ``row_norm`` call (ms): the GEMM's output read
    once and the layer's output written once, each head's bias, scale and
    shift once, at the HBM rate. Bytes only, as ``groupnorm_bound``."""
    return _bound(4 * (2 * R * C + 3 * heads * C), 0, PEAK_FP32_FLOPS)


def etg_bound(B: int, H: int) -> dict:
    """Least time of one ETG residual call (ms): the readout (3, H, B), its
    bias and the step index read once, the residual (12, B), the two masks
    (4, B) of bytes and V(t) (H, B) written once, at the HBM rate. Bytes
    only: H precise exponentials and a dozen other functions a (leg, env)
    leave it far below the FP32 line."""
    return _bound(4 * (3 * H * B + 3 * B + B) + 4 * (12 * B + H * B)
                  + 2 * 4 * B, 0, PEAK_FP32_FLOPS)


ETG_BATCHES = (B, 1, 320)               # rollout, deployment loop, ES envs


# (rows, C, act, heads, head_div, launches of that kind in one iteration of
# the published planner at 256 envs × 512 samples): the dynamics' and the
# reward's hidden layers over the horizon and the policy's, the dynamics'
# SimNorm, the Q ensemble's two layers
PLAN_ROWS = 256 * 512
PLAN_NORM_ROWS = ((PLAN_ROWS, 512, "mish", 1, 1, 14),
                  (PLAN_ROWS, 512, "simnorm", 1, 1, 3),
                  (5 * PLAN_ROWS, 512, "mish", 5, 1, 1),
                  (5 * PLAN_ROWS, 512, "mish", 5, PLAN_ROWS, 1))


# (C, L, epilogue, blocks of that kind in one call) of the published U-Net's
# 25 Conv1dBlocks: the down levels, the middle, the up levels, the head
UNET_NORM_BLOCKS = ((256, 16, "film", 2), (256, 16, "residual", 2),
                    (512, 8, "film", 2), (512, 8, "residual", 2),
                    (1024, 4, "film", 4), (1024, 4, "residual", 4),
                    (512, 4, "film", 2), (512, 4, "residual", 2),
                    (256, 8, "film", 2), (256, 8, "residual", 2),
                    (256, 16, "none", 1))


# --- inputs --------------------------------------------------------------------

def dynid_dynamics(B: int, dev, seed: int = 2):
    """B per-env dynamics from 48 uniform parameters in [-1, 1] each
    (gravity and 0–80 ms latency included), as dynamics ID injects them."""
    import torch

    from paddlerobotics_torch.envs import randomize

    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((randomize.NUM_DYNAMIC_PARAMS, B), generator=gen,
                   device=dev) * 2.0 - 1.0
    return randomize.param2dynamic(u)


def window_mask(B: int, rng, dev, past: int = 0, T: int = 200, K: int = 20):
    """The controller's mask over a window of frames of ``K`` tokens:
    block-causal over frame ids, merged with a padding mask whose frames
    keep their first 1..K slots (the scene sensor's layout, drawn from the
    numpy generator ``rng``); with a past-KV cache of ``past`` keys in
    front."""
    import numpy as np
    import torch

    from paddlerobotics_torch.hri.transformer import (frame_ids_to_attn_mask,
                                                      merge_padding_mask)

    fids = torch.arange(1, T // K + 1, device=dev).repeat_interleave(K)
    m = frame_ids_to_attn_mask(fids[None].expand(B, T))
    keep = rng.integers(1, K + 1, size=(B, (past + T) // K))
    slots = np.arange(K)[None, None] < keep[..., None]
    pad = torch.as_tensor(slots.reshape(B, past + T), dtype=torch.float32,
                          device=dev)
    if past:
        m = torch.cat([m.new_ones(B, T, past), m], dim=-1)
    return merge_padding_mask(m, pad)


def walker_clip(dev, frames: int, n: int, D: int, seed: int):
    """A synthetic clip: n rectangles walking at constant velocity (stopped
    at the edges) over a noisy 360×640 background (uint8 RGB (frames, 360,
    640, 3) on the card), each with a fixed seeded 128-d appearance; per
    frame its boxes with 1.5 px of noise and the features with 5% noise, as
    the tracker's (D,4), (D,128), (D,) inputs."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    H, W = TRACK_HW
    base = rng.standard_normal((n, 128))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    size = np.stack([rng.uniform(40, 60, n), rng.uniform(100, 160, n)], 1)
    start = np.stack([30 + (W - 100) / n * np.arange(n),
                      rng.uniform(20, H - 180, n)], 1)
    # vertical walks, a slow drift across: neighbours never meet
    vel = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-1, 1, n)], 1)
    colors = rng.integers(0, 256, (n, 3))
    g = torch.Generator(dev)
    g.manual_seed(seed)
    clip = torch.randint(60, 120, (frames, H, W, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    boxes = np.zeros((frames, D, 4), np.float32)
    feats = np.zeros((frames, D, 128), np.float32)
    valid = np.zeros((frames, D), bool)
    for f in range(frames):
        for k in range(n):
            lo = np.clip(start[k] + vel[k] * f, 0, [W - size[k, 0],
                                                    H - size[k, 1]])
            x0, y0 = int(lo[0]), int(lo[1])
            x1, y1 = int(lo[0] + size[k, 0]), int(lo[1] + size[k, 1])
            clip[f, y0:y1, x0:x1] = torch.as_tensor(colors[k],
                                                    dtype=torch.uint8)
            boxes[f, k] = [x0, y0, x1, y1] + rng.normal(0, 1.5, 4)
            feats[f, k] = base[k] + 0.05 * rng.standard_normal(128)
            valid[f, k] = True
    t = lambda a: torch.as_tensor(a, device=dev)
    return clip, t(boxes), t(feats), t(valid)


# --- timing --------------------------------------------------------------------

def device_ms(fn, reps: int, match: str | None = None
              ) -> tuple[float, float, float]:
    """(device ms per launch of the kernels whose name holds ``match``,
    their launches per call, device ms of all kernels per call) over
    ``reps`` calls of ``fn``; with no ``match``, of every kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for _ in range(ATTEMPTS):       # a window may catch no device event
        # a session may lose device events, most of all its first ones:
        # LEAD calls open it, and only the kernels that start inside the
        # timed range after them count
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD):
                fn()
            torch.cuda.synchronize()
            with record_function(WINDOW):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        evs = prof.events()
        t0 = min(e.time_range.start for e in evs if e.name == WINDOW)
        # ranges such as ``Optimizer.step`` are recorded on the device too,
        # over the kernels they hold: not kernels themselves
        evs = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.time_range.start >= t0]
        hits = [e.time_range.elapsed_us() for e in evs
                if match is None or match in e.name]
        if hits:
            total = sum(e.time_range.elapsed_us() for e in evs)
            return (sum(hits) / len(hits) / 1e3, len(hits) / reps,
                    total / reps / 1e3)
    raise RuntimeError(f"torch.profiler saw no kernel {match or ''} in "
                       f"{ATTEMPTS} windows")


def timed(fn, reps: int, warm: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA-event timed."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_cost(fn, args_fn) -> dict:
    """Host µs per call of ``fn`` over HOST_CALLS calls with no synchronize
    in between (checks, output allocation, ctypes call, launch) beside the
    CUDA-event ms per call over the same calls, and of ``args_fn`` (the
    wrapper's checks and allocation) alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    host_us = 1e6 * (time.perf_counter() - t) / HOST_CALLS
    ev[1].record()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        args_fn()
    return {"host_us_per_call": host_us,
            "launch_args_us_per_call": 1e6 * (time.perf_counter() - t)
            / HOST_CALLS,
            "host_event_ms_per_call": ev[0].elapsed_time(ev[1]) / HOST_CALLS}


def registers(info: dict) -> dict:
    """Each instance's ptxas report, keyed by its template arguments (e.g.
    '64,4,1,64'), with the largest register count and the spill bytes."""
    ptxas = {",".join(re.findall(r"Li(\d+)E", k)) or k: v
             for k, v in info["ptxas"].items()}
    return {"max_registers": max(v.get("registers", 0)
                                 for v in ptxas.values()),
            "spill_bytes": sum(v.get("spill_stores", 0)
                               + v.get("spill_loads", 0)
                               for v in ptxas.values()),
            "ptxas": ptxas}


def kernel_line(kern, plain, library, reps: int, match: str,
                plain_reps: int | None = None) -> dict:
    """The figures common to every line: the kernel by events over ``reps``
    calls (the smaller of two runs, before and after the others) and by
    device time per launch; the plain version (over ``plain_reps`` calls,
    default ``reps``) and the library call by events and by device time
    per call."""
    ms = [timed(kern, reps, reps // 10)]
    out = {}
    for name, fn, n in (("plain", plain, plain_reps or reps),
                        ("library", library, reps)):
        if fn is None:
            out[f"{name}_ms"] = out[f"{name}_device_ms"] = None
            continue
        out[f"{name}_ms"] = min(timed(fn, n, 1), timed(fn, n, 0))
        out[f"{name}_device_ms"] = device_ms(fn, min(n, 20))[2]
    ms.append(timed(kern, reps, 0))
    # a window can still lose some of the kernel's launches (on the H100
    # up to a third of those of a 0.3 ms kernel): the mean per launch is
    # over the ones it kept, and a sum per call would be short
    per_launch, caught, _ = device_ms(kern, 20, match)
    return {"event_ms_per_call": min(ms), "device_ms_per_launch": per_launch,
            "launches_caught_per_call": caught, **out}


def physics_lines(dev, lines: list) -> None:
    import numpy as np
    import torch

    from paddlerobotics_torch.core.config import SimConfig, TaskConfig
    from paddlerobotics_torch.ops import physics_step
    from paddlerobotics_torch.sim import sbatch, terrain

    rng = np.random.default_rng(0)
    sim = SimConfig()
    h_fn = terrain.height_fn(TaskConfig())

    def nrm(*shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    def start(Bx, L):
        rb = sbatch.init_robot(Bx, 0.27, hist_len=L, device=dev)
        quat = rb.s.quat + nrm(4, Bx, scale=0.02)
        s = sbatch.BQuadState(
            pos=(rb.s.pos + nrm(3, Bx, scale=0.01)).contiguous(),
            quat=(quat / quat.norm(dim=0)).contiguous(),
            w=nrm(3, Bx, scale=0.2), v=nrm(3, Bx, scale=0.1),
            q=rb.s.q + nrm(12, Bx, scale=0.05), qd=nrm(12, Bx, scale=0.5))
        return rb.replace(s=s, obs_hist=sbatch._obs_row(s)[None].repeat(
            L, 1, 1))

    physics_step.build()
    regs = registers(physics_step.build_info)
    rb = start(B, 2)
    p = sbatch.BDynParams.default(B, device=dev)
    act = rb.s.q.clone()
    kern = lambda: physics_step.control_step(rb, act, p, sim, h_fn)
    plain = lambda: sbatch.control_step(rb, act, p, sim, h_fn)
    # the plain version takes ~0.3 s a call at B=4096
    line = kernel_line(kern, plain, None, 200, "control_step_kernel",
                       plain_reps=3)
    # every input read once and every output written once, and the plain
    # version's elementwise operations on these inputs at the FP32 peak (FMA
    # rate: the bound); beside it the same operations unfused, as this
    # kernel issues them
    args = lambda: physics_step.launch_args(rb, act, p, sim, h_fn, False,
                                            None, None)
    _, _, _, outs, keep = args()
    n_in = sum(t.numel() for t in keep[:len(keep) - len(outs)]
               if t is not None) - p.control_latency.numel()
    ops = count_ops_per_env(sim, h_fn) * B
    bd = _bound(4 * (n_in + sum(t.numel() for t in outs)), ops,
                PEAK_FP32_FLOPS)
    lines.append({"kernel": "control_step", "B": B, **line, "ops": ops, **bd,
                  "bound_ops_nofma_ms": ops / PEAK_FP32_NOFMA_OPS * 1e3,
                  "plan": physics_step.launch_plan(B),
                  "max_registers": regs["max_registers"],
                  "spill_bytes": regs["spill_bytes"],
                  **host_cost(kern, args)})
    # the deployment loop's one env and dynamics ID's population of 40,
    # each env its own dynamics and the ring 40 long
    for name, Bx, L in (("single_env", 1, 2), ("dynid_pop", 40, 40)):
        rbx = start(Bx, L)
        px = (dynid_dynamics(Bx, dev) if L > 2 else
              sbatch.BDynParams.default(Bx, device=dev))
        ax = rbx.s.q.clone()
        fx = lambda: physics_step.control_step(rbx, ax, px, sim, h_fn)
        per_launch, caught, _ = device_ms(fx, 20, "control_step_kernel")
        lines.append({"kernel": "control_step", "case": name, "B": Bx, "L": L,
                      "event_ms_per_call": timed(fx, 200, 20),
                      "device_ms_per_launch": per_launch,
                      "launches_caught_per_call": caught,
                      "plan": physics_step.launch_plan(Bx)})


def attention_lines(dev, lines: list) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddlerobotics_torch.ops import attention

    def sdpa(q, k, v, m):
        """The library yardstick: additive float mask, then fully masked
        rows zeroed (SDPA averages them uniformly)."""
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=(-1e10 * (1.0 - m))[:, None])
        return out * (m.amax(-1) > 0).to(q.dtype)[:, None, :, None]

    attention.build()
    regs = registers(attention.build_info)["ptxas"]
    rng = np.random.default_rng(1)
    gen = torch.Generator(dev).manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    # ERNIE's layer 0: 317 catalog rows of 1 to 40 words ([CLS], the words
    # and [SEP]) padded to 64 tokens, the key-padding row broadcast over the
    # queries
    tokens = torch.as_tensor(rng.integers(1, 41, 317) + 2, device=dev)
    key_pad = (torch.arange(64, device=dev) < tokens[:, None]).to(
        torch.float32)[:, None, :].expand(317, 64, 64)
    shapes = [("serving", (1, 8, 200, 200, 64), window_mask(1, rng, dev),
               None),
              ("windows_64", (64, 8, 200, 200, 64),
               window_mask(64, rng, dev), None),
              ("ernie_pad", (317, 12, 64, 64, 64), key_pad, 317 * 64)]
    for name, (Bx, H, T, S, hd), m, mask_elems in shapes:
        q, k, v = randn(Bx, H, T, hd), randn(Bx, H, S, hd), randn(Bx, H, S,
                                                                 hd)
        kern = lambda: attention.flash_attention(q, k, v, m)
        line = kernel_line(kern, lambda: attention.reference_attention(
            q, k, v, m), lambda: sdpa(q, k, v, m), 100, "attn_kernel")
        plan = attention.launch_plan(Bx, H, T, hd)
        inst = ",".join(str(plan[f]) for f in (
            "instance_hd", "query_tiles_per_block", "key_partitions",
            "keys_per_partition"))
        line = {"kernel": "flash_attention", "case": name, "B": Bx, "H": H,
                "T": T, "S": S, "hd": hd, **line,
                **attn_bound(Bx, H, T, S, hd, mask_elems), "plan": plan,
                "ptxas": regs.get(inst)}
        if name == "serving":
            line.update(host_cost(kern, lambda: attention.launch_args(
                q, k, v, m)))
        lines.append(line)


def track_match_line(dev, lines: list) -> None:
    import torch

    from paddlerobotics_torch.hri import tracker as trk
    from paddlerobotics_torch.ops import lap

    lap.build()
    _, boxes, feats, valid = walker_clip(dev, 7, 5, 20, 9)
    st = trk.init_tracker(dev)
    for f in range(6):
        st, _ = trk.tracker_update(trk.tracker_predict(st), boxes[f],
                                   feats[f], valid[f])
    # the seventh update's inputs, its matching run by the plain version
    captured, kernel_wrapper = [], lap.track_match
    lap.track_match = lambda *a: captured.append(a[:5]) or tuple(
        t.to(dev) for t in lap.track_match_plain(*[x.cpu() for x in a[:5]],
                                                 *a[5:8]))
    try:
        trk.tracker_update(trk.tracker_predict(st), boxes[6], feats[6],
                           valid[6])
    finally:
        lap.track_match = kernel_wrapper
    args = captured[0]
    work = torch.zeros(2, dtype=torch.int32, device=dev)
    lap.track_match(*args, work=work)
    scans, solves = (int(x) for x in work.cpu())
    host_args = [x.cpu() for x in args]
    # the plain version reads the device once a scan: ~0.3 s a call
    line = kernel_line(lambda: lap.track_match(*args),
                       lambda: lap.track_match_plain(*args), None, 200,
                       "track_match", plain_reps=3)
    t = time.perf_counter()
    for _ in range(10):
        lap.track_match_plain(*host_args)
    T, D = args[0].shape
    lines.append({"kernel": "track_match", "T": T, "D": D, "scans": scans,
                  "solves": solves, **line,
                  "plain_cpu_ms": 1e3 * (time.perf_counter() - t) / 10,
                  **track_match_bound(T, D, scans, solves),
                  **registers(lap.build_info)})


def upsample_lines(dev, lines: list) -> None:
    import math

    import torch
    import torch.nn.functional as F

    from paddlerobotics_torch.ops import upsample1d as up

    up.build()
    regs = registers(up.build_info)
    g = torch.Generator(device=dev).manual_seed(0)
    for C, L in ((512, 4), (256, 8)):
        x = torch.randn(B, C, L, generator=g, device=dev)
        w = torch.randn(C, C, 4, generator=g, device=dev) / math.sqrt(4 * C)
        b = 0.1 * torch.randn(C, generator=g, device=dev)
        cudnn = lambda: F.conv_transpose1d(x, w, b, stride=2, padding=1)
        line = kernel_line(lambda: up.upsample1d(x, w, b), cudnn, cudnn, 50,
                           "upsample1d_kernel")
        lines.append({"kernel": "upsample1d", "B": B, "C": C, "L": L, **line,
                      **upsample_bound(B, C, L),
                      "plan": up.launch_plan(B, C, L),
                      "max_registers": regs["max_registers"],
                      "spill_bytes": regs["spill_bytes"]})


def groupnorm_lines(dev, lines: list) -> None:
    import torch

    from paddlerobotics_torch.ops import groupnorm_mish as gn

    gn.build()
    regs = registers(gn.build_info)
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    for C, L, epilogue, n in UNET_NORM_BLOCKS:
        h = randn(B, C, L)
        vecs = dict(bias=0.1 * randn(C), gamma=1 + 0.1 * randn(C),
                    beta=0.1 * randn(C), groups=8, eps=1e-5)
        extra = ({"film": randn(B, 2 * C)} if epilogue == "film" else
                 {"res": randn(B, C, L), "res_bias": 0.1 * randn(C)}
                 if epilogue == "residual" else {})
        line = kernel_line(lambda: gn.groupnorm_mish(h, **vecs, **extra),
                           lambda: gn.plain(h, **vecs, **extra), None, 50,
                           "groupnorm_mish_kernel")
        lines.append({"kernel": "groupnorm_mish", "B": B, "C": C, "L": L,
                      "groups": 8, "epilogue": epilogue,
                      "blocks_per_unet_call": n, **line,
                      **groupnorm_bound(B, C, L, epilogue),
                      "plan": gn.launch_plan(B, C, L, 8),
                      "max_registers": regs["max_registers"],
                      "spill_bytes": regs["spill_bytes"]})


def row_norm_lines(dev, lines: list) -> None:
    import torch

    from paddlerobotics_torch.ops import groupnorm_mish as gn

    gn.build()
    regs = registers(gn.build_info)
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    for R, C, act, heads, head_div, n in PLAN_NORM_ROWS:
        h = randn(R, C)
        shape = (C,) if heads == 1 else (heads, C)
        vecs = dict(bias=0.1 * randn(*shape), gamma=1 + 0.1 * randn(*shape),
                    beta=0.1 * randn(*shape), eps=1e-5, act=act,
                    head_div=head_div)
        line = kernel_line(lambda: gn.row_norm(h, **vecs),
                           lambda: gn.row_plain(h, **vecs), None, 50,
                           "row_norm_kernel")
        lines.append({"kernel": "row_norm", "rows": R, "C": C, "act": act,
                      "heads": heads, "head_div": head_div,
                      "launches_per_iteration": n, **line,
                      **row_norm_bound(R, C, heads),
                      "plan": gn.row_launch_plan(R, C),
                      "max_registers": regs["max_registers"],
                      "spill_bytes": regs["spill_bytes"]})


def etg_lines(dev, lines: list) -> None:
    import torch

    try:
        from paddlerobotics_torch.ops import etg_residual as er
    except ImportError:                 # a checkout from before the kernel
        return
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

    er.build()
    regs = registers(er.build_info)
    env = BatchedQuadrupedEnv(QuadrupedConfig(), 1, device=dev)
    k, H = env._etg, env._w0.shape[1]
    g = torch.Generator(device=dev).manual_seed(0)
    for Bx in ETG_BATCHES:
        w = env._w0[..., None] + 0.02 * torch.randn(
            (3, H, Bx), generator=g, device=dev)
        b = env._b0[:, None] + 0.01 * torch.randn((3, Bx), generator=g,
                                                  device=dev)
        steps = round(10 * k.etg.T / k.etg.dt)
        idx = torch.randint(0, steps, (Bx,), generator=g, device=dev,
                            dtype=torch.int32)
        kern = lambda: er.etg_residual(w, b, idx, k)
        plain = lambda: er.plain(w, b, idx, k)
        line = kernel_line(kern, plain, None, 200, "etg_residual_kernel")
        got, want = kern(), plain()
        lines.append({
            "kernel": "etg_residual", "B": Bx, "H": H, **line,
            **etg_bound(Bx, H), "plan": er.launch_plan(Bx, H),
            "act_max_abs_diff": float((got[0] - want[0]).abs().max()),
            "v_a_equal": bool(torch.equal(got[3], want[3])),
            "mask_flips": int((got[1] != want[1]).sum()
                              + (got[2] != want[2]).sum()),
            "max_registers": regs["max_registers"],
            "spill_bytes": regs["spill_bytes"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout to import paddlerobotics_torch from")
    args = ap.parse_args()
    # this file's directory would shadow top-level names; the checkout
    # takes its place
    sys.path[0] = str(pathlib.Path(args.root).resolve())

    import torch

    if not torch.cuda.is_available():
        print("kernel_time: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    for timer in (physics_lines, attention_lines, track_match_line,
                  upsample_lines, groupnorm_lines, row_norm_lines,
                  etg_lines):
        lines: list = []
        timer(dev, lines)
        for line in lines:
            print(json.dumps({"root": args.root, **line, "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
