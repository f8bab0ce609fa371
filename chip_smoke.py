"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the three hand-written kernels and the native serving runtime from
the checkout (in parallel) and holds each kernel against its plain PyTorch
version on the card. Drives the two paths
of the port through their entry points, each with the launch counts set
to 0 just before it and read just after:

- physics: the batched A1 env and the deterministic-policy rollout
  ``train.etg_rl.evaluate`` at B=4096 (one physics launch per step);
- the bench command and the profiler: ``cli.env_bench``'s timed rollout at
  B=4096 in both regimes (no DR, and DR with the 40-row ring) in process
  and ``python -m paddlerobotics_torch.cli.env_bench --regime both`` as a
  subprocess; one step of ``graft_entry.entry()`` at B=256 against the
  plain physics (one launch); ``utils.profiler``'s NaN checks on a clean
  B=4096 env step (bit-equal with them off) and on faults planted inside
  the physics and attention kernels and in a backward pass, each raised
  with the checks on and silent with them off; ``trace`` and
  ``annotate`` around 3 env steps;
- training: ``ETGRLTrainer.train`` at B=4096, K=4 and the default widths
  (2×256 SAC, batch 256, 1M-row replay, SimpleGA popsize 40 on 320 ES
  envs), depth cut, through a cold chunk, warm chunks, an eval window with
  its checkpoint and an ES phase (one physics launch per control step of
  each); a warm chunk, and an ES population rollout on the 320 ES envs,
  through the kernel against the same through the plain physics;
  ``cli.train_bench``'s two schedules;
- multi-GPU training on the one card: ``ETGRLTrainer(mesh=)`` over a 1×1
  ``DeviceMesh`` of one NCCL rank at the training configuration (the env
  axis's gathers and reductions, the gradient all-reduce and the
  checkpoint's gather all on NCCL), one physics launch per control step,
  the trained actor against the same ``train()`` without a mesh;
- the rest of the ETG-RL stack through its entry points: ETG pretraining
  (``cli.pretrain_etg``, 40 candidates on 4,080 envs), the task matrix's
  train → checkpoint → restore → eval (``cli.eval_matrix.run_task``,
  B=4096, K=4), gait export (``cli.export_gait``), the deployment loop
  (``deploy.realtime`` at B=1 with the exported policy and its
  ``torch.export`` form), behaviour cloning (``cli.bc_train``, B=256) and
  dynamics identification (``cli.dynamics_id``, 40 candidates, each env
  its own dynamics), one physics launch per control step of each; each
  path's rollout also through the plain physics, bit-equal;
- HRI serving: ``ProactiveGreetingService.process_frame`` with YOLOv4 at
  416² and the 317-action attention controller at its default widths (6
  attention launches per decided frame), then ``STEADY_FRAMES`` decided
  frames once the window is full, then ``OfflineEvaluator`` at 64
  windows; both against the same path on the plain attention;
- HRI training at the CLI's full width (the 317-action controller, batch
  16, lr 1e-4, l2 0.1): ``AttentionTrainer.train_step`` on
  ``generate_windows_device`` windows (no attention launch: training runs
  the plain attention), ``eval_step`` on 256 held-out numpy windows
  (6 launches), the trained weights through the kernel against the plain
  attention, a checkpoint resume, the five-variant ablation fleet
  (``cli.parallel_train_attn``), and checkpoint → ``cli.export_hri_model``
  → ``hri.export.load_bundle`` → the service with the YOLOv4 sensor (6
  launches per decided frame);
- the HRI tracking and transport stack: the YOLOv3 sensor at 416² serving
  the 317-action controller, a cfg-built Darknet sensor with its
  ``.weights`` written and read back, the re-ID encoder on 20 crops, the
  matching kernel against its plain version on 216 seeded steps, the
  tracker and ``cli.collect_data.track_frames`` on a 100-frame 360×640 clip
  (one ``track_match`` launch per frame) through the kernel and through the
  plain matching, and ``cli.serve_grpc``'s transport-free handlers on 20
  uint8 BGR ``VideoRequest`` messages and one 10-frame ``EvalRequest``
  (6 attention launches per decided frame), against the service on the
  same frames letterboxed by ``hri/utils``;
- the native C++ serving runtime (``runtime_cpp/``, built with g++ beside
  the kernels): ``hri.native_pipeline.NativeEvalServer`` with the port's
  YOLOv4 + 317-action callbacks on 10-frame requests (6 attention launches
  per request) against the same windows through the controller in
  process, the ``stream_sync`` and ``stream_pipelined`` arms of
  ``cli.serving_bench`` (6 launches per decided frame), and
  ``NativeClipEvalServer`` with R(2+1)D-18 on 8 × 3 × 224² clips against
  a direct model call on the clip C++ preprocessed; every native handle's
  ``check()`` raises what a callback raised;
- the HRI data tools: the full-width ERNIE utterance encoder (~100 M
  parameters, seeded) over the 317-utterance catalog padded to 64 tokens
  (12 attention launches per encode, the kernel at its key-padding masks
  against its plain version, in the wide plan at the catalog's batch and in
  the split plan at the shortest rows, where key partitions hold no
  unmasked key), ``cli.collect_act_emb`` with ERNIE and BoW
  into a bundle through ``cli.export_hri_model --wae``, ``WindowSampler`` →
  ``PrefetchLoader`` with the YOLOv4 ``WindowTokenizer`` → ``AttentionTrainer``
  steps at the CLI's width (a failing sample raised from the loader), the
  salutation and discrete heads against the CPU; ``make_env`` vmapped at
  B=64 for 5 control steps against ``BatchedQuadrupedEnv`` through the
  physics kernel (one launch per step) and against itself on the CPU;
- the A1 UDP bridge: ``deploy.udp_bridge.A1EmulatorServer`` +
  ``A1UdpClient`` + ``cli.robot_exercise.run_exercise`` over 300 commands
  (one physics launch per non-zero command, at B=1), the first 20 again
  through the plain physics, state packets bit-equal; MobileNetV2 and
  ResNet at 224² on the card against the CPU; the re-ID encoder through a
  frozen graph (``tf_graph``, ``reid.import_tf_consts``), 0.0 apart.

Times each kernel by CUDA events and by its device time under
``torch.profiler``, beside its bounds, its launch plan, its plain version
and, for attention, ``F.scaled_dot_product_attention`` as the library
yardstick; and each wrapper's host cost per call. Imports nothing of JAX.

    python3 chip_smoke.py

Exits non-zero on any failure and when no CUDA device is present. The
last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches, error and times:
``ms``, ``plain_ms`` and ``library_ms`` by CUDA events per call;
``device_ms``, ``plain_device_ms`` and ``library_device_ms`` the same
calls' device time under ``torch.profiler`` (the kernel's per launch).
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B = 4096
EVAL_STEPS = 200
# H100 SXM data sheet: HBM3 bandwidth, FP32 (non-tensor) and dense TF32
# tensor-core peaks.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# the FP32 rate when no operation is fused: the FMA peak counts a fused
# multiply-add as two operations, and the physics kernel is built without
# FMA contraction (bit equality with its plain version)
PEAK_FP32_NOFMA_OPS = PEAK_FP32_FLOPS / 2
TAIL_B = 4093                           # a last block with 3 lanes past B
# Kernel vs plain: after one control step every env agrees to TOL; after
# three, contact onsets (the damping term d·vn·[phi > 0] jumps at phi = 0)
# may let a last-bit difference grow in an env that is just touching down,
# so at most MAX_DRIFT_FRAC of the envs may exceed TOL.
TOL = 1e-4
MAX_DRIFT_FRAC = 1e-3
# attention kernel vs plain: float32 sums in another order (online softmax
# over key tiles against one softmax over all keys; products in three TF32
# passes, float32-accurate)
ATTN_ATOL, ATTN_RTOL = 2e-5, 1e-4
# serving through the kernel vs through the plain attention, 6 blocks deep
SERVE_TOL = 1e-4
SIZE = 416                              # YOLOv4 input, the serving resolution
FRAMES = 12                             # 9 fill the window, 3 are decided
STEADY_FRAMES = 50                      # decided frames of the throughput run
N_WINDOWS = 64
HOST_CALLS = 1000                       # wrapper calls of [*_host]
# the training path: depth cut, widths kept (QuadrupedConfig's defaults)
TRAIN_K = 4                             # updates per control step
TRAIN_CHUNK = 10                        # control steps per chunk
TRAIN_EPISODE = 100                     # eval and ES episode length
TRAIN_ES_GENS = 1                       # ES generations per ES phase
VS_PLAIN_STEPS = 5
# es_eval steps, kernel vs plain (each plain step costs ~0.4 s of host
# dispatch; the deployment loop's 100 plain ticks need the room)
ES_VS_PLAIN_STEPS = 10
# es_eval's fitness is a segment sum by index_add_, whose float atomics
# add an ES candidate's envs in any order: kernel and plain runs may differ
# by that rounding alone (the replay rows it writes are compared exactly)
ES_FIT_RTOL = 1e-5
# kernel vs plain physics after VS_PLAIN_STEPS warm steps: the kernel is
# bit-equal to its plain version, so the weights may differ only by the
# learner's own run-to-run rounding
TRAIN_PARAM_TOL = 1e-4
# [mesh_train]: the trained actor on a one-rank NCCL mesh against the run
# without a mesh, from the same seeds. On one rank every collective is a
# copy and the learner's share of the batch is all of it, so the two runs
# compute the same floats (0.0 read on the card); the bound is the learner's
# run-to-run rounding that [train_vs_plain] allows
MESH_ACTOR_TOL = TRAIN_PARAM_TOL
BENCH_ITERS = 2                         # timed chunks per bench schedule
PART_REPS = 20                          # calls of a chunk's part, timed
# the rest of the ETG-RL stack's entry points: widths kept, depth cut
PRETRAIN_ENVS = 4080                    # 102 envs per candidate of 40
PRETRAIN_GENS, PRETRAIN_STEPS = 2, 50   # defaults 100 x 400
PRETRAIN_VS_PLAIN_STEPS = 10
MATRIX_CHUNK = 50                       # run_task's chunk_steps
MATRIX_EVAL = 600                       # the reference's eval episode
MATRIX_RTOL = 1e-5                      # restored eval vs the trained one
GAIT_STEPS = 600
DEPLOY_TICKS = 100
DEPLOY_DT = 0.026                       # the reference's control period
BC_ENVS, BC_STEPS, BC_EVAL = 256, 4096, 100
BC_COLLECT = 1024 // BC_ENVS            # control steps of a collect phase
DYNID_POP, DYNID_T, DYNID_EPOCHS = 40, 100, 3
DYNID_VS_PLAIN_T = 10
# HRI controller training at the CLI's full width (AttnCtrlConfig(
# num_actions=317): D=512, 6 blocks, 8 heads, ffn 2048, 10 × 20 tokens),
# batch 16, lr 1e-4, l2 0.1; depth cut (cli/train_attention's 10 epochs of
# data → HRI_TRAIN_STEPS steps)
HRI_BATCH, HRI_LR, HRI_L2 = 16, 1e-4, 0.1
HRI_TRAIN_STEPS = 200
HRI_WARMUP_STEPS = 3                    # on a throwaway state, then profiled
HRI_LOSS_WINDOW = 20                    # steps averaged for first / last loss
HRI_HELDOUT = 256                       # numpy windows, one eval_step call
HRI_RESUME_STEPS = 10                   # 10 + save/restore + 10 vs 20
# resumed vs uninterrupted weights: equal unless cuBLAS rounds a call
# differently, and then an entry whose decayed gradient is ~0 may take one
# Adam step (±lr) the other way
HRI_RESUME_TOL = 2 * HRI_LR
HRI_FLEET_BATCHES = 2                   # --synthetic 2 --epochs 1
HRI_BUNDLE_FRAMES = 20                  # decided frames through the bundle
# the HRI tracking and transport stack: the YOLOv3 sensor at 416² and the
# 317-action controller (default widths), MarsSmall128 on 128×64 crops,
# MAX_TRACKS = 32 tracks against the detector's 20 detections
MATCH_CASES = 216                       # seeded matching steps, 6 kinds
# the matching's duals are float32: where two assignments' costs differ by
# an ulp it may take either (tests/test_torch_tracking.py)
COST_RTOL = 1e-6
REID_TOL = 1e-4                         # the encoder on the card vs the CPU
TRACK_FRAMES = 100
# track_frames through the plain matching (on the host, ~0.1 s per frame):
# the first frames of the clip, whose logs the kernel's run must repeat
TRACK_PLAIN_FRAMES = 30
TRACK_HW = (360, 640)                   # the reference's view frames
GRPC_FRAMES = 20                        # VideoRequests, 11 of them decided
GRPC_EVAL_FRAMES = 10                   # one EvalRequest, its last decided
NATIVE_EVAL_FRAMES = 10                 # frames of one native EvalRequest
NATIVE_EVAL_REQUESTS = 5
NATIVE_TOL = 1e-6                       # native eval vs the controller here
NATIVE_STREAM_FRAMES = 30               # timed frames of each stream arm
CLIP_REQUESTS = 5                       # R(2+1)D clips through C++
CLIP_TOL = 1e-5                         # clip scores vs a direct model call
UDP_BLEND = 100                         # run_exercise: blend commands
UDP_STEPS = 200                         # then the hip sinusoid
UDP_VS_PLAIN = 20                       # commands again, plain physics
BACKBONE_RTOL = 1e-4                    # card vs CPU, of the output's scale
ERNIE_ROWS = 317                        # the serving action catalog
ERNIE_LEN = 64                          # tokens per utterance, padded
ERNIE_TOL = 1e-4                        # kernel vs plain, of each output's scale
HRI_DATA_STEPS = 3                      # trainer steps on loader batches
PER_ENV_B = 64
PER_ENV_STEPS = 5
# the per-env env, card vs CPU: rtol and atol (the observation divides
# angles by 0.1, as in the CPU parity tests)
PER_ENV_CPU_TOL = 1e-4
# a Darknet cfg at 416² with every section type the importer reads: strided
# and grouped convolutions, both max pools, a shortcut, an upsample, routes
# with groups and two sources, two [yolo] heads (13² and 52²) with their
# own scale_x_y; the 512-channel 13² map feeds the tokens
DARKNET_CFG = """
[net]
width=416
height=416
channels=3

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=mish

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
batch_normalize=1
filters=256
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=5
stride=1

[convolutional]
batch_normalize=1
filters=512
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=0
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=6,7,8
anchors=12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401
classes=80
scale_x_y=1.05

[route]
layers=-4

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,-9

[convolutional]
batch_normalize=0
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401
classes=80
scale_x_y=1.2
"""
ROOT = pathlib.Path(__file__).resolve().parent


T_START = time.perf_counter()


def log(phase: str, **kw):
    """One line per phase; ``t`` is the seconds since the script started."""
    kw["t"] = round(time.perf_counter() - T_START, 1)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def es_batch(ecfg) -> int:
    """The ES envs' batch, as ``ETGRLTrainer`` sizes it: es_num_envs
    rounded down to a multiple of the popsize."""
    return max(ecfg.popsize, ecfg.es_num_envs // ecfg.popsize * ecfg.popsize)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def instance(kernel_name: str) -> str:
    """A kernel's template arguments from its mangled name, e.g. '64,4,1,64'."""
    return ",".join(re.findall(r"Li(\d+)E", kernel_name)) or kernel_name


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


def timed(fn, reps, warm):
    """Mean ms per call over ``reps`` calls, CUDA-event timed."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a_, b_ = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    a_.record()
    for _ in range(reps):
        fn()
    b_.record()
    torch.cuda.synchronize()
    return a_.elapsed_time(b_) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from paddlerobotics_torch.core.config import QuadrupedConfig, SimConfig, TaskConfig
    from paddlerobotics_torch.envs import randomize
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.etg import fit
    from paddlerobotics_torch.algos.networks import Actor
    from paddlerobotics_torch.cli import env_bench
    from paddlerobotics_torch.ops import attention, lap, physics_step
    from paddlerobotics_torch.ops.build import build_native_runtime
    from paddlerobotics_torch.sim import sbatch, terrain
    from paddlerobotics_torch.train import etg_rl
    from paddlerobotics_torch.utils import profiler

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("device", card=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), allow_tf32=False)

    # --- build: one nvcc per source, started together --------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        native = ex.submit(build_native_runtime)
        for f in [ex.submit(physics_step.build), ex.submit(attention.build),
                  ex.submit(lap.build)]:
            f.result()
        lib, native_info = native.result()
    for name, info in (("physics_step", physics_step.build_info),
                       ("attention", attention.build_info),
                       ("track_match", lap.build_info)):
        regs = {instance(k): v for k, v in info["ptxas"].items()}
        log("build", kernel=name, seconds=round(info["seconds"], 1),
            ptxas=json.dumps(regs, sort_keys=True))
        if not info["ptxas"]:
            raise RuntimeError(f"no -Xptxas -v report for {name}")
    log("native_build", seconds=round(native_info["seconds"], 1),
        compiler=repr(native_info["compiler"]), path=native_info["path"])
    log("build", wall_seconds=round(time.perf_counter() - t0, 1))

    # --- kernel against plain ------------------------------------------------
    rng = np.random.default_rng(0)

    def nrm(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    def start(h_fn, L, spread, B=B):
        rb = sbatch.init_robot(B, 0.27, hist_len=L, device=dev)
        pos = rb.s.pos.clone()
        if spread:
            pos[0] = torch.as_tensor(rng.uniform(-0.5, 3.0, B),
                                     dtype=torch.float32, device=dev)
            pos[1] = torch.as_tensor(rng.uniform(-0.4, 0.4, B),
                                     dtype=torch.float32, device=dev)
            pos[2] = pos[2] + h_fn(pos[0], pos[1])
        pos = pos + nrm(3, B, scale=0.01)
        quat = rb.s.quat + nrm(4, B, scale=0.02)
        quat = quat / quat.norm(dim=0)
        s = sbatch.BQuadState(pos=pos.contiguous(), quat=quat.contiguous(),
                              w=nrm(3, B, scale=0.2), v=nrm(3, B, scale=0.1),
                              q=rb.s.q + nrm(12, B, scale=0.05),
                              qd=nrm(12, B, scale=0.5))
        hist = sbatch._obs_row(s)[None].repeat(L, 1, 1)
        return rb.replace(s=s, obs_hist=hist)

    def env_err(a, b):
        """Per-env max |kernel − plain| over the state and the ring."""
        e = torch.zeros_like(a.s.q[0])
        for f in ("pos", "quat", "w", "v", "q", "qd"):
            e = torch.maximum(e, (getattr(a.s, f) - getattr(b.s, f)).abs().amax(0))
        d = (a.obs_hist - b.obs_hist).abs().amax(dim=(0, 1))
        return torch.maximum(e, d)

    n = SimConfig().action_repeat
    cases = [
        ("ground", {}, "ground", 2, {}),
        ("dr_long_ring", {}, "ground", 40, {"dr": True}),
        ("torque", {}, "ground", 2, {"torque": True}),
        ("hybrid", {}, "ground", 2, {"hybrid": True}),
        ("pd_latency", {"pd_latency": 1.5 * SimConfig().substep_dt},
         "ground", 3, {}),
        ("on_rack", {"on_rack": True}, "ground", 2, {}),
        ("up_stair", {}, "up_stair", 2, {}),
        ("obstacle", {}, "obstacle", 2, {}),
        ("balance_beam", {}, "balance_beam", 2, {}),
        # lanes past B in the last block, through every barrier
        ("tail", {}, "ground", 40, {"dr": True, "B": TAIL_B}),
        # the ES population rollout's batch (10 blocks), nominal dynamics
        ("es_envs", {}, "ground", 2, {"B": es_batch(QuadrupedConfig().es)}),
        # the deployment loop: one env, 31 idle lanes in its one block
        ("single_env", {}, "ground", 2, {"B": 1}),
        # dynamics ID's population: each env its own draw of all 48
        # parameters, the ring of obs_latency_taps = latency_buffer_len
        # (32, rounded up to a multiple of action_repeat)
        ("dynid_pop", {}, "ground", 40, {"B": 40, "dynid": True}),
    ]
    worst, failed = 0.0, []
    for name, simkw, mode, L, kw in cases:
        cfg = SimConfig(**simkw)
        h_fn = terrain.height_fn(TaskConfig(task_mode=mode, terrain_start=0.0))
        Bc = kw.get("B", B)
        rb0 = start(h_fn, L, spread=mode != "ground", B=Bc)
        p = sbatch.BDynParams.default(Bc, device=dev)
        if kw.get("dr"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            p = randomize.sample_dynamics(Bc, gen, device=dev)
        if kw.get("dynid"):
            p = dynid_dyn(Bc, dev)
        torque = kw.get("torque", False)
        qd_ref = tau_ff = None
        if kw.get("hybrid"):
            qd_ref, tau_ff = nrm(12, Bc, scale=0.3), nrm(12, Bc, scale=1.5)
        rk, rp = rb0, rb0
        errs, tau_err, con_mis = [], 0.0, 0
        for _ in range(3):
            act = (nrm(12, Bc, scale=5.0) if torque else
                   (rb0.s.q + nrm(12, Bc, scale=0.1)).contiguous())
            rk = physics_step.control_step(rk, act, p, cfg, h_fn, torque,
                                           qd_ref=qd_ref, tau_ff=tau_ff)
            rp = sbatch.control_step(rp, act, p, cfg, h_fn, torque,
                                     qd_ref=qd_ref, tau_ff=tau_ff)
            e = env_err(rk, rp)
            errs.append(e)
            tau_err = max(tau_err, (rk.tau - rp.tau).abs().max().item())
            con_mis += int((rk.contact.foot_contact != rp.contact.foot_contact).sum()
                           + (rk.contact.knee_contact != rp.contact.knee_contact).sum()
                           + (rk.contact.base_contact != rp.contact.base_contact).sum())
        torch.cuda.synchronize()
        e1 = errs[0].max().item()
        frac3 = (errs[2] > TOL).float().mean().item()
        finite = all(torch.isfinite(getattr(rk.s, f)).all().item()
                     for f in ("pos", "quat", "w", "v", "q", "qd"))
        ok = finite and e1 <= TOL and frac3 <= MAX_DRIFT_FRAC
        worst = max(worst, e1)
        log("kernel_vs_plain", case=name, B=Bc, L=L, S=min(L, n),
            max_abs_err_step1=e1, max_abs_err_step3=errs[2].max().item(),
            frac_envs_over_tol_step3=frac3, tau_max_abs_err=tau_err,
            contact_flag_mismatches=con_mis, finite=finite,
            result="pass" if ok else "FAIL")
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"kernel disagrees with plain in {failed}")

    # --- the slice: deterministic-policy rollout and env stepping ------------
    cfg = QuadrupedConfig()
    env = BatchedQuadrupedEnv(cfg, B)                 # runs on cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    actor = Actor(env.obs_dim, env.action_dim, cfg.sac.hidden_dim,
                  device=dev, generator=gen)
    w0, b0 = fit.opt_with_points(cfg.etg, device=dev)
    finite = []
    step = env.step

    def checked_step(*a, **k):
        out = step(*a, **k)
        finite.append(torch.isfinite(out[1]).all())
        return out

    env.step = checked_step
    etg_rl.evaluate(env, actor, w0, b0, 2)           # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    finite.clear()
    physics_step.control_step.launches = 0
    t0 = time.perf_counter()
    ret, length, infos = etg_rl.evaluate(env, actor, w0, b0, EVAL_STEPS,
                                         generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = physics_step.control_step.launches
    all_finite = bool(torch.stack(finite).all().item()) and len(finite) == EVAL_STEPS
    log("evaluate", B=B, steps=EVAL_STEPS, seconds=round(dt, 3),
        env_steps_per_s=round(B * EVAL_STEPS / dt, 1),
        mean_return=ret.item(), mean_length=length.item(),
        velx=infos["velx"].item() / EVAL_STEPS, kernel_launches=launches,
        obs_finite=all_finite)
    if launches != EVAL_STEPS:
        raise RuntimeError(f"{launches} kernel launches for {EVAL_STEPS} steps")
    if not all_finite or not np.isfinite(ret.item()):
        raise RuntimeError("non-finite observation or return")
    env.step = step

    # the same rollout through the plain version on the card: a reference
    # on a small input (16 steps, see ES_VS_PLAIN_STEPS).
    # The kernel is bit-equal to the plain version above, so 1e-3 of the
    # return leaves room for rounding only.
    ref_steps, Bs = 16, 512
    env_s = BatchedQuadrupedEnv(cfg, Bs)
    r_k = etg_rl.evaluate(env_s, actor, w0, b0, ref_steps)
    with plain_physics():
        r_p = etg_rl.evaluate(env_s, actor, w0, b0, ref_steps)
    d_ret = abs(r_k[0].item() - r_p[0].item())
    d_len = abs(r_k[1].item() - r_p[1].item())
    log("evaluate_vs_plain", B=Bs, steps=ref_steps, return_kernel=r_k[0].item(),
        return_plain=r_p[0].item(), abs_diff_return=d_ret,
        abs_diff_length=d_len)
    if d_ret > 1e-3 * max(1.0, abs(r_p[0].item())) or d_len > 0.5:
        raise RuntimeError("kernel rollout disagrees with the plain rollout")

    # autoreset rollout with zero actions, as bench.py does: the bench
    # command's own function (cli/env_bench), 100 warm-up steps, then 4×100
    nodr, bench_launches, _ = launched(lambda: env_bench.bench_env(
        "no_dr", B, device=dev))
    state, obs = nodr["final"][:2]
    zeros = torch.zeros((B, 12), device=dev)
    n_bench = nodr["steps"] * nodr["reps"]
    log("env_step_bench", a1_env_steps_per_sec_per_chip_4096envs=round(
        nodr["env_steps_per_s"], 1),
        host_ms_per_step=round(nodr["seconds"] / n_bench * 1e3, 4),
        event_ms_per_step=round(nodr["event_ms"] / n_bench, 4),
        ring_len=nodr["ring_len"], kernel_launches=bench_launches,
        card=repr(card), obs_finite=bool(torch.isfinite(obs).all().item()))
    if bench_launches != n_bench + nodr["steps"]:
        raise RuntimeError(f"{bench_launches} physics launches for "
                           f"{n_bench + nodr['steps']} control steps")
    # the same under DR: per-env dynamics, the long substep ring
    dr, dr_launches, _ = launched(lambda: env_bench.bench_env(
        "dr_long_ring", B, device=dev))
    dr_over_nodr = dr["env_steps_per_s"] / nodr["env_steps_per_s"]
    log("env_bench_dr", B=B, env_steps_per_s=round(dr["env_steps_per_s"], 1),
        host_ms_per_step=round(dr["seconds"] / n_bench * 1e3, 4),
        event_ms_per_step=round(dr["event_ms"] / n_bench, 4),
        ring_len=dr["ring_len"], kernel_launches=dr_launches,
        dr_over_nodr=round(dr_over_nodr, 4),
        obs_finite=bool(torch.isfinite(dr["final"][1]).all().item()),
        card=repr(card))
    if dr_launches != n_bench + dr["steps"] or dr["ring_len"] != 40 or \
            not torch.isfinite(dr["final"][1]).all():
        raise RuntimeError("the DR long-ring bench: wrong launches, ring or "
                           "non-finite observation")

    # where an env step's time goes on the card (torch.profiler)
    holder = [state]

    def one_step():
        holder[0] = env.step(holder[0], zeros)[0]

    prof = profiler.device_breakdown(one_step, reps=5)
    log("env_step_profile", **{k: (json.dumps(v) if k == "top" else
                                   round(v, 4))
                               for k, v in prof.items()})

    # --- kernel time beside its bounds ------------------------------------------
    sim = SimConfig()
    h_fn = terrain.height_fn(TaskConfig())
    rb = start(h_fn, 2, spread=False)
    p = sbatch.BDynParams.default(B, device=dev)
    act = rb.s.q.clone()

    kern = lambda: physics_step.control_step(rb, act, p, sim, h_fn)
    plain = lambda: sbatch.control_step(rb, act, p, sim, h_fn)
    ms = [timed(kern, 200, 20), timed(plain, 3, 1), timed(plain, 3, 0),
          timed(kern, 200, 0)]
    kernel_ms, plain_ms = min(ms[0], ms[3]), min(ms[1], ms[2])
    # device time per launch of the kernel alone (the wrapper's ring update
    # is left out), over the launches the profiler caught
    prof = profiler.device_breakdown(kern, reps=20, match="control_step_kernel")
    kernel_dev = (prof["match_ms_per_call"]
                  / max(prof["match_launches_per_call"], 1e-9))
    plain_dev = profiler.device_breakdown(plain, reps=2)["device_ms_per_call"]

    # bound: every input read once and every output written once, and the
    # plain version's elementwise operations on these inputs at the FP32
    # peak (FMA rate: the bound); beside it the same operations unfused,
    # as this kernel issues them
    ptrs, floats, ints, outs, keep = physics_step.launch_args(
        rb, act, p, sim, h_fn, False, None, None)
    n_in = sum(t.numel() for t in keep[:len(keep) - len(outs)]
               if t is not None) - p.control_latency.numel()
    n_out = sum(t.numel() for t in outs)
    bytes_moved = 4 * (n_in + n_out)
    ops = count_ops_per_env(sim, h_fn) * B
    bound_bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bound_ops_nofma_ms = ops / PEAK_FP32_NOFMA_OPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    ptxas = {instance(k): v
             for k, v in physics_step.build_info["ptxas"].items()}
    log("kernel_time", B=B, kernel_ms=round(kernel_ms, 5),
        kernel_device_ms_per_launch=round(kernel_dev, 5),
        launches_caught_per_call=prof["match_launches_per_call"],
        wrapper_device_ms_per_call=round(prof["device_ms_per_call"], 5),
        plain_ms=round(plain_ms, 3), plain_device_ms=round(plain_dev, 4),
        bytes=bytes_moved, ops=ops,
        bound_bytes_ms=round(bound_bytes_ms, 5),
        bound_ops_ms=round(bound_ops_ms, 5),
        bound_ops_nofma_ms=round(bound_ops_nofma_ms, 5),
        bound_ms=round(bound_ms, 5),
        bound_share_events=round(bound_ms / kernel_ms, 4),
        bound_share_device=round(bound_ms / kernel_dev, 4),
        nofma_share_device=round(bound_ops_nofma_ms / kernel_dev, 4),
        plan=json.dumps(physics_step.launch_plan(B)),
        max_registers=max(v.get("registers", 0) for v in ptxas.values()),
        spill_bytes=sum(v.get("spill_stores", 0) + v.get("spill_loads", 0)
                        for v in ptxas.values()),
        library_ms=None, card=repr(card))

    # the kernel by events at the deployment loop's B=1 and at dynamics ID's
    # B=40 (per-env dynamics, ring 40), beside the B=4096 figure above
    small_ms, small_dev = {}, {}
    for name, Bx, L in (("single_env", 1, 2), ("dynid_pop", 40, 40)):
        rbx = start(h_fn, L, spread=False, B=Bx)
        px = (dynid_dyn(Bx, dev) if L > 2 else
              sbatch.BDynParams.default(Bx, device=dev))
        ax = rbx.s.q.clone()
        fx = lambda: physics_step.control_step(rbx, ax, px, sim, h_fn)
        small_ms[name] = timed(fx, 200, 20)
        px_prof = profiler.device_breakdown(fx, reps=20,
                                            match="control_step_kernel")
        small_dev[name] = (px_prof["match_ms_per_call"]
                           / max(px_prof["match_launches_per_call"], 1e-9))
    log("kernel_time_small", **{f"{k}_ms": round(v, 5)
                                for k, v in small_ms.items()},
        **{f"{k}_device_ms": round(v, 5) for k, v in small_dev.items()},
        B_4096_ms=round(kernel_ms, 5), B_4096_device_ms=round(kernel_dev, 5),
        card=repr(card))

    # --- the physics wrapper's host cost ----------------------------------------
    # HOST_CALLS calls with no synchronize in between: host µs per call
    # (checks, output allocation, ctypes call, launch, ring update) beside
    # the CUDA-event ms per call over the same calls, and launch_args alone
    kern()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        kern()
    host_us = 1e6 * (time.perf_counter() - t) / HOST_CALLS
    ev[1].record()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        physics_step.launch_args(rb, act, p, sim, h_fn, False, None, None)
    args_us = 1e6 * (time.perf_counter() - t) / HOST_CALLS
    log("physics_host", B=B, calls=HOST_CALLS,
        host_us_per_call=round(host_us, 3),
        launch_args_us_per_call=round(args_us, 3),
        event_ms_per_call=round(ev[0].elapsed_time(ev[1]) / HOST_CALLS, 5),
        card=repr(card))

    entry_launches = bench_entry_phases(dev, card, env,
                                        nodr["env_steps_per_s"])
    train_launches = train_phases(dev, card)
    mesh_launches = mesh_train_phase(dev, card)
    stack_launches = stack_phases(dev, card)

    kernels = [{
        "name": "control_step",
        "route": "cuda",
        "source": "paddlerobotics_torch/ops/csrc/physics_step.cu",
        "replaces": "paddlerobotics_tpu/ops/pallas/physics_step.py:135",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
        "device_ms": kernel_dev,
        "plain_device_ms": plain_dev,
        "library_device_ms": None,
        "env_step_bench_launches": bench_launches,
        "env_bench_dr_launches": dr_launches,
        **entry_launches,
        "train_launches": train_launches,
        "mesh_train_launches": mesh_launches,
        **stack_launches,
        "single_env_ms": small_ms["single_env"],
        "dynid_pop_ms": small_ms["dynid_pop"],
        "single_env_device_ms": small_dev["single_env"],
        "dynid_pop_device_ms": small_dev["dynid_pop"],
    }]
    attn_entry, scene = hri_phases(dev, card)
    attn_entry.update(hri_train_phases(dev, card, scene))
    data_entry = data_tools_phases(dev, card, scene)
    attn_entry["max_abs_err"] = max(attn_entry["max_abs_err"],
                                    data_entry.pop("ernie_pad_max_abs_err"))
    attn_entry.update(data_entry)
    del scene
    kernels[0]["per_env_vs_batched_launches"] = per_env_phases(dev, card)
    track_entry, track_launches = hri_track_phases(dev, card)
    attn_entry.update(track_launches)
    attn_entry.update(native_phases(dev, card, lib))
    kernels[0]["udp_bridge_launches"] = robot_io_phases(dev, card)
    kernels += [attn_entry, track_entry]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def train_config():
    """``QuadrupedConfig()`` with depth alone cut: warm-up one chunk, the
    eval window after the second chunk, the ES phase after the third.
    Returns (cfg, what was cut)."""
    import dataclasses

    from paddlerobotics_torch.core.config import QuadrupedConfig

    base = QuadrupedConfig()
    chunk_env = TRAIN_CHUNK * B
    cfg = dataclasses.replace(
        base,
        sac=dataclasses.replace(base.sac, warmup_steps=chunk_env),
        es=dataclasses.replace(base.es, es_train_steps=TRAIN_ES_GENS,
                               es_episode_len=TRAIN_EPISODE,
                               es_every_steps=3 * chunk_env),
        train=dataclasses.replace(base.train, eval_every_steps=2 * chunk_env,
                                  eval_episode_len=TRAIN_EPISODE))
    reduced = (f"chunk_steps 50->{TRAIN_CHUNK}, es_train_steps "
               f"{base.es.es_train_steps}->{TRAIN_ES_GENS}, es_episode_len "
               f"{base.es.es_episode_len}->{TRAIN_EPISODE}, eval_episode_len "
               f"{base.train.eval_episode_len}->{TRAIN_EPISODE}, "
               f"warmup_steps {base.sac.warmup_steps}->{chunk_env}, "
               f"eval_every_steps {base.train.eval_every_steps}->"
               f"{2 * chunk_env}, es_every_steps {base.es.es_every_steps}->"
               f"{3 * chunk_env}")
    return cfg, reduced


def train_phases(dev, card) -> int:
    """The training path at full width: ``ETGRLTrainer.train`` through a
    cold chunk, warm chunks, an eval window with its checkpoint and an ES
    phase (``[train]``); a warm chunk through the kernel against the same
    chunk through the plain physics (``[train_vs_plain]``); the port's
    ``cli.train_bench`` schedules with one profiled control step each
    (``[train_bench]``). Returns the physics launches of ``train``."""
    import shutil

    from paddlerobotics_torch.algos import replay
    from paddlerobotics_torch.cli import train_bench
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.ops import physics_step
    from paddlerobotics_torch.train import checkpoints, etg_rl
    from paddlerobotics_torch.utils import profiler

    out_root = ROOT / "build" / "chip_smoke"
    shutil.rmtree(out_root, ignore_errors=True)
    base = QuadrupedConfig()
    chunk_env = TRAIN_CHUNK * B
    cfg, reduced = train_config()
    outdir = out_root / "train"
    tr = etg_rl.ETGRLTrainer(cfg, num_envs=B, outdir=str(outdir),
                             updates_per_step=TRAIN_K, device=dev)

    # per phase: host seconds up to a synchronize, physics launches, and
    # the control steps the phase ran
    phases: dict = {}
    calls: dict = {}                    # each call's seconds, per phase
    stack: list = []

    def recorded(obj, name, phase_of=None, steps_of=None):
        fn = getattr(obj, name)

        def run(*a, **k):
            stack.append(name)
            torch.cuda.synchronize()
            l0, t = physics_step.control_step.launches, time.perf_counter()
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                stack.pop()
            if phase_of is not None:
                ph = phases.setdefault(phase_of(a), [0.0, 0, 0, 0])
                calls.setdefault(phase_of(a), []).append(
                    round(time.perf_counter() - t, 4))
                ph[0] += time.perf_counter() - t
                ph[1] += physics_step.control_step.launches - l0
                ph[2] += steps_of(a)
                ph[3] += 1
            return out
        setattr(obj, name, run)

    recorded(tr, "rollout_chunk", lambda a: "warm" if a[3] else "cold",
             lambda a: a[2])
    recorded(tr, "_es_baseline")
    recorded(tr, "evaluate",
             lambda a: "es" if "_es_baseline" in stack else "eval",
             lambda a: a[3])
    recorded(tr, "es_eval", lambda a: "es", lambda a: a[4])
    save = checkpoints.save
    recorded(checkpoints, "save", lambda a: "checkpoint", lambda a: 0)
    try:
        physics_step.control_step.launches = 0
        t0 = time.perf_counter()
        carry, (w, b, param) = tr.train(max_steps=3 * chunk_env,
                                        chunk_steps=TRAIN_CHUNK)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = physics_step.control_step.launches
    finally:
        checkpoints.save = save
    tags: dict = {}
    with open(outdir / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["value"])
    warm_s, warm_steps = phases["warm"][0], phases["warm"][2]
    critic_loss = tags["train/critic_loss"][-1]
    log("train", B=B, K=TRAIN_K, hidden=cfg.sac.hidden_dim,
        batch=cfg.sac.batch_size, replay_capacity=cfg.sac.memory_size,
        popsize=cfg.es.popsize, es_envs=tr.es_B, seconds=round(seconds, 3),
        **{f"{n}_seconds": round(v[0], 3) for n, v in phases.items()},
        **{f"{n}_launches": v[1] for n, v in phases.items()},
        **{f"{n}_control_steps": v[2] for n, v in phases.items()},
        **{f"{n}_calls": v[3] for n, v in phases.items()},
        warm_chunk_seconds=json.dumps(calls["warm"]),
        warm_env_steps_per_s=round(warm_steps * B / warm_s, 1),
        grad_updates_per_s=round(warm_steps * TRAIN_K / warm_s, 1),
        replay_size=carry.buffer.size, critic_loss=critic_loss,
        eval_return=tags["eval/episode_reward"][-1],
        eval_length=tags["eval/episode_step"][-1],
        es_fitness_mean=tags["ES/episode_reward"][-1],
        es_fitness_max=tags["ES/episode_maxre"][-1],
        physics_launches=launches, checkpoint=checkpoints.latest_step(
            str(outdir)), reduced=repr(reduced), card=repr(card))
    want = {"cold": (1, TRAIN_CHUNK), "warm": (2, 2 * TRAIN_CHUNK),
            "eval": (1, TRAIN_EPISODE), "checkpoint": (1, 0),
            "es": (1 + TRAIN_ES_GENS, (1 + TRAIN_ES_GENS) * TRAIN_EPISODE)}
    got = {n: (v[3], v[2]) for n, v in phases.items()}
    if got != want:
        raise RuntimeError(f"train ran the phases {got}, expected {want}")
    if any(v[1] != v[2] for v in phases.values()) or \
            launches != sum(v[2] for v in phases.values()):
        raise RuntimeError(f"{launches} physics launches for the control "
                           f"steps of {phases}")
    if not np.isfinite(critic_loss) or critic_loss == 0.0:
        raise RuntimeError(f"critic loss {critic_loss}")
    if carry.buffer.size != (3 * TRAIN_CHUNK * B + TRAIN_ES_GENS
                             * TRAIN_EPISODE * cfg.es.popsize):
        raise RuntimeError(f"replay holds {carry.buffer.size} rows")
    if not all(np.isfinite(tags[k][-1]) for k in (
            "eval/episode_reward", "ES/episode_reward", "ES/episode_maxre")):
        raise RuntimeError("non-finite eval return or ES fitness")
    if not all(torch.isfinite(p).all() for p in
               carry.sac_state.actor.parameters()):
        raise RuntimeError("non-finite actor weights")
    restored = checkpoints.restore(str(outdir / f"itr_{2 * chunk_env}"))
    if restored["sac"]["actor"]["dense.0.weight"].shape != (
            cfg.sac.hidden_dim, tr.env.obs_dim):
        raise RuntimeError("checkpoint does not hold the actor")
    del carry, tr, restored

    # --- the same warm chunk and ES population rollout through the kernel
    # and through the plain physics
    trv = etg_rl.ETGRLTrainer(base, num_envs=B, outdir=str(
        out_root / "train_vs_plain"), updates_per_step=TRAIN_K, device=dev)
    P = base.es.popsize
    es_sols, _ = trv.solver.ask(trv.solver.init(
        torch.zeros(base.es.num_params, device=dev), device=dev),
        torch.Generator(device=dev).manual_seed(5))
    es_w, es_b = trv.fit_etg_population(es_sols)
    kern_step = physics_step.control_step

    def chunk():
        c, _, _ = trv.init_carry(7)
        out = trv.rollout_chunk(c, base.train.e_step, VS_PLAIN_STEPS, True)
        torch.cuda.synchronize()
        return c, out

    def es_run(actor):
        # an ES population rollout on the 320 ES envs, its replay rows in
        # a buffer of their own
        es_buf = replay.create(ES_VS_PLAIN_STEPS * P, trv.env.obs_dim,
                               trv.env.action_dim, device=dev)
        es = trv.es_eval(actor, es_w, es_b,
                         torch.Generator(device=dev).manual_seed(9),
                         ES_VS_PLAIN_STEPS, P, es_buf)
        torch.cuda.synchronize()
        return es, es_buf

    kern_step.launches = 0
    ck, out_k = chunk()
    launches_k = kern_step.launches
    es_actor = ck.sac_state.actor           # both ES runs roll this policy
    kern_step.launches = 0
    es_k, es_buf_k = es_run(es_actor)
    launches_es = kern_step.launches
    with plain_physics():
        cp, out_p = chunk()
        es_p, es_buf_p = es_run(es_actor)
    row_diff = (ck.buffer.data[:B] - cp.buffer.data[:B]).abs().max().item()
    param_diff = max(
        (a - c).abs().max().item()
        for m_k, m_p in ((ck.sac_state.actor, cp.sac_state.actor),
                         (ck.sac_state.critic, cp.sac_state.critic))
        for a, c in zip(m_k.parameters(), m_p.parameters()))
    rows_all = (ck.buffer.data[:VS_PLAIN_STEPS * B]
                - cp.buffer.data[:VS_PLAIN_STEPS * B]).abs().max().item()
    log("train_vs_plain", B=B, K=TRAIN_K, steps=VS_PLAIN_STEPS,
        kernel_launches=launches_k,
        first_step_replay_max_abs_diff=row_diff,
        all_steps_replay_max_abs_diff=rows_all,
        param_max_abs_diff=param_diff,
        critic_loss_kernel=out_k["critic_loss"].item(),
        critic_loss_plain=out_p["critic_loss"].item(),
        nondeterministic=("none" if param_diff == 0 else
                          "the learner (cuBLAS GEMM, Adam) on bit-equal "
                          "replay rows" if rows_all == 0 else
                          "the env step after the first"))
    fit_diff = (es_k[0] - es_p[0]).abs().max().item()
    fit_scale = max(1.0, es_p[0].abs().max().item())
    len_diff = (es_k[1] - es_p[1]).abs().max().item()
    es_rows = (es_buf_k.data - es_buf_p.data).abs().max().item()
    log("es_eval_vs_plain", B=trv.es_B, popsize=P, steps=ES_VS_PLAIN_STEPS,
        kernel_launches=launches_es,
        fitness_max_abs_diff=fit_diff, fitness_max_abs=fit_scale,
        fitness_rtol=ES_FIT_RTOL, episode_length_max_abs_diff=len_diff,
        replay_rows=es_buf_k.size, replay_max_abs_diff=es_rows,
        fitness_kernel_mean=es_k[0].mean().item(),
        fitness_plain_mean=es_p[0].mean().item(),
        finite=bool(torch.isfinite(es_k[0]).all().item()))
    if (launches_k, launches_es) != (VS_PLAIN_STEPS, ES_VS_PLAIN_STEPS):
        raise RuntimeError(f"{launches_k} + {launches_es} launches for "
                           f"{VS_PLAIN_STEPS} + {ES_VS_PLAIN_STEPS} steps")
    if row_diff != 0.0 or param_diff > TRAIN_PARAM_TOL:
        raise RuntimeError("training through the kernel disagrees with the "
                           "plain physics")
    if (es_rows != 0.0 or len_diff != 0.0 or fit_diff > ES_FIT_RTOL * fit_scale
            or es_buf_k.size != ES_VS_PLAIN_STEPS * P
            or not torch.isfinite(es_k[0]).all()):
        raise RuntimeError("the ES rollout through the kernel disagrees with "
                           "the plain physics")
    del ck, cp, trv, es_buf_k, es_buf_p

    # --- the port's train_bench schedules, one profiled control step each ---
    for tag, Bs, Ks in train_bench.SCHEDULES:
        r = train_bench.bench_schedule(tag, Bs, Ks, TRAIN_CHUNK,
                                       BENCH_ITERS, str(out_root / "bench"),
                                       device=dev)
        trb = train_bench.make_trainer(Bs, Ks, str(out_root / "bench_prof"),
                                       device=dev)
        c = trb.init_carry(0)[0]
        trb.rollout_chunk(c, 600, 1, True)

        def one_step():
            trb.rollout_chunk(c, 600, 1, True)

        prof = profiler.device_breakdown(one_step, reps=3,
                                         match="control_step_kernel")
        # the chunk's two parts apart, on the host clock up to a
        # synchronize after PART_REPS calls and under the profiler: one SAC
        # update, one env step
        batch = {f: v[0] for f, v in replay.sample_many(
            c.buffer, 1, trb.cfg.sac.batch_size, generator=c.rng).items()}
        zeros = torch.zeros((Bs, trb.env.action_dim), device=dev)
        parts = {
            "learn": lambda: trb.sac.learn(c.sac_state, batch,
                                           generator=c.rng),
            "env_step": lambda: trb.env.step(c.env_state, zeros)}
        part = {}
        for name, fn in parts.items():
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(PART_REPS):
                fn()
            torch.cuda.synchronize()
            part[f"{name}_host_ms"] = round(
                1e3 * (time.perf_counter() - t) / PART_REPS, 4)
            pp = profiler.device_breakdown(fn, reps=5)
            part[f"{name}_kernels"] = pp["kernels_per_call"]
            part[f"{name}_device_ms"] = round(pp["device_ms_per_call"], 4)
        log("train_bench", **r, chunk_steps=TRAIN_CHUNK, iters=BENCH_ITERS,
            kernels_per_control_step=prof["kernels_per_call"],
            physics_launches_per_control_step=prof["match_launches_per_call"],
            device_ms_per_control_step=round(prof["device_ms_per_call"], 4),
            wall_ms_per_control_step=round(prof["wall_ms_per_call"], 4),
            device_busy_share=round(prof["device_busy_share"], 4),
            **part,
            top=json.dumps(prof["top"]), card=repr(card))
        if prof["match_launches_per_call"] != 1.0:
            raise RuntimeError("a control step of the chunk did not launch "
                               "the physics kernel once")
        del trb, c
    return launches


def mesh_train_phase(dev, card) -> int:
    """``[mesh_train]``: ``ETGRLTrainer(mesh=)`` over a mesh of one NCCL
    rank (a ``FileStore``, ``init_device_mesh("cuda", (1, 1))``) at the
    ``[train]`` configuration (full widths, B=4096, K=4), through
    ``train()``: cold chunk, two warm chunks, the eval window with its
    checkpoint, the ES phase on the 320 ES envs. Every collective of the
    mesh path runs on NCCL (the env axis's gathers and reductions, the
    gradient all-reduce, the checkpoint's gather). The same ``train()``
    without a mesh, from the same seeds, is its reference. Returns the mesh
    run's physics launches."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    from paddlerobotics_torch.ops import physics_step
    from paddlerobotics_torch.parallel import sharding
    from paddlerobotics_torch.train import checkpoints, etg_rl

    cfg, reduced = train_config()
    chunk_env = TRAIN_CHUNK * B
    steps = 3 * TRAIN_CHUNK + TRAIN_EPISODE + (1 + TRAIN_ES_GENS) * \
        TRAIN_EPISODE                            # the rank's control steps
    out_root = ROOT / "build" / "chip_smoke" / "mesh_train"
    store = tempfile.mkdtemp(prefix="mesh_store_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(pathlib.Path(store) / "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    runs = {}
    try:
        mesh = sharding.make_mesh(1, 1)
        # NCCL makes a group's communicator at its first collective: set-up,
        # timed apart from the training run
        t = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(
            sharding.ENV))
        torch.cuda.synchronize()
        nccl_init_s = time.perf_counter() - t
        for name, m in (("mesh", mesh), ("no_mesh", None)):
            tr = etg_rl.ETGRLTrainer(cfg, num_envs=B,
                                     outdir=str(out_root / name),
                                     updates_per_step=TRAIN_K, mesh=m,
                                     device=dev)
            torch.cuda.synchronize()
            physics_step.control_step.launches = 0
            t = time.perf_counter()
            carry, _ = tr.train(max_steps=3 * chunk_env,
                                chunk_steps=TRAIN_CHUNK)
            torch.cuda.synchronize()
            runs[name] = {
                "seconds": time.perf_counter() - t,
                "launches": physics_step.control_step.launches,
                "actor": sharding.full_state_dict(carry.sac_state.actor),
                "critic": sharding.full_state_dict(carry.sac_state.critic),
                "replay": carry.buffer.size,
                "blocked": carry.buffer.blocked,
                "ckpt": checkpoints.restore(str(
                    out_root / name / f"itr_{2 * chunk_env}"))["sac"]}
            del carry, tr
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    a, b = runs["mesh"], runs["no_mesh"]
    diff = lambda x, y: max((x[k] - y[k]).abs().max().item() for k in x)
    actor_d, critic_d = diff(a["actor"], b["actor"]), \
        diff(a["critic"], b["critic"])
    ckpt_d = diff(a["ckpt"]["actor"], b["ckpt"]["actor"])
    ok = (a["launches"] == b["launches"] == steps and backend == "nccl"
          and a["blocked"] and a["replay"] == b["replay"]
          and actor_d <= MESH_ACTOR_TOL and ckpt_d <= MESH_ACTOR_TOL
          and all(torch.isfinite(v).all() for v in a["actor"].values()))
    log("mesh_train", backend=backend, world=1, mesh="1x1", B=B, K=TRAIN_K,
        hidden=cfg.sac.hidden_dim, batch=cfg.sac.batch_size,
        popsize=cfg.es.popsize, control_steps=steps,
        physics_launches=a["launches"],
        no_mesh_physics_launches=b["launches"],
        nccl_init_seconds=round(nccl_init_s, 3),
        seconds=round(a["seconds"], 3),
        no_mesh_seconds=round(b["seconds"], 3),
        actor_max_abs_diff=actor_d, critic_max_abs_diff=critic_d,
        checkpoint_actor_max_abs_diff=ckpt_d, tol=MESH_ACTOR_TOL,
        replay_rows=a["replay"], reduced=repr(reduced),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the mesh trainer on NCCL disagrees with the run "
                           "without a mesh, or launched the physics kernel "
                           f"{a['launches']} times for {steps} control steps")
    return a["launches"]


def bench_entry_phases(dev, card, env, nodr_rate: float) -> dict:
    """The bench command, the flagship step and the profiler on the card:
    ``cli.env_bench --regime both`` as a subprocess, one step of
    ``graft_entry.entry()`` against the plain physics, the NaN checks on a
    clean env step and on faults planted inside both kernels, and a trace
    of annotated env steps. Returns the physics launches of each."""
    import threading

    from paddlerobotics_torch import graft_entry
    from paddlerobotics_torch.ops import attention, physics_step
    from paddlerobotics_torch.sim import sbatch
    from paddlerobotics_torch.utils import profiler

    # --- the bench command -------------------------------------------------
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-m",
                          "paddlerobotics_torch.cli.env_bench",
                          "--regime", "both"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    seconds = time.perf_counter() - t
    if run.returncode != 0:
        raise RuntimeError(f"cli.env_bench exited {run.returncode}: "
                           f"{run.stderr[-2000:]}")
    lines = [json.loads(x) for x in run.stdout.splitlines()
             if x.startswith("{")]
    no_dr, dr, ratio, metric = lines
    name, limit = [x.strip() for x in card.rsplit(",", 1)]
    ok = (len(lines) == 4 and no_dr["ring_len"] == 2 and
          dr["ring_len"] == 40 and metric["metric"] ==
          "a1_env_steps_per_sec_per_chip_4096envs" and
          metric["value"] == no_dr["env_steps_per_s"] > 0 and
          metric["device"] == {"name": name, "power_limit": limit} and
          "vs_baseline" not in metric and ratio["dr_over_nodr"] > 0)
    log("env_bench_cli", seconds=round(seconds, 1),
        lines=json.dumps(lines), in_process_no_dr=round(nodr_rate, 1),
        result="pass" if ok else "FAIL")
    if not ok:
        raise RuntimeError("cli.env_bench printed unexpected lines")

    # --- the flagship step ---------------------------------------------------
    fn, (st, actor, obs) = graft_entry.entry(256)

    def entry_step():
        rng = torch.Generator(device=dev)
        rng.set_state(st.rng.get_state())
        return fn(st.replace(rng=rng), actor, obs)

    out_k, entry_launches, _ = launched(entry_step)
    with plain_physics():
        out_p = entry_step()
    torch.cuda.synchronize()
    equal = [torch.equal(a, b) for a, b in zip(out_k, out_p)]
    log("graft_entry", B=256, shapes=json.dumps([list(o.shape)
                                                  for o in out_k]),
        kernel_launches=entry_launches, bit_equal_to_plain=json.dumps(equal),
        finite=bool(torch.isfinite(out_k[0]).all().item()))
    if entry_launches != 1 or not all(equal):
        raise RuntimeError("graft_entry: not one launch, or not bit-equal "
                           "to the plain physics")

    # --- NaN checks ----------------------------------------------------------
    zeros = torch.zeros((env.B, 12), device=dev)
    st0, _ = env.reset(torch.Generator(device=dev).manual_seed(3))

    def step(state=st0):
        rng = torch.Generator(device=dev)
        rng.set_state(state.rng.get_state())
        ns, nobs, rew, done, _ = env.step(state.replace(rng=rng), zeros)
        return [nobs, rew, done, ns.robot.obs_hist] + [
            getattr(ns.robot.s, f) for f in ("pos", "quat", "w", "v", "q",
                                             "qd")]

    def ms_per_step(reps=5):
        step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    ref = step()
    off_ms = ms_per_step()
    # a fault inside each kernel, built before the checks are on: env 0
    # without base or leg mass (a singular articulated inertia: NaN, not
    # inf, in that env's state), and +inf in q at a masked score (inf·0 in
    # the kernel's masked score)
    p = sbatch.BDynParams.default(env.B, device=dev)
    base, leg = p.base_mass_scale.clone(), p.leg_mass_scale.clone()
    base[0] = 0.0
    leg[:, 0] = 0.0
    st_bad, _ = env.reset(torch.Generator(device=dev).manual_seed(3),
                          dyn=p._replace(base_mass_scale=base,
                                         leg_mass_scale=leg))
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((1, 8, 200, 64), generator=gen, device=dev)
               for _ in range(3))
    mask = torch.ones((1, 200, 200), device=dev)
    mask[0, 0, 100:] = 0.0
    q[0, 0, 0, 0] = float("inf")
    x = torch.zeros(3, device=dev, requires_grad=True)
    threads = []
    x.register_hook(lambda g: threads.append(threading.get_ident()))
    (torch.sqrt(x) * 0.0).sum().backward()          # without the checks
    raised = {}
    physics_step.control_step.launches = 0
    profiler.enable_nan_checks()
    try:
        got = step()
        torch.cuda.synchronize()
        on_ms = ms_per_step()
        for name, fault in (
                ("control_step", lambda: step(st_bad)),
                ("flash_attention", lambda: attention.flash_attention(
                    q, k, v, mask)),
                ("backward", lambda: (torch.sqrt(x) * 0.0).sum().backward())):
            try:
                fault()
                torch.cuda.synchronize()
                raised[name] = None
            except FloatingPointError as e:
                raised[name] = str(e)
    finally:
        profiler.enable_nan_checks(False)
    checked_launches = physics_step.control_step.launches
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    # checks off: the same faults pass silently, their NaN in the outputs
    silent_env = step(st_bad)[0]
    with plain_physics():
        plain_env = step(st_bad)[0]
    with torch.no_grad():
        silent_attn = attention.flash_attention(q, k, v, mask)
    x.grad = None
    (torch.sqrt(x) * 0.0).sum().backward()
    silent = {"control_step_env0_nan": bool(silent_env[0].isnan().any()),
              "control_step_others_finite": bool(
                  silent_env[1:].isfinite().all()),
              "control_step_nan_where_plain_nan": torch.equal(
                  silent_env.isnan(), plain_env.isnan()),
              "flash_attention_nan": bool(silent_attn.isnan().any()),
              "backward_nan": bool(x.grad.isnan().all())}
    ok = (bit_equal and all(silent.values()) and
          raised["control_step"] is not None and
          "control_step (ops/csrc/physics_step.cu)" in raised["control_step"]
          and raised["flash_attention"] is not None and
          "flash_attention (ops/csrc/attention.cu)" in raised[
              "flash_attention"] and raised["backward"] is not None and
          "aten." in raised["backward"] and not profiler.nan_checks_on)
    log("nan_checks", B=env.B, clean_step_bit_equal=bit_equal,
        ms_per_step_off=round(off_ms, 3), ms_per_step_on=round(on_ms, 3),
        kernel_launches=checked_launches,
        raised=json.dumps(raised), silent_when_off=json.dumps(silent),
        backward_thread_is_callers=threads[0] == threading.get_ident(),
        fault_physics="env 0 base and leg mass scale 0",
        fault_attention="q[0,0,0,0]=+inf, mask[0,0,100:]=0",
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the NaN checks missed a fault, raised on a "
                           "clean step or changed its result")

    # --- trace + annotate ----------------------------------------------------
    holder = [st0]
    physics_step.control_step.launches = 0
    with profiler.trace(str(ROOT / "build" / "chip_smoke" / "trace")) as path:
        for _ in range(3):
            with profiler.annotate("env_step"):
                holder[0] = env.step(holder[0], zeros)[0]
    trace_launches = physics_step.control_step.launches
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and
               "control_step_kernel" in e.get("name", "")]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and
              e.get("name") == "env_step"]
    all_kernels = [e for e in events if e.get("cat") == "kernel"]
    log("trace", path=pathlib.Path(path).name, events=len(events),
        physics_kernels=len(kernels), ranges=len(ranges),
        kernels=len(all_kernels), kernel_launches=trace_launches,
        physics_device_us=json.dumps([e.get("dur") for e in kernels]))
    if len(kernels) != 3 or len(ranges) != 3 or trace_launches != 3:
        raise RuntimeError("the trace does not hold 3 physics kernels and "
                           "3 env_step ranges")
    return {"graft_entry_launches": entry_launches,
            "nan_checks_launches": checked_launches,
            "trace_launches": trace_launches}


@contextlib.contextmanager
def plain_physics():
    """Route the env's physics call to the plain version
    (``sim/sbatch.control_step``) for the duration."""
    from paddlerobotics_torch.ops import physics_step
    from paddlerobotics_torch.sim import sbatch

    kern = physics_step.control_step
    physics_step.control_step = sbatch.control_step
    try:
        yield
    finally:
        physics_step.control_step = kern


def launched(fn):
    """(fn(), physics launches, seconds up to a synchronize)."""
    from paddlerobotics_torch.ops import physics_step

    torch.cuda.synchronize()
    physics_step.control_step.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, physics_step.control_step.launches,
            round(time.perf_counter() - t, 3))


def dynid_dyn(B: int, dev, seed: int = 2):
    """B per-env dynamics from 48 uniform parameters in [-1, 1] each
    (gravity and 0–80 ms latency included), as dynamics ID injects them."""
    from paddlerobotics_torch.envs import randomize

    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((randomize.NUM_DYNAMIC_PARAMS, B), generator=gen,
                   device=dev) * 2.0 - 1.0
    return randomize.param2dynamic(u)


def stack_phases(dev, card) -> dict:
    """The rest of the ETG-RL stack's entry points on the card, each driven
    through its CLI or module with the launch count set to 0 just before
    it: ETG pretraining (``[pretrain]``), the task matrix's train →
    checkpoint → restore → eval (``[eval_matrix]``), gait export and the
    deployment loop at B=1 (``[export_gait]``, ``[deploy_loop]``),
    behaviour cloning (``[bc]``) and dynamics identification
    (``[dynamics_id]``); each path's rollout also through the plain
    physics (``[*_vs_plain]``). Returns the physics launches of each."""
    import dataclasses
    import shutil

    from paddlerobotics_torch.algos import replay
    from paddlerobotics_torch.algos.sac import SAC
    from paddlerobotics_torch.cli import (bc_train, dynamics_id, eval_matrix,
                                          export_gait, pretrain_etg)
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.deploy import policy_export, realtime
    from paddlerobotics_torch.envs import randomize
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.etg import fit
    from paddlerobotics_torch.train import (bc_train as bc_mod, checkpoints,
                                            dynamics_id as dynid_mod,
                                            etg_rl, pretrain)

    out_root = ROOT / "build" / "chip_smoke" / "stack"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)
    base = QuadrupedConfig()
    counts = {}

    # --- [pretrain]: cli.pretrain_etg, depth cut through the episode length
    orig_train = pretrain.ETGPretrainer.train
    pretrain.ETGPretrainer.train = lambda self, **kw: orig_train(
        self, episode_len=PRETRAIN_STEPS, **kw)
    try:
        (best, best_r), n, sec = launched(lambda: pretrain_etg.main([
            "--popsize", str(base.es.popsize), "--num_envs",
            str(PRETRAIN_ENVS), "--generations", str(PRETRAIN_GENS),
            "--outdir", str(out_root / "pretrain"), "--save_path",
            str(out_root / "etg_pretrained.npz"), "--device", "cuda"]))
    finally:
        pretrain.ETGPretrainer.train = orig_train
    art = np.load(out_root / "etg_pretrained.npz")
    log("pretrain", popsize=base.es.popsize, B=PRETRAIN_ENVS,
        generations=PRETRAIN_GENS, steps=PRETRAIN_STEPS, launches=n,
        best_fitness=best_r, seconds=sec,
        npz=json.dumps({k: list(art[k].shape) for k in art.files}),
        reduced=repr(f"generations 100->{PRETRAIN_GENS}, episode_len "
                     f"400->{PRETRAIN_STEPS}"), card=repr(card))
    if n != PRETRAIN_GENS * PRETRAIN_STEPS:
        raise RuntimeError(f"{n} launches for {PRETRAIN_GENS} x "
                           f"{PRETRAIN_STEPS} control steps")
    if not np.isfinite(best_r) or sorted(art.files) != ["b", "param", "w"]:
        raise RuntimeError("pretraining gave no finite best fitness or npz")
    counts["pretrain_launches"] = n

    # --- [pretrain_vs_plain]: one generation's fitness, kernel vs plain
    pt = pretrain.ETGPretrainer(base, num_envs=PRETRAIN_ENVS,
                                outdir=str(out_root / "pretrain_vs_plain"),
                                device=dev)
    sols, _ = pt.solver.ask(pt.solver.init(device=dev),
                            torch.Generator(device=dev).manual_seed(3))

    def population():
        return pt._rollout_population(
            sols, torch.Generator(device=dev).manual_seed(4),
            PRETRAIN_VS_PLAIN_STEPS)

    fit_k, n, sec = launched(population)
    with plain_physics():
        fit_p = population()
    diff = (fit_k - fit_p).abs().max().item()
    spread = (fit_k.max() - fit_k.min()).item()
    log("pretrain_vs_plain", B=PRETRAIN_ENVS, popsize=base.es.popsize,
        steps=PRETRAIN_VS_PLAIN_STEPS, launches=n,
        fitness_max_abs_diff=diff, fitness_spread=spread,
        fitness_mean=fit_k.mean().item(), card=repr(card))
    if n != PRETRAIN_VS_PLAIN_STEPS or diff != 0.0 or not spread > 0.0 \
            or not torch.isfinite(fit_k).all():
        raise RuntimeError("pretraining fitness through the kernel differs "
                           "from the plain physics, or is constant")
    del pt

    # --- [eval_matrix]: run_task train → checkpoint, then restore → eval
    evals = []
    orig_eval = etg_rl.ETGRLTrainer.evaluate

    def kept_eval(self, *a, **k):
        out = orig_eval(self, *a, **k)
        evals.append([float(out[0]), float(out[1]),
                      float(out[2]["velx"]), float(out[2]["success"])])
        return out

    root = out_root / "matrix"
    chunk = MATRIX_CHUNK * B
    # the preset's width (ground: B=4096, K=4); one cold and one warm chunk
    over = {"warmup_steps": chunk, "num_envs": B}
    etg_rl.ETGRLTrainer.evaluate = kept_eval
    try:
        row, n_tr, sec_tr = launched(lambda: eval_matrix.run_task(
            "ground", str(root), True, 2 * chunk, MATRIX_EVAL,
            overrides=over, device=dev))
        row2, n_ev, sec_ev = launched(lambda: eval_matrix.run_task(
            "ground", str(root), False, 0, MATRIX_EVAL, overrides=over,
            device=dev))
    finally:
        etg_rl.ETGRLTrainer.evaluate = orig_eval
    (ret_t, len_t, vx_t, su_t), (ret_r, len_r, vx_r, su_r) = evals
    d_ret = abs(ret_r - ret_t)
    ok_eval = all(abs(a - b) <= MATRIX_RTOL * max(1.0, abs(a)) for a, b in
                  zip(evals[0], evals[1]))
    log("eval_matrix", task="ground", schedule=row["schedule"],
        budget=2 * chunk, train_launches=n_tr, train_seconds=sec_tr,
        restore_launches=n_ev, restore_seconds=sec_ev,
        eval_return=ret_t, eval_steps=len_t, restored_eval_return=ret_r,
        restored_eval_steps=len_r, eval_return_abs_diff=d_ret,
        eval_velx_abs_diff=abs(vx_r - vx_t),
        eval_success_abs_diff=abs(su_r - su_t), row=json.dumps(row),
        reduced=repr(f"budget 20000000->{2 * chunk}, warmup_steps "
                     f"200000->{chunk}"), card=repr(card))
    if (n_tr, n_ev) != (2 * MATRIX_CHUNK + MATRIX_EVAL, MATRIX_EVAL):
        raise RuntimeError(f"{n_tr} + {n_ev} launches for the task "
                           f"matrix's control steps")
    if not ok_eval or not np.isfinite(ret_t) or \
            checkpoints.latest_step(str(root / "ground")) != 2 * chunk:
        raise RuntimeError("the restored checkpoint's eval does not "
                           "reproduce the trained one")
    cfg_m, _, _ = eval_matrix.build_task_config("ground", overrides=over)
    restored = checkpoints.restore(str(root / "ground" / f"itr_{2 * chunk}"),
                                   device=dev)
    expert = SAC(base.sensors.base_obs_dim, 12, cfg_m.sac,
                 device=dev).init(None)
    checkpoints.load_sac_state(expert, restored["sac"])
    counts["eval_matrix_launches"] = n_tr + n_ev

    # --- [export_gait]: the CLI's table against the env's residual
    with contextlib.chdir(out_root):
        table = export_gait.main(["--steps", str(GAIT_STEPS), "--suffix",
                                  "smoke", "--device", "cuda"])
    saved = np.load(out_root / "gait_action_list_ETG_smoke.npy")
    env1 = BatchedQuadrupedEnv(base, 1, device=dev)
    w0, b0 = fit.opt_with_points(base.etg, device=dev)
    worst = 0.0
    for t in range(GAIT_STEPS):
        r = env1._etg_residual(w0[..., None], b0[:, None], torch.full(
            (1,), t, dtype=torch.int32, device=dev))[0][:, 0]
        worst = max(worst, float(np.abs(r.cpu().numpy() - saved[t]).max()))
    log("export_gait", steps=GAIT_STEPS, shape=list(saved.shape),
        max_abs_diff_vs_env_residual=worst,
        file_equals_return=bool(np.array_equal(saved, table)),
        card=repr(card))
    if saved.shape != (GAIT_STEPS, 12) or worst != 0.0 or \
            not np.array_equal(saved, table):
        raise RuntimeError("the exported gait table is not the env's "
                           "residual")

    # --- [deploy_loop]: the exported policy at B=1, kernel vs plain
    policy = policy_export.export_policy_fn(expert.actor, saved,
                                            env1.act_bound, device=dev)
    sil = dataclasses.replace(base, etg=dataclasses.replace(base.etg,
                                                            step_y=0.0))

    def loop():
        io = realtime.SimRobotIO(BatchedQuadrupedEnv(sil, 1, device=dev))
        return realtime.run_control_loop(
            policy, io, dt=DEPLOY_DT, max_time=(DEPLOY_TICKS + 0.5)
            * DEPLOY_DT)

    (obs_k, act_k), n, sec = launched(loop)
    with plain_physics():
        obs_p, act_p = loop()
    aot = policy_export.aot_compile_policy(policy, base.sensors.base_obs_dim)
    obs_t = torch.as_tensor(obs_k, device=dev)
    aot_diff = max((aot(obs_t[i], torch.tensor(i, device=dev))
                    - policy(obs_t[i], i)).abs().max().item()
                   for i in range(DEPLOY_TICKS))
    d_obs = float(np.abs(obs_k - obs_p).max())
    d_act = float(np.abs(act_k - act_p).max())
    log("deploy_loop", B=1, ticks=len(act_k), dt=DEPLOY_DT, launches=n,
        seconds=sec, paced_seconds=round(DEPLOY_TICKS * DEPLOY_DT, 3),
        obs_max_abs_diff=d_obs, target_max_abs_diff=d_act,
        export_max_abs_diff=aot_diff,
        finite=bool(np.isfinite(obs_k).all() and np.isfinite(act_k).all()),
        card=repr(card))
    if n != DEPLOY_TICKS or len(act_k) != DEPLOY_TICKS or d_obs != 0.0 or \
            d_act != 0.0 or aot_diff != 0.0 or not np.isfinite(act_k).all():
        raise RuntimeError("the deployment loop through the kernel differs "
                           "from the plain physics or the exported policy")
    counts["deploy_launches"] = n

    # --- [bc]: cli.bc_train on the task matrix's expert
    bc_row, n, sec = launched(lambda: bc_train.main([
        "--expert_dir", str(root / "ground"), "--num_envs", str(BC_ENVS),
        "--bc_steps", str(BC_STEPS), "--eval_steps", str(BC_EVAL),
        "--outdir", str(out_root / "bc"), "--device", "cuda"]))
    n_collect = BC_STEPS // BC_ENVS
    log("bc", B=BC_ENVS, bc_steps=BC_STEPS, batch=bc_mod.REF_BATCH,
        launches=n, collect_steps=n_collect, eval_steps=2 * BC_EVAL,
        seconds=sec, actor_loss=bc_row["actor_loss"],
        critic_loss=bc_row["critic_loss"], ref_ratio=bc_row["ref_ratio"],
        student_return=bc_row["student_return"],
        expert_return=bc_row["expert_return"],
        reduced=repr(f"bc_steps 200000->{BC_STEPS}, eval_steps "
                     f"600->{BC_EVAL}"), card=repr(card))
    if n != n_collect + 2 * BC_EVAL or not all(np.isfinite(bc_row[k]) for k in (
            "actor_loss", "critic_loss", "ref_ratio")) or not \
            (out_root / "bc" / f"itr_{BC_STEPS}.pt").exists():
        raise RuntimeError(f"behaviour cloning: {n} launches, {bc_row}")
    counts["bc_launches"] = n

    # --- [bc_vs_plain]: one collect phase, kernel vs plain
    w_e, b_e = fit.opt_with_points(base.etg, device=dev)
    bct = bc_mod.BCTrainer(cfg_m, expert, w_e, b_e, num_envs=BC_ENVS,
                           outdir=str(out_root / "bc_vs_plain"), device=dev)

    def collect():
        gen = torch.Generator(device=dev).manual_seed(11)
        env_state, obs = bct.reset(gen)
        student = bct.bc.init(torch.Generator(device=dev).manual_seed(12))
        buf = replay.bc_create(BC_COLLECT * BC_ENVS, bct.student_obs_dim,
                               bct.env.obs_dim, device=dev)
        _, _, (s_obs, e_obs) = bct.collect(student, env_state, obs,
                                           BC_COLLECT, False, gen)
        replay.bc_add_batch(buf, s_obs, e_obs)
        return buf

    buf_k, n, sec = launched(collect)
    with plain_physics():
        buf_p = collect()
    diff = (buf_k.data - buf_p.data).abs().max().item()
    log("bc_vs_plain", B=BC_ENVS, steps=BC_COLLECT, launches=n,
        rows=buf_k.size, max_abs_diff=diff,
        finite=bool(torch.isfinite(buf_k.data).all().item()),
        card=repr(card))
    if n != BC_COLLECT or diff != 0.0 or buf_k.size != BC_COLLECT * BC_ENVS:
        raise RuntimeError("BC collection through the kernel differs from "
                           "the plain physics")
    del bct, buf_k, buf_p

    # --- [dynamics_id]: traces under a hidden draw, then the CLI
    dcfg = dataclasses.replace(base, sim=dataclasses.replace(
        base.sim, obs_latency_taps=base.sim.latency_buffer_len))
    env_h = BatchedQuadrupedEnv(dcfg, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    hidden = (torch.rand((randomize.NUM_DYNAMIC_PARAMS, 1), generator=gen,
                         device=dev) * 2.0 - 1.0) * 0.5
    gait = torch.as_tensor(saved[:DYNID_T], device=dev)
    q, gyro = dynid_mod.generate_trace(env_h, gait,
                                       randomize.param2dynamic(hidden), gen,
                                       noise_q=0.01, noise_gyro=0.05)
    files = {k: str(out_root / f"dynid_{k}.npy")
             for k in ("gait", "real_q", "real_gyro")}
    for k, v in (("gait", gait), ("real_q", q[:, 0]), ("real_gyro",
                                                        gyro[:, 0])):
        np.save(files[k], v.cpu().numpy())
    (ident, best), n, sec = launched(lambda: dynamics_id.main([
        *[a for k, f in files.items() for a in (f"--{k}", f)],
        "--popsize", str(DYNID_POP), "--epochs", str(DYNID_EPOCHS),
        "--outdir", str(out_root / "dynid"), "--save",
        str(out_root / "dynamic_param.npy"), "--device", "cuda"]))
    l_id, l_nom, l_true = ident.score(torch.stack(
        [best, torch.zeros_like(best), hidden[:, 0]])).tolist()
    log("dynamics_id", popsize=DYNID_POP, T=DYNID_T, epochs=DYNID_EPOCHS,
        launches=n, seconds=sec, ring=ident.env._hist_len,
        identified_loss=l_id, nominal_loss=l_nom, true_loss=l_true,
        reduced=repr(f"epochs 50->{DYNID_EPOCHS}"), card=repr(card))
    if n != DYNID_EPOCHS * DYNID_T or not l_id < l_nom or \
            not np.isfinite(l_id):
        raise RuntimeError(f"dynamics ID: {n} launches, identified loss "
                           f"{l_id} against nominal {l_nom}")
    counts["dynid_launches"] = n

    # --- [dynamics_id_vs_plain]: one _fitness call, kernel vs plain
    short = dynid_mod.DynamicsIdentifier(
        base, gait[:DYNID_VS_PLAIN_T], q[:DYNID_VS_PLAIN_T, 0],
        gyro[:DYNID_VS_PLAIN_T, 0], popsize=DYNID_POP,
        outdir=str(out_root / "dynid_vs_plain"), device=dev)
    sols, _ = short.solver.ask(short.solver.init(device=dev),
                               torch.Generator(device=dev).manual_seed(6))

    def fitness():
        return short._fitness(sols, torch.Generator(device=dev).manual_seed(7))

    fit_k, n, sec = launched(fitness)
    with plain_physics():
        fit_p = fitness()
    diff = (fit_k - fit_p).abs().max().item()
    log("dynamics_id_vs_plain", popsize=DYNID_POP, T=DYNID_VS_PLAIN_T,
        launches=n, fitness_max_abs_diff=diff,
        fitness_mean=fit_k.mean().item(), card=repr(card))
    if n != DYNID_VS_PLAIN_T or diff != 0.0 or \
            not torch.isfinite(fit_k).all():
        raise RuntimeError("dynamics-ID fitness through the kernel differs "
                           "from the plain physics")
    return counts


def hri_phases(dev, card):
    """The HRI serving path and the attention kernel; returns the kernel's
    entry of the ``kernels`` line and the YOLOv4 scene sensor."""
    import torch.nn.functional as F

    from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                         AttnCtrlConfig)
    from paddlerobotics_torch.hri.eval_client import OfflineEvaluator
    from paddlerobotics_torch.hri.perception.scene import SceneSensor
    from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                                  ServiceConfig)
    from paddlerobotics_torch.hri.transformer import (frame_ids_to_attn_mask,
                                                      merge_padding_mask)
    from paddlerobotics_torch.ops import attention
    from paddlerobotics_torch.utils import profiler

    rng = np.random.default_rng(1)
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    F_, K_ = 10, 20                     # window: frames × tokens per frame

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def pad_mask(B, n):
        """(B, n) padding mask with absent detections: each frame of K_
        slots keeps its first 1..K_ (the scene sensor's layout)."""
        keep = rng.integers(1, K_ + 1, size=(B, n // K_))
        slots = np.arange(K_)[None, None] < keep[..., None]
        return torch.as_tensor(slots.reshape(B, n), dtype=torch.float32,
                               device=dev)

    def window_mask(B, past=0, T=F_ * K_):
        """The controller's mask: block-causal over frame ids, merged with
        the padding; with a past-KV cache of ``past`` keys in front."""
        fids = torch.arange(1, T // K_ + 1, device=dev).repeat_interleave(K_)
        m = frame_ids_to_attn_mask(fids[None].expand(B, T))
        pad = pad_mask(B, past + T)
        if past:
            m = torch.cat([m.new_ones(B, T, past), m], dim=-1)
        return merge_padding_mask(m, pad)

    # --- attention kernel against its plain version ---------------------------
    def qkv(B, H, T, S, hd):
        return randn(B, H, T, hd), randn(B, H, S, hd), randn(B, H, S, hd)

    full = (torch.rand(2, 64, 64, generator=gen, device=dev) < 0.5).float()
    full[:, ::3] = 0.0                  # every third row: no key at all
    # head dims on a wider instance (48 on 64) and the widest (128), each
    # with ragged T and S and a row with no key; a generator of their own
    # leaves the serving weights below as they were
    g_hd = torch.Generator(dev)
    g_hd.manual_seed(3)

    def hd_case(B, H, T, S, hd):
        q, k, v = (torch.randn(shape, generator=g_hd, device=dev)
                   for shape in ((B, H, T, hd), (B, H, S, hd), (B, H, S, hd)))
        m = (torch.rand(B, T, S, generator=g_hd, device=dev) < 0.6).float()
        m[:, T // 2] = 0.0
        return (q, k, v), m
    cases = [
        ("serving", qkv(1, 8, 200, 200, 64), window_mask(1)),
        ("past_kv", qkv(1, 8, 20, 200, 64), window_mask(1, past=180, T=20)),
        ("fully_masked_rows", qkv(2, 8, 64, 64, 64), full),
        ("ragged", qkv(2, 3, 37, 53, 32),
         (torch.rand(2, 37, 53, generator=gen, device=dev) < 0.5).float()),
        ("windows_64", qkv(N_WINDOWS, 8, 200, 200, 64),
         window_mask(N_WINDOWS)),
        ("hd16", qkv(2, 4, 40, 40, 16),
         (torch.rand(2, 40, 40, generator=gen, device=dev) < 0.7).float()),
        ("hd48", *hd_case(2, 3, 45, 77, 48)),
        ("hd128", *hd_case(2, 2, 33, 91, 128)),
    ]
    worst, failed = 0.0, []
    for name, (q, k, v), m in cases:
        out = attention.flash_attention(q, k, v, m)
        ref = attention.reference_attention(q, k, v, m)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        dead = m.amax(-1) == 0                       # (B,T) rows with no key
        dead_zero = bool((out.permute(0, 2, 1, 3)[dead] == 0).all().item())
        ok = (bool(torch.isfinite(out).all().item()) and dead_zero and
              torch.allclose(out, ref, atol=ATTN_ATOL, rtol=ATTN_RTOL))
        worst = max(worst, err)
        log("attn_kernel_vs_plain", case=name, shape=tuple(q.shape),
            S=k.shape[2], max_abs_err=err, dead_rows=int(dead.sum()),
            dead_rows_zero=dead_zero,
            plan=json.dumps(attention.launch_plan(*q.shape[:3], q.shape[3])),
            result="pass" if ok else "FAIL")
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"attention kernel disagrees with plain in {failed}")
    # registers and spills (ptxas) and dynamic shared memory per instance
    ptxas = {instance(k): v for k, v in attention.build_info["ptxas"].items()}
    for hd in (16, 32, 64, 128):
        for B, T in ((1, 16), (4096, 64)):      # the split and wide shapes
            pl = attention.launch_plan(B, 1, T, hd)
            key = ",".join(str(pl[f]) for f in (
                "instance_hd", "query_tiles_per_block", "key_partitions",
                "keys_per_partition"))
            log("attn_instance", instance=key, smem_bytes=pl["smem_bytes"],
                threads=pl["threads"], ptxas=json.dumps(ptxas.get(key)))

    # --- the serving path: 12 frames, 9 fill the window, 3 decided ------------
    scene = SceneSensor(input_size=SIZE, device=dev, generator=gen)  # YOLOv4
    ctrl = AttentionController(AttnCtrlConfig(num_actions=317), device=dev,
                               generator=gen)
    scfg = ServiceConfig(trigger_threshold=0.0, wakeup_cooldown_s=0.0,
                         near_field_frac=0.0)
    frames = rng.random((FRAMES, SIZE, SIZE, 3), dtype=np.float32)

    def new_service():
        g = torch.Generator(dev)
        g.manual_seed(2)
        return ProactiveGreetingService(scfg, scene, ctrl, generator=g,
                                        device=dev)

    def serve(svc):
        """Decisions and per-stage ms (detect and attend)."""
        times = {"detect": [], "attend": []}
        for stage in ("detect", "attend"):
            fn = getattr(svc, "_" + stage)

            def stage_timed(*a, fn=fn, stage=stage):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                times[stage].append(1e3 * (time.perf_counter() - t))
                return out

            setattr(svc, "_" + stage, stage_timed)
        return [svc.process_frame(img) for img in frames], times

    serve(new_service())                # warm-up: cuDNN, cuBLAS, allocator
    torch.cuda.synchronize()
    attention.flash_attention.launches = 0
    decisions, times = serve(new_service())
    torch.cuda.synchronize()
    launches = attention.flash_attention.launches
    decided = decisions[F_ - 1:]
    scores = [d.get("trigger_score", float("nan")) for d in decided]
    p50 = {k: float(np.median(v)) for k, v in times.items()}
    log("serve", frames=FRAMES, decided=len(decided), kernel_launches=launches,
        trigger_scores=json.dumps(scores),
        triggered=sum(bool(d["triggered"]) for d in decisions),
        action_ids=json.dumps([d.get("action_id") for d in decided]),
        p50_detect_ms=round(p50["detect"], 3),
        p50_attend_ms=round(p50["attend"], 3), card=repr(card))
    if launches != 6 * len(decided) or launches != 18:
        raise RuntimeError(f"{launches} attention launches for "
                           f"{len(decided)} decided frames, expected 18")
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"non-finite trigger scores {scores}")

    # steady state: once the window is full every frame detects and
    # attends; frames/s is all of them over the run's wall time, and each
    # frame's latency ends in the decision's read-back to the host. The
    # stages are timed on the host clock with no synchronize: the time to
    # dispatch them; the rest of a frame is the image copy, the window
    # stack, the wait for the card and sampling
    svc = new_service()
    for img in frames[:F_]:
        svc.process_frame(img)
    steady = rng.random((STEADY_FRAMES, SIZE, SIZE, 3), dtype=np.float32)
    host = {"detect": [], "attend": []}
    for stage in host:
        def host_timed(*a, fn=getattr(svc, "_" + stage), stage=stage):
            t = time.perf_counter()
            out = fn(*a)
            host[stage].append(1e3 * (time.perf_counter() - t))
            return out

        setattr(svc, "_" + stage, host_timed)
    lat, steady_scores = [], []
    attention.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for img in steady:
        t = time.perf_counter()
        steady_scores.append(svc.process_frame(img).get("trigger_score",
                                                        float("nan")))
        lat.append(1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t0
    steady_launches = attention.flash_attention.launches
    log("serve_steady", frames=STEADY_FRAMES, seconds=round(wall, 4),
        frames_per_s=round(STEADY_FRAMES / wall, 3),
        p50_frame_ms=round(float(np.percentile(lat, 50)), 3),
        p99_frame_ms=round(float(np.percentile(lat, 99)), 3),
        max_frame_ms=round(max(lat), 3),
        p50_host_detect_ms=round(float(np.median(host["detect"])), 3),
        p50_host_attend_ms=round(float(np.median(host["attend"])), 3),
        frames_over_2x_p50=int(sum(x > 2 * np.median(lat) for x in lat)),
        kernel_launches=steady_launches, card=repr(card))
    if steady_launches != 6 * STEADY_FRAMES:
        raise RuntimeError(f"{steady_launches} attention launches for "
                           f"{STEADY_FRAMES} decided frames")
    if not all(np.isfinite(steady_scores)):
        raise RuntimeError("a steady-state frame was not decided")

    # where a decided frame's time goes on the card (torch.profiler)
    svc = new_service()
    img = torch.as_tensor(frames[0], device=dev)[None]
    inst = svc._detect(img)
    win = (inst.tokens.repeat(1, F_, 1), svc._frame_ids,
           inst.valid.repeat(1, F_).to(torch.float32))
    for stage, fn in (("detect", lambda: svc._detect(img)),
                      ("attend", lambda: svc._attend(*win))):
        prof = profiler.device_breakdown(fn, reps=5)
        log("serve_profile", stage=stage,
            **{k: (json.dumps(v) if k == "top" else round(v, 4))
               for k, v in prof.items()})

    # --- the same frames through the plain attention on the card ---------------
    orig = attention.flash_attention
    attention.flash_attention = attention.reference_attention
    try:
        plain_decisions, _ = serve(new_service())
    finally:
        attention.flash_attention = orig
    d_score, same = 0.0, True
    for a, b in zip(decisions, plain_decisions):
        same &= a.get("reason") == b.get("reason")
        same &= a["triggered"] == b["triggered"]
        if "trigger_score" in a:
            d_score = max(d_score, abs(a["trigger_score"] - b["trigger_score"]))
        if a["triggered"] and b["triggered"]:
            same &= bool(np.allclose(a["target_bbox"], b["target_bbox"],
                                     atol=SERVE_TOL))
    log("serve_vs_plain", max_abs_diff_trigger_score=d_score,
        reasons_and_targets_equal=same,
        action_ids_equal=[a.get("action_id") for a in decisions] ==
        [b.get("action_id") for b in plain_decisions])
    if d_score > SERVE_TOL or not same:
        raise RuntimeError("serving through the kernel disagrees with the "
                           "plain attention")

    # --- offline batch scorer at 64 windows ------------------------------------
    ev = OfflineEvaluator(new_service())
    windows = rng.standard_normal((N_WINDOWS, F_, K_, 562)).astype(np.float32)
    valid = rng.random((N_WINDOWS, F_, K_)) > 0.3
    s_kernel = ev.score_windows(windows, valid)
    torch.cuda.synchronize()
    t = time.perf_counter()
    reps = 5
    for _ in range(reps):
        ev.score_windows(windows, valid)
    torch.cuda.synchronize()
    sw_ms = 1e3 * (time.perf_counter() - t) / reps
    attention.flash_attention = attention.reference_attention
    try:
        s_plain = ev.score_windows(windows, valid)
    finally:
        attention.flash_attention = orig
    d_sw = float(np.abs(s_kernel - s_plain).max())
    log("score_windows", N=N_WINDOWS, ms_per_call=round(sw_ms, 3),
        windows_per_s=round(N_WINDOWS * 1e3 / sw_ms, 1),
        max_abs_diff_vs_plain=d_sw, finite=bool(np.isfinite(s_kernel).all()),
        card=repr(card))
    if d_sw > SERVE_TOL or not np.isfinite(s_kernel).all():
        raise RuntimeError("score_windows through the kernel disagrees with "
                           "the plain attention")

    # --- kernel time beside its bound, the plain version and SDPA ---------------
    def sdpa(q, k, v, m):
        """The library yardstick: additive float mask, then fully masked
        rows zeroed (SDPA averages them uniformly)."""
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=(-1e10 * (1.0 - m))[:, None])
        return out * (m.amax(-1) > 0).to(q.dtype)[:, None, :, None]

    entry = None
    for name, (q, k, v), m in (cases[0], cases[4]):
        B, H, T, hd = q.shape
        S = k.shape[2]
        kern = lambda: attention.flash_attention(q, k, v, m)
        plain = lambda: attention.reference_attention(q, k, v, m)
        lib = lambda: sdpa(q, k, v, m)
        lib_err = (lib() - plain()).abs().max().item()
        ms = [timed(kern, 100, 10), timed(plain, 100, 10), timed(lib, 100, 10),
              timed(lib, 100, 0), timed(plain, 100, 0), timed(kern, 100, 0)]
        kernel_ms, plain_ms = min(ms[0], ms[5]), min(ms[1], ms[4])
        lib_ms = min(ms[2], ms[3])
        dev_ms = {n: profiler.device_breakdown(f, reps=20)
                  for n, f in (("kernel", kern), ("plain", plain),
                               ("sdpa", lib))}
        # per launch over the launches the profiler caught (it can drop
        # one at the window's edge)
        kernel_dev = (dev_ms["kernel"]["device_ms_per_call"]
                      / max(dev_ms["kernel"]["kernels_per_call"], 1e-9))
        bd = attn_bound(B, H, T, S, hd)
        log("attn_kernel_time", case=name, B=B, H=H, T=T, S=S, hd=hd,
            kernel_ms=round(kernel_ms, 5), plain_ms=round(plain_ms, 5),
            sdpa_ms=round(lib_ms, 5), sdpa_max_abs_err_vs_plain=lib_err,
            **{f"{n}_device_ms": round(d["device_ms_per_call"], 5)
               for n, d in dev_ms.items()},
            kernel_device_ms_per_launch=round(kernel_dev, 5),
            **{f"{n}_kernels": d["kernels_per_call"]
               for n, d in dev_ms.items()},
            flops=bd["flops"], bytes=bd["bytes"],
            **{k_: round(bd[k_], 6) for k_ in (
                "bound_bytes_ms", "bound_ops_fp32_ms", "bound_ops_tc_ms",
                "bound_ms")},
            bound_by=bd["bound_by"],
            bound_share_events=round(bd["bound_ms"] / kernel_ms, 4),
            bound_share_device=round(bd["bound_ms"] / kernel_dev, 4),
            plan=json.dumps(attention.launch_plan(B, H, T, hd)),
            card=repr(card))
        if entry is None:               # the serving shape goes in the line
            entry = {
                "name": "flash_attention",
                "route": "cuda",
                "source": "paddlerobotics_torch/ops/csrc/attention.cu",
                "replaces": "paddlerobotics_tpu/ops/pallas/attention.py:61",
                "launches": launches,
                "max_abs_err": worst,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bd["bound_ms"],
                "bound_by": bd["bound_by"],
                "library_ms": lib_ms,
                "device_ms": kernel_dev,
                "plain_device_ms": dev_ms["plain"]["device_ms_per_call"],
                "library_device_ms": dev_ms["sdpa"]["device_ms_per_call"],
            }

    # --- the wrapper's host cost at the serving shape ---------------------------
    # HOST_CALLS calls with no synchronize in between: host µs per call
    # (checks, output allocation, ctypes call, launch) beside the CUDA-event
    # ms per call over the same calls, and the checks alone
    (q, k, v), m = cases[0][1], cases[0][2]
    attention.flash_attention(q, k, v, m)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        attention.flash_attention(q, k, v, m)
    host_us = 1e6 * (time.perf_counter() - t) / HOST_CALLS
    ev[1].record()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        attention.launch_args(q, k, v, m)
    args_us = 1e6 * (time.perf_counter() - t) / HOST_CALLS
    log("attn_host", case=cases[0][0], calls=HOST_CALLS,
        host_us_per_call=round(host_us, 3),
        launch_args_us_per_call=round(args_us, 3),
        event_ms_per_call=round(ev[0].elapsed_time(ev[1]) / HOST_CALLS, 5),
        card=repr(card))
    return entry, scene


def _auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the ROC curve by ranks (ties broken by order)."""
    o = np.argsort(scores)
    r = np.empty(len(scores), float)
    r[o] = np.arange(len(scores))
    npos, nneg = labels.sum(), (1 - labels).sum()
    return float((r[labels > 0.5].sum() - npos * (npos - 1) / 2)
                 / (npos * nneg))


def hri_train_phases(dev, card, scene) -> dict:
    """The HRI attention controller's training path at the CLI's full width:
    ``AttentionTrainer.train_step`` on ``generate_windows_device`` windows,
    scored by ``eval_step`` on held-out numpy windows (``[hri_train]``);
    the trained weights through the kernel and through the plain attention
    (``[hri_eval_vs_plain]``); checkpoint resume (``[hri_train_resume]``);
    the five-variant ablation fleet (``[hri_fleet]``); checkpoint →
    ``cli.export_hri_model`` → ``load_bundle`` → the service with the
    YOLOv4 sensor (``[hri_bundle]``). Returns the attention launches of
    training, scoring and the bundle's service."""
    import shutil

    from paddlerobotics_torch.cli import export_hri_model, parallel_train_attn
    from paddlerobotics_torch.hri import export, synthetic_scene
    from paddlerobotics_torch.hri.attention_ctrl import AttnCtrlConfig
    from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                                  ServiceConfig)
    from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                          to_device)
    from paddlerobotics_torch.ops import attention
    from paddlerobotics_torch.train import checkpoints
    from paddlerobotics_torch.utils import profiler

    out_root = ROOT / "build" / "chip_smoke" / "hri"
    shutil.rmtree(out_root, ignore_errors=True)
    cfg = AttnCtrlConfig(num_actions=317)
    trainer = AttentionTrainer(cfg, lr=HRI_LR, weight_decay=HRI_L2,
                               device=dev)

    def seeded(seed):
        g = torch.Generator(dev)
        g.manual_seed(seed)
        return g

    @torch.no_grad()
    def outputs(model, batch, use_kernel):
        return model(trainer._tokens(batch), batch["frame_ids"],
                     batch["padding_mask"], use_kernel=use_kernel)

    protos = synthetic_scene.device_prototypes(cfg, device=dev)
    heldout = to_device(synthetic_scene.generate_windows(
        np.random.RandomState(0), HRI_HELDOUT, cfg), dev)

    # --- warm-up and profile on a throwaway state ----------------------------
    warm = trainer.init(seeded(10))
    wgen = seeded(11)
    batch = synthetic_scene.generate_windows_device(wgen, HRI_BATCH, cfg,
                                                    protos, device=dev)
    for _ in range(HRI_WARMUP_STEPS):
        trainer.train_step(warm, batch)
    torch.cuda.synchronize()
    prof = profiler.device_breakdown(lambda: trainer.train_step(warm, batch),
                                     reps=5)
    gen_prof = profiler.device_breakdown(
        lambda: synthetic_scene.generate_windows_device(
            wgen, HRI_BATCH, cfg, protos, device=dev), reps=5)

    # --- 200 steps on the card's own windows ----------------------------------
    state = trainer.init(seeded(0))
    gen = seeded(1)
    losses, host_ms = [], []
    attention.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HRI_TRAIN_STEPS):
        t = time.perf_counter()
        b = synthetic_scene.generate_windows_device(gen, HRI_BATCH, cfg,
                                                    protos, device=dev)
        aux = trainer.train_step(state, b)
        host_ms.append(1e3 * (time.perf_counter() - t))
        losses.append(torch.stack([aux["loss"], aux["trigger_loss"]]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = attention.flash_attention.launches
    losses = torch.stack(losses).cpu().numpy()
    w = HRI_LOSS_WINDOW
    first, last = losses[:w].mean(0), losses[-w:].mean(0)

    attention.flash_attention.launches = 0
    metrics = trainer.eval_step(state, heldout)
    metrics = {k: float(v) for k, v in metrics.items()}
    eval_launches = attention.flash_attention.launches
    kern = outputs(state.model, heldout, use_kernel=True)
    labels = heldout["has_act"].cpu().numpy().ravel()
    auc = _auc(torch.sigmoid(kern["trigger_logits"]).cpu().numpy().ravel(),
               labels)
    log("hri_train", steps=HRI_TRAIN_STEPS, batch=HRI_BATCH,
        seconds=round(wall, 4),
        steps_per_s=round(HRI_TRAIN_STEPS / wall, 3),
        windows_per_s=round(HRI_TRAIN_STEPS * HRI_BATCH / wall, 1),
        p50_host_ms_per_step=round(float(np.median(host_ms)), 3),
        step_device_ms=round(prof["device_ms_per_call"], 4),
        step_kernels=prof["kernels_per_call"],
        step_wall_ms=round(prof["wall_ms_per_call"], 3),
        step_device_busy=round(prof["device_busy_share"], 4),
        step_top=json.dumps(prof["top"]),
        windows_device_ms=round(gen_prof["device_ms_per_call"], 4),
        windows_kernels=gen_prof["kernels_per_call"],
        loss_first=round(float(first[0]), 5), loss_last=round(float(last[0]),
                                                               5),
        trigger_loss_first=round(float(first[1]), 5),
        trigger_loss_last=round(float(last[1]), 5),
        heldout=HRI_HELDOUT, trigger_auc=round(auc, 4),
        trigger_acc=round(metrics["trigger_acc"], 4),
        act_acc=round(metrics["act_acc"], 4),
        positive_rate=round(float(labels.mean()), 4),
        train_launches=train_launches, eval_launches=eval_launches,
        card=repr(card))
    if train_launches != 0:
        raise RuntimeError(f"{train_launches} attention launches in "
                           "train_step: training must run the plain attention")
    blocks = cfg.num_decoder_blocks         # one launch per block: 6
    if eval_launches != blocks:
        raise RuntimeError(f"{eval_launches} attention launches in one "
                           f"eval_step, expected {blocks}")
    if not np.isfinite(losses).all() or not last[0] < first[0]:
        raise RuntimeError(f"training loss not finite and decreasing: "
                           f"first {first[0]}, last {last[0]}")

    # --- the trained weights through the kernel and the plain attention -------
    plain = outputs(state.model, heldout, use_kernel=False)
    diffs, ok = {}, True
    for k in ("trigger_logits", "obj_logits", "act_logits"):
        diffs[k] = (kern[k] - plain[k]).abs().max().item()
        ok &= bool(torch.isfinite(kern[k]).all().item()) and torch.allclose(
            kern[k], plain[k], atol=SERVE_TOL, rtol=SERVE_TOL)
    log("hri_eval_vs_plain", windows=HRI_HELDOUT, tol=SERVE_TOL,
        **{f"max_abs_diff_{k}": v for k, v in diffs.items()},
        max_abs_act_logit=round(plain["act_logits"].abs().max().item(), 3),
        result="pass" if ok else "FAIL")
    if not ok:
        raise RuntimeError("the trained controller through the kernel "
                           "disagrees with the plain attention")

    # --- resume: 10 steps, save, restore into a fresh trainer, 10 more --------
    rgen = seeded(2)
    batches = [synthetic_scene.generate_windows_device(
        rgen, HRI_BATCH, cfg, protos, device=dev)
        for _ in range(2 * HRI_RESUME_STEPS)]
    whole = trainer.init(seeded(3))
    part = trainer.init(seeded(3))
    for b in batches:
        trainer.train_step(whole, b)
    for b in batches[:HRI_RESUME_STEPS]:
        trainer.train_step(part, b)
    ck = checkpoints.save_attn(str(out_root / "resume"), part)
    resumed = trainer.init(seeded(4))
    checkpoints.load_attn_state(resumed,
                                checkpoints.restore(ck, device=dev)["attn"])
    for b in batches[HRI_RESUME_STEPS:]:
        trainer.train_step(resumed, b)
    torch.cuda.synchronize()
    d_w = max((p - q).abs().max().item() for p, q in zip(
        whole.model.parameters(), resumed.model.parameters()))
    adam_steps = {float(resumed.opt.state[p]["step"])
                  for p in resumed.model.parameters()}
    log("hri_train_resume", steps=f"{HRI_RESUME_STEPS}+{HRI_RESUME_STEPS}",
        checkpoint=pathlib.Path(ck).name, max_abs_weight_diff=d_w,
        tol=HRI_RESUME_TOL, step=resumed.step, whole_step=whole.step,
        adam_steps=json.dumps(sorted(adam_steps)))
    if d_w > HRI_RESUME_TOL or resumed.step != whole.step or \
            adam_steps != {float(whole.step)}:
        raise RuntimeError("the resumed training differs from the "
                           "uninterrupted one")
    del whole, part, resumed, batches, warm

    # --- the five-variant ablation fleet at full width ------------------------
    attention.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = parallel_train_attn.main([
        "--variants", ",".join(parallel_train_attn.VARIANTS),
        "--synthetic", str(HRI_FLEET_BATCHES), "--epochs", "1",
        "--outdir", str(out_root / "fleet"), "--device", "cuda"])
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    fleet_ok = attention.flash_attention.launches == 0
    for name, v in fleet.items():
        fleet_ok &= v["state"].step == HRI_FLEET_BATCHES and (
            out_root / "fleet" / name / f"itr_{HRI_FLEET_BATCHES}.pt").exists()
        fleet_ok &= all(bool(torch.isfinite(p).all().item())
                        for p in v["state"].model.parameters())
    log("hri_fleet", variants=json.dumps(list(fleet)),
        steps=HRI_FLEET_BATCHES, seconds=round(fleet_s, 3),
        host_seconds=json.dumps({k: round(v["seconds"], 3)
                                 for k, v in fleet.items()}),
        launches=attention.flash_attention.launches,
        result="pass" if fleet_ok else "FAIL", card=repr(card))
    if not fleet_ok or list(fleet) != list(parallel_train_attn.VARIANTS):
        raise RuntimeError("the ablation fleet did not train every variant")
    del fleet

    # --- checkpoint → export → bundle → the service ---------------------------
    ck = checkpoints.save_attn(str(out_root / "train"), state)
    bundle_dir = out_root / "bundle"
    export_hri_model.main(["--ckpt", ck, "--out", str(bundle_dir)])
    bundle = export.load_bundle(str(bundle_dir), device=dev)
    one = {k: v[:1] for k, v in heldout.items()}
    a = outputs(state.model, one, use_kernel=True)
    b = outputs(bundle.ctrl, one, use_kernel=True)
    d_bundle = max((a[k] - b[k]).abs().max().item() for k in (
        "trigger_logits", "obj_logits", "act_logits"))
    g = seeded(5)
    svc = ProactiveGreetingService(
        ServiceConfig(trigger_threshold=0.0, wakeup_cooldown_s=0.0,
                      near_field_frac=0.0), scene, bundle.ctrl,
        generator=g, device=dev)
    frames = np.random.default_rng(7).random(
        (HRI_BUNDLE_FRAMES + 9, SIZE, SIZE, 3), dtype=np.float32)
    attention.flash_attention.launches = 0
    decisions = [svc.process_frame(f) for f in frames]
    torch.cuda.synchronize()
    bundle_launches = attention.flash_attention.launches
    decided = [d for d in decisions if "trigger_score" in d]
    scores = [d["trigger_score"] for d in decided]
    log("hri_bundle", checkpoint=pathlib.Path(ck).name,
        format=bundle.manifest["format"], max_abs_diff_vs_trained=d_bundle,
        frames=len(frames), decided=len(decided),
        triggered=sum(bool(d["triggered"]) for d in decided),
        launches=bundle_launches,
        trigger_scores=json.dumps([round(x, 4) for x in scores[:5]]),
        card=repr(card))
    if d_bundle != 0.0:
        raise RuntimeError(f"the bundle's controller is {d_bundle} apart from "
                           "the trained module")
    if len(decided) != HRI_BUNDLE_FRAMES or \
            bundle_launches != blocks * HRI_BUNDLE_FRAMES or \
            not all(np.isfinite(scores)):
        raise RuntimeError(f"{bundle_launches} attention launches for "
                           f"{len(decided)} decided frames through the "
                           f"bundle, expected {blocks * HRI_BUNDLE_FRAMES}")
    return {"hri_train_launches": train_launches,
            "hri_eval_launches": eval_launches,
            "hri_bundle_launches": bundle_launches}


def track_match_bound(T: int, D: int, scans: int, solves: int) -> dict:
    """Least time of one matching step on the card (ms): the two (T, D)
    cost matrices, status, age and the detection mask read once and the
    assignment and matched mask written once, at the HBM rate; and the
    plain version's arithmetic on these inputs at the FP32 peak: per
    Dijkstra scan 8 per column of the n = max(T, D) square (three adds, a
    compare, three selects, the argmin's compare), per solve the gating
    (a min and a select per entry) and the dual updates (5 per row)."""
    n = max(T, D)
    n_bytes = 4 * (2 * T * D + 2 * T) + D + 4 * T + D
    ops = scans * 8 * n + solves * (2 * n * n + 5 * n)
    b_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_FP32_FLOPS * 1e3
    return {"bytes": n_bytes, "ops": ops, "bound_bytes_ms": b_bytes,
            "bound_ops_ms": b_ops, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def match_cases(rng, n_cases: int):
    """Seeded matching steps for ``[track_match_vs_plain]``: (name, cost1,
    iou_cost, status, tsu, det_valid, max_cosine_distance) as numpy, T and
    D from 1 to 32, in six kinds: random costs with gated entries, exact
    ties, costs at the threshold and at the clip constant, no eligible row,
    no eligible column, and full square problems without gates (held
    against scipy)."""
    from paddlerobotics_torch.hri import tracker as trk
    from paddlerobotics_torch.ops import lap

    kinds = ("random", "ties", "at_clip", "no_rows", "no_cols", "no_gates")
    out = []
    for i in range(n_cases):
        kind = kinds[i % len(kinds)]
        T, D = (int(x) for x in rng.integers(1, lap.MAX_N + 1, 2))
        max_cos = (0.2, 0.3)[i % 2]
        cost1 = rng.uniform(0.0, 2 * max_cos, (T, D))
        cost1[rng.random((T, D)) < 0.15] = trk.INF
        iou = rng.uniform(0.0, 1.0, (T, D))
        status = rng.integers(0, 3, T)
        tsu = rng.integers(0, 6, T)
        valid = rng.random(D) < 0.8
        if kind == "ties":
            cost1 = rng.choice([0.0, 0.1, 0.2, max_cos], (T, D))
            iou = rng.choice([0.3, 0.6, 0.7, 1.0], (T, D))
        elif kind == "at_clip":
            clip = np.float32(lap.clip_value(max_cos))
            cost1 = rng.choice([max_cos, clip, np.nextafter(
                clip, np.float32(1.0)), 0.5 * max_cos], (T, D))
            iou = rng.choice([0.7, np.float32(lap.clip_value(0.7)), 0.2],
                             (T, D))
        elif kind == "no_rows":
            status = np.zeros(T, int)
        elif kind == "no_cols":
            valid = np.zeros(D, bool)
        elif kind == "no_gates":
            D = min(D, T)
            cost1 = rng.uniform(0.0, max_cos, (T, D))
            iou = rng.uniform(0.0, 1.0, (T, D))
            status = np.full(T, trk.CONFIRMED)
            tsu = np.ones(T, int)
            valid = np.ones(D, bool)
        out.append((kind, cost1.astype(np.float32), iou.astype(np.float32),
                    status.astype(np.int32), tsu.astype(np.int32), valid,
                    max_cos))
    return out


def walker_clip(dev, frames: int, n: int, D: int, seed: int):
    """A synthetic clip for ``[track]``: n rectangles walking at constant
    velocity (stopped at the edges) over a noisy 360×640 background (uint8 RGB (frames,360,640,3)
    on the card), each with a fixed seeded 128-d appearance; per frame its
    boxes with 1.5 px of noise and the features with 5% noise, as the
    tracker's (D,4), (D,128), (D,) inputs."""
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


def hri_track_phases(dev, card) -> dict:
    """The HRI tracking and transport stack at full width: the YOLOv3 scene
    sensor serving the 317-action controller (``[yolov3]``), a cfg-built
    Darknet sensor and its ``.weights`` round trip (``[darknet]``), the
    re-ID encoder (``[reid]``), the matching kernel against its plain
    version (``[track_match_vs_plain]``), the tracker and
    ``cli.collect_data.track_frames`` on a 100-frame clip through the kernel
    and through the plain matching (``[track]``), and ``cli.serve_grpc``'s
    transport-free handlers on the reference's wire messages
    (``[serve_grpc]``). Returns the ``track_match`` entry of the
    ``kernels`` line and the attention launches of these phases."""
    import shutil

    from scipy.optimize import linear_sum_assignment

    from paddlerobotics_torch.cli import collect_data, serve_grpc
    from paddlerobotics_torch.hri import export, tracker as trk
    from paddlerobotics_torch.hri import grpc_transport as gt
    from paddlerobotics_torch.hri import pg_proto as pb
    from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                         AttnCtrlConfig)
    from paddlerobotics_torch.hri.perception import darknet
    from paddlerobotics_torch.hri.perception.reid import MarsSmall128
    from paddlerobotics_torch.hri.perception.scene import (DarknetSceneSensor,
                                                           SceneSensor)
    from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                                  ServiceConfig)
    from paddlerobotics_torch.hri.utils import letterbox_image
    from paddlerobotics_torch.ops import attention, lap
    from paddlerobotics_torch.utils import profiler

    out_root = ROOT / "build" / "chip_smoke" / "track"
    shutil.rmtree(out_root, ignore_errors=True)
    rng = np.random.default_rng(8)

    def seeded(seed):
        g = torch.Generator(dev)
        g.manual_seed(seed)
        return g

    def host_ms(fn, reps):
        """Median host ms per call with no synchronize: dispatch time."""
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        return float(np.median(ts))

    # --- [yolov3]: the YOLOv3 sensor serving the 317-action controller -------
    scene3 = SceneSensor(input_size=SIZE, arch="yolov3", device=dev,
                         generator=seeded(20))
    ctrl = AttentionController(AttnCtrlConfig(num_actions=317), device=dev,
                               generator=seeded(21))
    scfg = ServiceConfig(trigger_threshold=0.0, wakeup_cooldown_s=0.0,
                         near_field_frac=0.0)
    frames = rng.random((FRAMES, SIZE, SIZE, 3), dtype=np.float32)
    img = torch.as_tensor(frames[0], device=dev)[None]
    inst = scene3.get_instances_with_feats(img)            # warm-up
    svc = ProactiveGreetingService(scfg, scene3, ctrl, generator=seeded(22),
                                   device=dev)
    attention.flash_attention.launches = 0
    decisions = [svc.process_frame(f) for f in frames]
    torch.cuda.synchronize()
    v3_launches = attention.flash_attention.launches
    decided = [d for d in decisions if "trigger_score" in d]
    detect = lambda: scene3.get_instances_with_feats(img)
    prof = profiler.device_breakdown(detect, reps=5)
    v3_host = host_ms(detect, 5)
    ok = (tuple(inst.tokens.shape) == (1, 20, 562) and
          bool(torch.isfinite(inst.tokens).all().item()) and
          v3_launches == 6 * len(decided) == 18 and
          all(np.isfinite(d["trigger_score"]) for d in decided))
    log("yolov3", frames=FRAMES, decided=len(decided), launches=v3_launches,
        detections=int(inst.valid.sum()), fm=json.dumps(
            list(scene3.model(img.permute(0, 3, 1, 2))[1].shape)),
        detect_device_ms=round(prof["device_ms_per_call"], 4),
        detect_kernels=prof["kernels_per_call"],
        detect_wall_ms=round(prof["wall_ms_per_call"], 3),
        detect_host_ms=round(v3_host, 3),
        detect_busy=round(prof["device_busy_share"], 4),
        top=json.dumps(prof["top"]),
        trigger_scores=json.dumps([round(d["trigger_score"], 4)
                                   for d in decided]),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the YOLOv3 sensor's service failed its checks")

    # --- [darknet]: a cfg-built sensor, .weights out and back in -------------
    sections = darknet.parse_cfg(DARKNET_CFG)
    dn = DarknetSceneSensor(sections, device=dev, generator=seeded(23))
    with torch.no_grad():                       # BatchNorm statistics too
        for m in dn.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.weight, m.running_var):
                    t.uniform_(0.5, 1.5, generator=seeded(24))
                for t in (m.bias, m.running_mean):
                    t.normal_(0.0, 0.1, generator=seeded(25))
    blob = darknet.save_darknet_weights(dn.model, sections)
    dn2 = DarknetSceneSensor(sections, device=dev, generator=seeded(26))
    darknet.load_darknet_weights(dn2.model, sections, blob)
    a = dn.get_instances_with_feats(img)
    b = dn2.get_instances_with_feats(img)
    d_dn = max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))
    n_floats = (len(blob) - 20) // 4
    per_conv = sum(getattr(dn.model, f"conv{li}").weight.numel()
                   + getattr(dn.model, f"conv{li}").out_channels *
                   (4 if bn else 1) for li, bn in darknet._conv_layers(
                       sections))
    dprof = profiler.device_breakdown(lambda: dn.get_instances_with_feats(
        img), reps=5)
    ok = (d_dn == 0.0 and n_floats == per_conv and
          tuple(a.tokens.shape) == (1, 20, 562) and
          bool(torch.isfinite(a.tokens).all().item()))
    log("darknet", sections=len(sections), convs=len(list(
        darknet._conv_layers(sections))), fm_layer=dn.fm_layer,
        heads=len(dn.metas), blob_bytes=len(blob), floats=n_floats,
        floats_by_conv=per_conv, max_abs_diff_after_load=d_dn,
        detections=int(a.valid.sum()),
        detect_device_ms=round(dprof["device_ms_per_call"], 4),
        detect_kernels=dprof["kernels_per_call"],
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the Darknet sensor's weights did not round-trip")

    # --- [reid]: 20 crops through MarsSmall128 --------------------------------
    reid = MarsSmall128(device=dev, generator=seeded(27))
    crops = torch.rand((20, 128, 64, 3), generator=seeded(28), device=dev)
    with torch.no_grad():
        feats = reid(crops)
        feats_cpu = MarsSmall128(device="cpu").eval()
        feats_cpu.load_state_dict({k: v.cpu()
                                   for k, v in reid.state_dict().items()})
        d_cpu = (feats.cpu() - feats_cpu(crops.cpu())).abs().max().item()
    norms = feats.norm(dim=-1)
    rprof = profiler.device_breakdown(lambda: reid(crops), reps=10)
    ok = (tuple(feats.shape) == (20, 128) and
          (norms - 1).abs().max().item() < 1e-5 and d_cpu < REID_TOL)
    log("reid", crops=20, max_norm_err=(norms - 1).abs().max().item(),
        max_abs_diff_vs_cpu=d_cpu, tol=REID_TOL,
        device_ms=round(rprof["device_ms_per_call"], 4),
        kernels=rprof["kernels_per_call"],
        wall_ms=round(rprof["wall_ms_per_call"], 3),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the re-ID encoder failed its checks")

    # --- [track_match_vs_plain]: the kernel against its plain version ---------
    failed, kinds, gaps = [], {}, []
    for name, c1, iou, st, ts, dv, mc in match_cases(rng, MATCH_CASES):
        host = [torch.as_tensor(x) for x in (c1, iou, st, ts, dv)]
        card_args = [x.to(dev) for x in host]
        work_k = torch.zeros(2, dtype=torch.int32, device=dev)
        work_p = torch.zeros(2, dtype=torch.int32)
        a_k, m_k = lap.track_match(*card_args, mc, work=work_k)
        a_p, m_p = lap.track_match_plain(*host, mc, work=work_p)
        same = (torch.equal(a_k.cpu(), a_p) and torch.equal(m_k.cpu(), m_p)
                and torch.equal(work_k.cpu(), work_p))
        if name == "no_gates":
            T = c1.shape[0]
            r, c = linear_sum_assignment(c1)
            a = a_k.cpu().numpy()
            ours = c1[np.arange(T)[a >= 0], a[a >= 0]].sum(dtype=np.float64)
            ref = c1[r, c].sum(dtype=np.float64)
            gaps.append(abs(ours - ref) / max(ref, 1e-30))
            same &= int((a >= 0).sum()) == len(r) and gaps[-1] <= COST_RTOL
        kinds.setdefault(name, [0, 0])[0] += 1
        kinds[name][1] += int(work_p[1])
        if not same:
            failed.append(name)
    torch.cuda.synchronize()
    log("track_match_vs_plain", cases=MATCH_CASES,
        kinds=json.dumps(kinds), equal=MATCH_CASES - len(failed),
        max_rel_cost_gap_vs_scipy=max(gaps), cost_rtol=COST_RTOL,
        result="pass" if not failed else "FAIL")
    if failed:
        raise RuntimeError(f"track_match disagrees with plain in {failed}")

    # --- [track]: the tracker, then track_frames, on a 100-frame clip -------
    clip, wboxes, wfeats, wvalid = walker_clip(dev, TRACK_FRAMES, 5, 20, 9)
    state = trk.init_tracker(dev)
    ids = []
    lap.track_match.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(TRACK_FRAMES):
        state = trk.tracker_predict(state)
        state, tid = trk.tracker_update(state, wboxes[f], wfeats[f],
                                        wvalid[f])
        ids.append(tid[:5])
    ids = torch.stack(ids).cpu().numpy()
    tracker_s = time.perf_counter() - t0
    tracker_launches = lap.track_match.launches
    stable = all(len(set(ids[4:, k])) == 1 and ids[-1, k] > 0
                 for k in range(5)) and len(set(ids[-1])) == 5

    def run_frames(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = collect_data.track_frames(clip[:n], scene3, reid)
        return logs, (time.perf_counter() - t) / n

    collect_data.track_frames(clip[:2], scene3, reid)         # warm-up
    lap.track_match.launches = 0
    logs_k, frame_s = run_frames(TRACK_FRAMES)
    frames_launches = lap.track_match.launches
    plain_host = lambda *a: tuple(t.to(dev) for t in lap.track_match_plain(
        *[x.cpu() for x in a[:5]], *a[5:8]))
    kernel_wrapper = lap.track_match
    lap.track_match = plain_host
    try:
        logs_p, plain_s = run_frames(TRACK_PLAIN_FRAMES)
    finally:
        lap.track_match = kernel_wrapper
    n_ids = len({k for tl, _ in logs_k for k in tl})
    logs_equal = logs_k[:TRACK_PLAIN_FRAMES] == logs_p
    ok = (stable and tracker_launches == TRACK_FRAMES and
          frames_launches == TRACK_FRAMES and logs_equal)
    log("track", frames=TRACK_FRAMES, hw=json.dumps(TRACK_HW), walkers=5,
        walker_ids=json.dumps(ids[-1].tolist()), walker_ids_stable=stable,
        tracker_ms_per_frame=round(1e3 * tracker_s / TRACK_FRAMES, 3),
        tracker_launches=tracker_launches,
        track_frames_ms_per_frame=round(1e3 * frame_s, 3),
        track_frames_launches=frames_launches,
        plain_frames=TRACK_PLAIN_FRAMES,
        plain_matching_ms_per_frame=round(1e3 * plain_s, 3),
        logs_equal=logs_equal, detections=sum(len(d) for _, d in logs_k),
        track_ids=n_ids, result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("tracking failed its checks (ids, launches or "
                           "kernel vs plain logs)")

    # the kernel's time at the tracker's shape, on the inputs of the
    # clip's seventh update
    st0 = trk.init_tracker(dev)
    for f in range(6):
        st0, _ = trk.tracker_update(trk.tracker_predict(st0), wboxes[f],
                                    wfeats[f], wvalid[f])
    captured = []
    lap.track_match = lambda *a: captured.append(a[:5]) or plain_host(*a)
    try:
        trk.tracker_update(trk.tracker_predict(st0), wboxes[6], wfeats[6],
                           wvalid[6])
    finally:
        lap.track_match = kernel_wrapper
    args = captured[0]
    work = torch.zeros(2, dtype=torch.int32, device=dev)
    lap.track_match(*args, work=work)
    scans, solves = (int(x) for x in work.cpu())
    kern = lambda: lap.track_match(*args)
    plain = lambda: lap.track_match_plain(*args)
    host_args = [x.cpu() for x in args]
    plain_cpu = lambda: lap.track_match_plain(*host_args)
    ms = [timed(kern, 200, 20), timed(plain, 3, 1), timed(plain, 3, 0),
          timed(kern, 200, 0)]
    kernel_ms, plain_ms = min(ms[0], ms[3]), min(ms[1], ms[2])
    t = time.perf_counter()
    for _ in range(10):
        plain_cpu()
    plain_cpu_ms = 1e3 * (time.perf_counter() - t) / 10
    kprof = profiler.device_breakdown(kern, reps=50, match="track_match")
    kernel_dev = (kprof["match_ms_per_call"]
                  / max(kprof["match_launches_per_call"], 1e-9))
    T, D = args[0].shape
    bd = track_match_bound(T, D, scans, solves)
    ptxas = {instance(k): v for k, v in lap.build_info["ptxas"].items()}
    log("track_match_time", T=T, D=D, scans=scans, solves=solves,
        kernel_ms=round(kernel_ms, 5),
        kernel_device_ms=round(kernel_dev, 5),
        plain_card_ms=round(plain_ms, 3), plain_cpu_ms=round(plain_cpu_ms, 3),
        bytes=bd["bytes"], ops=bd["ops"],
        bound_bytes_ms=bd["bound_bytes_ms"], bound_ops_ms=bd["bound_ops_ms"],
        bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
        us_per_scan=round(1e3 * kernel_dev / max(scans, 1), 4),
        ptxas=json.dumps(ptxas), card=repr(card))

    # --- [serve_grpc]: the handlers on the reference's wire messages ----------
    bundle_dir = out_root / "bundle"
    export.save_bundle(str(bundle_dir), ctrl.cfg, ctrl.state_dict(),
                       scene=scene3, extra={"trigger_threshold": 0.0})
    argv = ["--bundle", str(bundle_dir), "--device", dev.type]
    process, score_clip, _ = serve_grpc.build_services(
        serve_grpc.build_parser().parse_args(argv))
    greet = gt.greeting_handler(process, device=dev)
    evalh = gt.eval_handler(score_clip, device=dev)
    views = clip[:GRPC_FRAMES].flip(-1).cpu().numpy()      # uint8 BGR
    reqs = [pb.VideoRequest(req_id=i, cur_frame=v.tobytes()).encode()
            for i, v in enumerate(views)]
    attention.flash_attention.launches = 0
    lat, got = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        t = time.perf_counter()
        got.append(json.loads(pb.InferResponse.decode(greet(r)).response))
        lat.append(1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t0
    grpc_launches = attention.flash_attention.launches
    for i, d in enumerate(got):
        if d.pop("req_id") != i:
            raise RuntimeError("a response came back with another req_id")
    # the same frames letterboxed by hri/utils, into a service on the
    # modules the bundle was written from
    ref_cfg = ServiceConfig(num_frames=ctrl.cfg.num_frames,
                            tokens_per_frame=ctrl.cfg.tokens_per_frame,
                            trigger_threshold=0.0)
    lb = lambda v: letterbox_image(torch.as_tensor(
        np.ascontiguousarray(v[..., ::-1]), device=dev).to(torch.float32)
        / 255.0)
    ref_svc = ProactiveGreetingService(ref_cfg, scene3, ctrl, device=dev)
    want = [ref_svc.process_frame(lb(v)) for v in views]
    decided = sum("trigger_score" in d for d in got)
    stack = views[:GRPC_EVAL_FRAMES]
    attention.flash_attention.launches = 0
    ev = pb.EvalResponse.decode(evalh(pb.EvalRequest(
        nframe=len(stack), frames=stack.tobytes()).encode()))
    eval_launches = attention.flash_attention.launches
    eval_svc = ProactiveGreetingService(ref_cfg, scene3, ctrl, device=dev)
    last = [eval_svc.process_frame(lb(v)) for v in stack][-1]
    eval_same = (ev.trigger_pred == float(np.float32(last["trigger_score"]))
                 and json.loads(ev.response) == last)
    ok = (got == want and eval_same and
          grpc_launches == 6 * decided and decided == GRPC_FRAMES - 9 and
          eval_launches == 6)
    log("serve_grpc", arch="yolov3", frames=GRPC_FRAMES, view=json.dumps(
        list(views.shape[1:])), decided=decided, launches=grpc_launches,
        decisions_equal=got == want,
        triggered=sum(bool(d["triggered"]) for d in got),
        frames_per_s=round(GRPC_FRAMES / wall, 3),
        p50_ms=round(float(np.percentile(lat, 50)), 3),
        p99_ms=round(float(np.percentile(lat, 99)), 3),
        eval_frames=len(stack), eval_launches=eval_launches,
        eval_trigger_pred=ev.trigger_pred, eval_equal=eval_same,
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("serve_grpc's handlers disagree with the service "
                           "on letterboxed frames, or launched wrongly")

    entry = {
        "name": "track_match",
        "route": "cuda",
        "source": "paddlerobotics_torch/ops/csrc/track_match.cu",
        "replaces": "paddlerobotics_tpu/hri/tracker.py:196",
        "replaces_kind": "jitted XLA, no pallas_call",
        "launches": frames_launches,
        "max_abs_err": 0.0 if not failed else None,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"],
        "library_ms": None,
        "device_ms": kernel_dev,
        "plain_cpu_ms": plain_cpu_ms,
        "tracker_launches": tracker_launches,
    }
    return entry, {"yolov3_launches": v3_launches,
                   "serve_grpc_launches": grpc_launches,
                   "serve_grpc_eval_launches": eval_launches}


def native_phases(dev, card, lib: str) -> dict:
    """The native C++ serving runtime with the port's models on the card:
    ``NativeEvalServer`` on 10-frame requests against the same windows
    through the controller in process (``[native_eval]``), the
    ``stream_sync`` and ``stream_pipelined`` arms of ``cli.serving_bench``
    (``[native_stream]``), and ``NativeClipEvalServer`` with R(2+1)D-18
    against a direct model call on the clip C++ preprocessed
    (``[clip_eval]``). Each phase ends with the handle's ``check()``, which
    raises what a callback raised. Returns the attention launches."""
    from paddlerobotics_torch.cli import serving_bench
    from paddlerobotics_torch.hri.attention_ctrl import top_k_sampling
    from paddlerobotics_torch.hri.native_pipeline import (
        CLIP_LEN, CLIP_RES, NativeClipEvalServer, NativeEvalServer, overlap)
    from paddlerobotics_torch.hri.r2plus1d import R2Plus1D18
    from paddlerobotics_torch.hri.r2plus1d_train import (ClipScorer,
                                                         make_inference_fn)
    from paddlerobotics_torch.hri.stream_client import EvalStreamClient
    from paddlerobotics_torch.ops import attention
    from paddlerobotics_torch.utils import profiler

    num_act = 317
    svc, cbs = serving_bench.build_models(num_act, device=dev, seed=4)
    scene, ctrl = svc.scene, svc.ctrl
    rng = np.random.default_rng(4)
    frames = [rng.random((SIZE, SIZE, 3), dtype=np.float32)
              for _ in range(NATIVE_EVAL_FRAMES)]
    for f in frames + frames[:2]:                     # warm-up, window full
        svc.process_frame(f)
    cbs.detect(frames[0])

    # --- [native_eval]: the unary eval server against the controller ----------
    server = NativeEvalServer(cbs.detect, cbs.attend, num_act=num_act,
                              trigger_threshold=0.0, near_field_frac=0.0,
                              lib_path=lib)
    client = EvalStreamClient(port=server.port)
    fids = torch.arange(1, 11, device=dev).repeat_interleave(20)[None]
    worst, launches, lat, same_ids, triggered = 0.0, [], [], True, 0
    try:
        for r in range(NATIVE_EVAL_REQUESTS):
            req = frames[r:] + frames[:r]
            state = cbs.generator.get_state()
            attention.flash_attention.launches = 0
            t = time.perf_counter()
            out = client.infer(req)
            lat.append(1e3 * (time.perf_counter() - t))
            launches.append(attention.flash_attention.launches)
            got_acts = cbs.last["act_scores"]
            # the same window through the sensor and the controller here
            with torch.no_grad():
                inst = [scene.get_instances_with_feats(torch.as_tensor(
                    f, device=dev)[None]) for f in req]
                tok = torch.cat([i.tokens for i in inst]).reshape(1, 200, -1)
                pad = torch.cat([i.valid for i in inst]).reshape(
                    1, 200).to(torch.float32)
                o = ctrl({"visual_tokens": tok}, fids, pad, use_kernel=True)
                logits = o["act_logits"][:, -1:, :]
                g = torch.Generator(dev)
                g.set_state(state)
                ref_id = int(top_k_sampling(logits, 1.0, 5, generator=g)[0, 0])
                ref_trig = float(torch.sigmoid(o["trigger_logits"][0, -1]))
                ref_acts = torch.softmax(logits[0, 0], -1).cpu().numpy()
            # with no valid detection in the last frame C++ answers
            # no_target, and the response score stays 0
            resp = out["response"]
            want = ref_acts[ref_id] if resp["triggered"] else 0.0
            same_ids &= (resp.get("action_id", ref_id) == ref_id and
                         out["nullact_id"] == int(ref_acts.argmax()))
            triggered += bool(resp["triggered"])
            worst = max(worst, abs(out["trigger_pred"] - ref_trig),
                        abs(out["nullact_score"] - ref_acts[0]),
                        abs(out["response_score"] - want),
                        float(np.abs(got_acts - ref_acts).max()))
        server.check()
    finally:
        client.close()
        server.close()
    ok = (worst <= NATIVE_TOL and same_ids and
          launches == [6] * NATIVE_EVAL_REQUESTS)
    log("native_eval", requests=NATIVE_EVAL_REQUESTS,
        frames=NATIVE_EVAL_FRAMES, num_act=num_act,
        max_abs_diff=worst, tol=NATIVE_TOL, ids_equal=same_ids,
        triggered=triggered, launches=json.dumps(launches),
        ms_per_request=round(float(np.mean(lat)), 3),
        ms_p50=round(float(np.percentile(lat, 50)), 3),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the native eval server disagrees with the "
                           "controller in process, or launched wrongly")
    eval_launches = sum(launches)

    # --- [native_stream]: the serving bench's two stream arms -----------------
    pace_s = 1.5 * serving_bench.arm_model_sync(
        svc, frames, 12)["p50_ms"] / 1e3 + 0.05
    stream_launches, ok = {}, True
    for pipelined in (False, True):
        attention.flash_attention.launches = 0
        row = serving_bench.arm_stream(cbs, frames, NATIVE_STREAM_FRAMES,
                                       pipelined=pipelined, pace_s=pace_s,
                                       lib_path=lib)
        n_launch = attention.flash_attention.launches
        stream_launches[row["arm"]] = n_launch
        good = (n_launch == 6 * row["attend_calls"] and row["decisions"] > 0
                and row["attend_calls"] >= row["decisions"])
        ok &= good
        log("native_stream", arm=row["arm"], frames=NATIVE_STREAM_FRAMES,
            frames_per_s=round(row["fps"], 3),
            p50_ms=round(row["p50_ms"], 3), p99_ms=round(row["p99_ms"], 3),
            decisions=row["decisions"], dropped=row["dropped"],
            detect_calls=row["detect_calls"],
            attend_calls=row["attend_calls"], launches=n_launch,
            overlap_s=round(row["overlap_s"], 4),
            detect_s=round(row["detect_s"], 4),
            attend_s=round(row["attend_s"], 4),
            overlap_share_of_attend=round(
                row["overlap_s"] / max(row["attend_s"], 1e-9), 4),
            pace_s=round(pace_s, 4), result="pass" if good else "FAIL",
            card=repr(card))
    if not ok:
        raise RuntimeError("a stream arm's attention launches are not 6 per "
                           "decided frame")
    del svc, cbs, scene, ctrl

    # --- [clip_eval]: R(2+1)D-18 behind the native clip server ----------------
    g = torch.Generator(dev)
    g.manual_seed(5)
    model = R2Plus1D18(num_act, device=dev, generator=g).eval()
    scorer = ClipScorer(model, generator=torch.Generator(dev).manual_seed(6))
    seen = []

    def score(clip):
        out = scorer(clip)
        seen.append((clip, out[0]))
        return out

    scorer(np.zeros((CLIP_LEN, 3, CLIP_RES, CLIP_RES), np.float32))  # warm
    server = NativeClipEvalServer(score, num_act, lib_path=lib)
    client = EvalStreamClient(port=server.port)
    infer = make_inference_fn(model)
    worst, lat = 0.0, []
    try:
        for r in range(CLIP_REQUESTS):
            t = time.perf_counter()
            out = client.infer(frames[r:] + frames[:r])
            lat.append(1e3 * (time.perf_counter() - t))
            clip, probs = seen[-1]
            x = torch.as_tensor(clip, device=dev).permute(1, 0, 2, 3)[None]
            ref = infer(x, 1.0, 5, noise=torch.zeros(1, num_act,
                                                      device=dev))[0]
            ref = ref[0].cpu().numpy()
            worst = max(worst, float(np.abs(probs - ref).max()),
                        abs(out["nullact_score"] - ref[0]))
            if out["nullact_id"] != int(ref.argmax()):
                worst = float("inf")
        server.check()
    finally:
        client.close()
        server.close()
    prof = profiler.device_breakdown(torch.no_grad()(lambda: model(x)),
                                     reps=5)
    ok = worst <= CLIP_TOL and len(seen) == CLIP_REQUESTS
    log("clip_eval", model="r2plus1d_18", clip=json.dumps(list(x.shape)),
        num_act=num_act, requests=CLIP_REQUESTS, max_abs_diff=worst,
        tol=CLIP_TOL, ms_per_clip=round(float(np.mean(lat)), 3),
        ms_p50=round(float(np.percentile(lat, 50)), 3),
        device_ms=round(prof["device_ms_per_call"], 4),
        kernels=prof["kernels_per_call"], top=json.dumps(prof["top"][:3]),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the native clip server's scores disagree with "
                           "a direct model call on its clip")
    return {"native_eval_launches": eval_launches,
            **{f"native_{k}_launches": v for k, v in stream_launches.items()}}


def robot_io_phases(dev, card) -> int:
    """The A1 UDP bridge on the card: ``A1EmulatorServer`` + ``A1UdpClient``
    + ``cli.robot_exercise.run_exercise`` (``[udp_bridge]``, one physics
    launch per non-zero command), the first commands again through the
    plain physics (``[udp_vs_plain]``, state packets bit-equal); then the
    HRI backbones (``[backbones]``) and the re-ID frozen-graph round trip
    (``[tf_import]``). Returns the physics launches of ``[udp_bridge]``."""
    import copy

    from paddlerobotics_torch.cli.robot_exercise import run_exercise
    from paddlerobotics_torch.deploy.udp_bridge import (A1EmulatorServer,
                                                        A1UdpClient)
    from paddlerobotics_torch.hri.perception import reid, tf_graph
    from paddlerobotics_torch.hri.perception.backbones import (MobileNetV2,
                                                               ResNet)
    from paddlerobotics_torch.ops import physics_step
    from paddlerobotics_torch.utils import profiler

    def recording(client, log_):
        send = client.send_command

        def rec(cmd):
            t = time.perf_counter()
            st = send(cmd)
            log_.append((np.array(cmd), st, time.perf_counter() - t))
            return st

        client.send_command = rec
        return client

    # --- [udp_bridge] -----------------------------------------------------------
    server = A1EmulatorServer(device=dev)
    sent = []
    client = recording(A1UdpClient(server.addr, timeout=30.0, device=dev),
                       sent)
    physics_step.control_step.launches = 0
    t = time.perf_counter()
    try:
        rec = run_exercise(client, steps=UDP_STEPS, blend_steps=UDP_BLEND)
        wall = time.perf_counter() - t
        launches = physics_step.control_step.launches
        server.check()
    finally:
        client.close()
        server.close()
    nonzero = sum(bool(np.any(c != 0)) for c, _, _ in sent)
    rtt = 1e3 * np.asarray([s for _, _, s in sent])
    q = np.asarray(rec.rows["motor_angle"])
    rpy = np.asarray(rec.rows["rpy"])
    upright = bool(np.abs(rpy[:, :2]).max() < 0.35 and np.isfinite(q).all())
    ok = launches == nonzero == UDP_STEPS + UDP_BLEND and upright
    log("udp_bridge", commands=len(sent), nonzero_commands=nonzero,
        launches=launches, ms_per_round_trip=round(float(rtt.mean()), 4),
        p50_ms=round(float(np.percentile(rtt, 50)), 4),
        p99_ms=round(float(np.percentile(rtt, 99)), 4), tick_ms=26.0,
        seconds=round(wall, 3),
        hip_range=round(float(q[:, 1].max() - q[:, 1].min()), 4),
        max_abs_roll_pitch=round(float(np.abs(rpy[:, :2]).max()), 4),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the UDP bridge launched the physics other than "
                           "once per non-zero command, or the robot fell")

    # --- [udp_vs_plain]: the first commands through the plain physics -----------
    with plain_physics():
        server = A1EmulatorServer(device=dev)
        replay = []
        client = recording(A1UdpClient(server.addr, timeout=60.0,
                                       device=dev), replay)
        try:
            for cmd, _, _ in sent[:UDP_VS_PLAIN]:
                client.send_command(cmd)
            server.check()
        finally:
            client.close()
            server.close()
    diff = 0.0
    for (_, a, _), (_, b, _) in zip(sent, replay):
        for k, v in a.items():
            diff = max(diff, float(np.abs(np.asarray(v, np.float64)
                                          - np.asarray(b[k])).max()))
    ok = diff == 0.0 and len(replay) == UDP_VS_PLAIN
    log("udp_vs_plain", commands=len(replay), max_abs_diff=diff,
        plain_ms_per_round_trip=round(1e3 * float(np.mean(
            [s for _, _, s in replay])), 3),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the UDP bridge's states through the kernel and "
                           "through the plain physics differ")

    # --- [backbones]: MobileNetV2 and ResNet at 224² ------------------------------
    g = torch.Generator(dev)
    g.manual_seed(7)
    x = torch.rand(2, 3, 224, 224, generator=g, device=dev)
    for name, net in (("mobilenet_v2", MobileNetV2(device=dev, generator=g)),
                      ("resnet50", ResNet(device=dev, generator=g))):
        with torch.no_grad():
            out = net(x)
            out = out if isinstance(out, tuple) else (out,)
            cpu = copy.deepcopy(net).cpu()(x.cpu())
            cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for a, b in zip(out, cpu))
        prof = profiler.device_breakdown(torch.no_grad()(lambda: net(x)),
                                         reps=5)
        ok = rel <= BACKBONE_RTOL and all(bool(torch.isfinite(a).all())
                                          for a in out)
        log("backbones", net=name, batch=2, hw=224,
            out=json.dumps([list(a.shape) for a in out]),
            max_abs_diff_of_scale=rel, tol=BACKBONE_RTOL,
            device_ms=round(prof["device_ms_per_call"], 4),
            kernels=prof["kernels_per_call"],
            result="pass" if ok else "FAIL", card=repr(card))
        if not ok:
            raise RuntimeError(f"{name} on the card disagrees with the CPU")

    # --- [tf_import]: the re-ID encoder through a frozen graph ----------------------
    enc = reid.MarsSmall128(device=dev, generator=g)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g,
                                                       device=dev))
                m.running_var.copy_(0.8 + 0.4 * torch.rand(n, generator=g,
                                                           device=dev))
    t = time.perf_counter()
    blob = tf_graph.encode_const_graph(reid.export_tf_consts(enc))
    consts = tf_graph.parse_graph_consts(blob)
    imported = reid.import_tf_consts(consts, device=dev)
    secs = time.perf_counter() - t
    crops = torch.rand(20, 128, 64, 3, generator=g, device=dev)
    with torch.no_grad():
        a, b = imported(crops), enc(crops)
    diff = float((a - b).abs().max())
    spread = float((b[0] - b[1]).abs().max())
    ok = diff == 0.0 and spread > 1e-3
    log("tf_import", consts=len(consts), graph_bytes=len(blob),
        crops=20, max_abs_diff=diff, features_spread=round(spread, 4),
        seconds=round(secs, 3), result="pass" if ok else "FAIL",
        card=repr(card))
    if not ok:
        raise RuntimeError("the re-ID encoder through the frozen graph "
                           "differs from the encoder")
    return launches


def ernie_catalog(n: int, seed: int) -> list:
    """``n`` catalog rows (act, exp, utterance, movement) of the v1 action
    space, utterances of 1 to 40 words (2 to 42 tokens of 64: most keys of
    most rows are padding)."""
    from paddlerobotics_torch.hri import actions

    rng = np.random.default_rng(seed)
    acts, exps = list(actions.ACTION_TO_ID), list(actions.EXPRESSION_TO_ID)
    words = ("hello", "hi", "welcome", "nice", "to", "see", "you", "good",
             "morning", "friend", "come", "here", "please", "thanks")
    return [(acts[rng.integers(len(acts))], exps[rng.integers(len(exps))],
             " ".join(rng.choice(words, rng.integers(1, 41))), "null")
            for _ in range(n)]


def data_tools_phases(dev, card, scene) -> dict:
    """The HRI data tools on the card: the full-width ERNIE encoder over the
    317-utterance catalog through the attention kernel against the same
    module on the plain attention (``[utterance]``), the kernel against its
    plain version at ERNIE's layer-0 inputs with their padding masks
    (``[attn_kernel_vs_plain] case=ernie_pad``, timed in
    ``[attn_kernel_time]``), ``cli.collect_act_emb`` with ERNIE and BoW
    (``[collect_act_emb]``), ``WindowSampler`` → ``PrefetchLoader`` with the
    YOLOv4 ``WindowTokenizer`` → ``AttentionTrainer`` steps, a failing
    sample raised from the loader, and the trained checkpoint exported with
    the table and loaded back (``[hri_data]``); ``SalutationClsTree`` and
    ``DiscreteController`` on the card against the CPU
    (``[salutation]``). Returns the attention entry's additions."""
    import shutil

    import torch.nn.functional as F

    from paddlerobotics_torch.cli import collect_act_emb, export_hri_model
    from paddlerobotics_torch.hri import actions, data, export
    from paddlerobotics_torch.hri.attention_ctrl import AttnCtrlConfig
    from paddlerobotics_torch.hri.perception.utterance import (
        ErnieConfig, UtteranceEncoder)
    from paddlerobotics_torch.hri.train_attention import AttentionTrainer
    from paddlerobotics_torch.ops import attention
    from paddlerobotics_torch.train import checkpoints
    from paddlerobotics_torch.utils import profiler

    out_root = ROOT / "build" / "chip_smoke" / "data"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)

    def seeded(seed):
        g = torch.Generator(dev)
        g.manual_seed(seed)
        return g

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    # --- [utterance] ------------------------------------------------------------
    catalog = ernie_catalog(ERNIE_ROWS, seed=0)
    texts = [r[2] for r in catalog]
    ecfg = ErnieConfig()
    enc = UtteranceEncoder(cfg=ecfg, device=dev)
    model = enc.init(seeded(30))
    n_params = sum(p.numel() for p in model.parameters())
    ids = enc.token_ids(texts, ERNIE_LEN)
    with torch.no_grad():
        model(ids)                                   # warm-up
        torch.cuda.synchronize()
        attention.flash_attention.launches = 0
        seq_k, pool_k = model(ids)
        torch.cuda.synchronize()
        enc_launches = attention.flash_attention.launches
        seq_p, pool_p = model(ids, use_kernel=False)
        h0, m = model.embed(ids)                     # layer 0's call
        q, k, v = model.attn_0.project(h0)
        ms_k = timed(lambda: model(ids), 5, 1)
        ms_p = timed(lambda: model(ids, use_kernel=False), 5, 1)
    err_seq, err_pool = rel(seq_k, seq_p), rel(pool_k, pool_p)
    lengths = (ids > 0).sum(1).float()
    ok = (enc_launches == ecfg.num_layers and err_seq <= ERNIE_TOL and
          err_pool <= ERNIE_TOL and bool(torch.isfinite(pool_k).all()))
    log("utterance", rows=len(texts), tokens=ERNIE_LEN,
        layers=ecfg.num_layers, hidden=ecfg.hidden_size,
        params=n_params, kernel_launches=enc_launches,
        rel_err_sequence_vs_plain=err_seq, rel_err_pooled_vs_plain=err_pool,
        tol=ERNIE_TOL, mean_tokens=round(lengths.mean().item(), 2),
        min_tokens=int(lengths.min()), encode_ms_kernel=round(ms_k, 3),
        encode_ms_plain=round(ms_p, 3), result="pass" if ok else "FAIL",
        card=repr(card))
    if not ok:
        raise RuntimeError("ERNIE through the attention kernel disagrees with "
                           f"the plain attention or launched {enc_launches} "
                           f"times for {ecfg.num_layers} layers")

    # --- the kernel at ERNIE's layer-0 call: key-padding masks ------------------
    out = attention.flash_attention(q, k, v, m)
    ref = attention.reference_attention(q, k, v, m)
    torch.cuda.synchronize()
    pad_err = (out - ref).abs().max().item()
    pad_ok = (bool(torch.isfinite(out).all()) and
              torch.allclose(out, ref, atol=ATTN_ATOL, rtol=ATTN_RTOL))
    B, H, T, hd = q.shape
    plan = attention.launch_plan(B, H, T, hd)
    masked_keys = 1.0 - m[:, 0].mean().item()
    log("attn_kernel_vs_plain", case="ernie_pad", shape=tuple(q.shape),
        S=k.shape[2], mask_strides=tuple(m.stride()),
        masked_key_share=round(masked_keys, 4), max_abs_err=pad_err,
        plan=json.dumps(plan), result="pass" if pad_ok else "FAIL")
    if not pad_ok:
        raise RuntimeError("attention kernel disagrees with plain at ernie_pad")

    # --- the split plan on a padding mask: ERNIE's shortest rows at the
    # smallest batch whose grid would not fill the card, so key partitions
    # with no unmasked key go through the split plan's merge
    split_B = next(b_ for b_ in (1, 2, 4, 8, 16) if attention.launch_plan(
        b_, H, T, hd)["key_partitions"] > 1)
    rows = torch.argsort((m[:, 0] > 0).sum(-1))[:split_B]
    qs, ks, vs = (x[rows].contiguous() for x in (q, k, v))
    msk = m[rows].contiguous()
    split_plan = attention.launch_plan(split_B, H, T, hd)
    per = split_plan["keys_per_partition"]
    empty = int((msk[:, 0].reshape(split_B, -1, per).amax(-1) == 0).sum())
    out_s = attention.flash_attention(qs, ks, vs, msk)
    ref_s = attention.reference_attention(qs, ks, vs, msk)
    torch.cuda.synchronize()
    split_err = (out_s - ref_s).abs().max().item()
    split_ok = (bool(torch.isfinite(out_s).all()) and empty > 0 and
                torch.allclose(out_s, ref_s, atol=ATTN_ATOL, rtol=ATTN_RTOL))
    split_kern = lambda: attention.flash_attention(qs, ks, vs, msk)
    split_ms = timed(split_kern, 100, 10)
    split_plain_ms = timed(lambda: attention.reference_attention(
        qs, ks, vs, msk), 20, 2)
    split_prof = profiler.device_breakdown(split_kern, reps=20)
    split_dev = (split_prof["device_ms_per_call"]
                 / max(split_prof["kernels_per_call"], 1e-9))
    split_bd = attn_bound(split_B, H, T, ks.shape[2], hd)
    log("attn_kernel_vs_plain", case="split_pad", shape=tuple(qs.shape),
        S=ks.shape[2], masked_key_share=round(
            1.0 - msk[:, 0].mean().item(), 4),
        empty_key_partitions=empty, partitions=split_B * (
            ks.shape[2] // per), max_abs_err=split_err,
        kernel_ms=round(split_ms, 5), plain_ms=round(split_plain_ms, 5),
        kernel_device_ms_per_launch=round(split_dev, 5),
        bound_ms=round(split_bd["bound_ms"], 6),
        bound_by=split_bd["bound_by"],
        plan=json.dumps(split_plan), result="pass" if split_ok else "FAIL",
        card=repr(card))
    if not split_ok:
        raise RuntimeError("attention kernel's split plan disagrees with "
                           "plain on a padding mask")
    del qs, ks, vs, msk, out_s, ref_s

    def sdpa(q, k, v, m):
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=(-1e10 * (1.0 - m))[:, None])
        return out * (m.amax(-1) > 0).to(q.dtype)[:, None, :, None]

    kern = lambda: attention.flash_attention(q, k, v, m)
    plain = lambda: attention.reference_attention(q, k, v, m)
    lib = lambda: sdpa(q, k, v, m)
    lib_err = (lib() - plain()).abs().max().item()
    ms = [timed(kern, 100, 10), timed(plain, 20, 2), timed(lib, 100, 10),
          timed(lib, 100, 0), timed(plain, 20, 0), timed(kern, 100, 0)]
    kernel_ms, plain_ms, lib_ms = min(ms[0], ms[5]), min(ms[1], ms[4]), \
        min(ms[2], ms[3])
    dev_ms = {n: profiler.device_breakdown(f, reps=20)
              for n, f in (("kernel", kern), ("plain", plain), ("sdpa", lib))}
    kernel_dev = (dev_ms["kernel"]["device_ms_per_call"]
                  / max(dev_ms["kernel"]["kernels_per_call"], 1e-9))
    # the mask is the key-padding row broadcast over the queries (stride 0):
    # B·S floats to read, not B·T·S
    bd = attn_bound(B, H, T, k.shape[2], hd, mask_elems=B * k.shape[2])
    log("attn_kernel_time", case="ernie_pad", B=B, H=H, T=T, S=k.shape[2],
        hd=hd, kernel_ms=round(kernel_ms, 5), plain_ms=round(plain_ms, 5),
        sdpa_ms=round(lib_ms, 5), sdpa_max_abs_err_vs_plain=lib_err,
        **{f"{n}_device_ms": round(d["device_ms_per_call"], 5)
           for n, d in dev_ms.items()},
        kernel_device_ms_per_launch=round(kernel_dev, 5),
        launches_per_encode=enc_launches,
        flops=bd["flops"], bytes=bd["bytes"],
        **{k_: round(bd[k_], 6) for k_ in (
            "bound_bytes_ms", "bound_ops_fp32_ms", "bound_ops_tc_ms",
            "bound_ms")},
        bound_by=bd["bound_by"],
        bound_share_device=round(bd["bound_ms"] / kernel_dev, 4),
        plan=json.dumps(plan), card=repr(card))
    del h0, q, k, v, m, out, ref, seq_k, seq_p, model, enc

    # --- [collect_act_emb] --------------------------------------------------------
    tsv = out_root / "acts.tsv"
    tsv.write_text("".join("\t".join(r) + "\n" for r in catalog))
    tables, cli_launches = {}, {}
    for encoder in ("ernie", "bow"):
        attention.flash_attention.launches = 0
        t = time.perf_counter()
        tables[encoder] = collect_act_emb.main([
            "--catalog", str(tsv), "--out", str(out_root / f"{encoder}.npy"),
            "--encoder", encoder, "--seed", "0"])
        secs = time.perf_counter() - t
        cli_launches[encoder] = attention.flash_attention.launches
        tab = tables[encoder]
        onehot = np.stack([actions.MultimodalAction(*r).one_hot()
                           for r in catalog])
        ok = (tab.shape == (ERNIE_ROWS, 12 + 30 + 768) and
              bool(np.isfinite(tab).all()) and
              np.array_equal(tab[:, :42], onehot) and
              cli_launches[encoder] == (ecfg.num_layers
                                        if encoder == "ernie" else 0))
        log("collect_act_emb", encoder=encoder, shape=tab.shape,
            seconds=round(secs, 3), kernel_launches=cli_launches[encoder],
            distinct_utterance_rows=len({r[42:].tobytes() for r in tab}),
            result="pass" if ok else "FAIL", card=repr(card))
        if not ok:
            raise RuntimeError(f"collect_act_emb --encoder {encoder}")

    # --- [hri_data]: sampler → loader (YOLOv4 tokenize) → trainer -----------------
    cfg = AttnCtrlConfig(num_actions=ERNIE_ROWS)
    trainer = AttentionTrainer(cfg, lr=HRI_LR, weight_decay=HRI_L2,
                               device=dev)
    state = trainer.init(seeded(31))
    moments = [data.AnnotatedMoment(f"clip_{i:03d}.mp4", 20 + 7 * i,
                                    i % ERNIE_ROWS) for i in range(64)]
    sampler = data.WindowSampler(moments, num_frames=cfg.num_frames, seed=0)
    sampler.add_negatives(moments[::4])
    fgen = seeded(32)

    def synthetic_frames(video, idx):
        return torch.rand((len(idx), SIZE, SIZE, 3), generator=fgen,
                          device=dev)

    tok = data.WindowTokenizer(scene, read_frames=synthetic_frames,
                               device=dev)
    loader = data.PrefetchLoader(sampler.sample, tok, HRI_BATCH)
    it = iter(loader)
    trainer.train_step(state, next(it))          # warm-up batch
    torch.cuda.synchronize()
    attention.flash_attention.launches = 0
    losses = []
    t = time.perf_counter()
    for _ in range(HRI_DATA_STEPS):
        losses.append(trainer.train_step(state, next(it))["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    data_launches = attention.flash_attention.launches
    loader.close()
    losses = [float(x) for x in losses]
    ok = all(np.isfinite(losses)) and data_launches == 0 and \
        not loader._thread.is_alive()

    def failing():
        raise ValueError("synthetic decode failure")

    bad = data.PrefetchLoader(failing, tok, 2)
    t = time.perf_counter()
    try:
        next(iter(bad))
        raised = None
    except ValueError as e:
        raised = str(e)
    raise_s = time.perf_counter() - t
    bad.close()
    raised_ok = raised == "synthetic decode failure" and raise_s < 1.0 and \
        not bad._thread.is_alive()

    ck = checkpoints.save_attn(str(out_root / "train"), state)
    export_hri_model.main(["--ckpt", ck, "--out", str(out_root / "bundle"),
                           "--wae", str(out_root / "ernie.npy")])
    bundle = export.load_bundle(str(out_root / "bundle"), device=dev)
    d_wae = float(np.abs(bundle.wae - tables["ernie"]).max())
    log("hri_data", windows=HRI_DATA_STEPS * HRI_BATCH, batch=HRI_BATCH,
        steps=HRI_DATA_STEPS, seconds=round(wall, 3),
        windows_per_s=round(HRI_DATA_STEPS * HRI_BATCH / wall, 2),
        loss_first=round(losses[0], 5), loss_last=round(losses[-1], 5),
        attention_launches=data_launches,
        failing_sample_raised=repr(raised), raised_after_s=round(raise_s, 4),
        bundle_wae_shape=tuple(bundle.wae.shape),
        bundle_wae_max_abs_diff=d_wae,
        result="pass" if ok and raised_ok and d_wae == 0.0 else "FAIL",
        card=repr(card))
    if not ok or not raised_ok or d_wae != 0.0:
        raise RuntimeError("the data loader path failed")
    del state, trainer, bundle

    # --- [salutation]: the discrete heads, card against CPU -----------------------
    img = torch.rand((2, SIZE, SIZE, 3), generator=seeded(33), device=dev)
    fm = scene.get_instances_with_feats(img).feats          # (2,K,5,5,512)
    tree = actions.SalutationClsTree(fm.shape[-1], device=dev,
                                     generator=seeded(34))
    tree_cpu = actions.SalutationClsTree(fm.shape[-1], device="cpu")
    tree_cpu.load_state_dict(tree.state_dict())
    feat = pool_k                                            # (317,768)
    ctrl = actions.DiscreteController(feat.shape[-1],
                                      actions.action_set_size(), (256,),
                                      device=dev, generator=seeded(35))
    ctrl_cpu = actions.DiscreteController(feat.shape[-1],
                                          actions.action_set_size(), (256,),
                                          device="cpu")
    ctrl_cpu.load_state_dict(ctrl.state_dict())
    with torch.no_grad():
        t_card, t_cpu = tree(fm), tree_cpu(fm.cpu())
        c_card, c_cpu = ctrl(feat), ctrl_cpu(feat.cpu())
    e_tree, e_ctrl = rel(t_card.cpu(), t_cpu), rel(c_card.cpu(), c_cpu)
    ok = e_tree <= BACKBONE_RTOL and e_ctrl <= BACKBONE_RTOL and \
        t_card.shape == fm.shape[:2] + (6,)
    log("salutation", tree_shape=tuple(t_card.shape),
        tree_rel_err_vs_cpu=e_tree, ctrl_shape=tuple(c_card.shape),
        ctrl_rel_err_vs_cpu=e_ctrl, tol=BACKBONE_RTOL,
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the salutation heads differ between card and CPU")
    return {"utterance_launches": enc_launches,
            "collect_act_emb_launches": cli_launches["ernie"],
            "ernie_pad_max_abs_err": max(pad_err, split_err),
            "split_pad_max_abs_err": split_err, "split_pad_ms": split_ms,
            "split_pad_device_ms": split_dev,
            "split_pad_plain_ms": split_plain_ms,
            "split_pad_bound_ms": split_bd["bound_ms"],
            "ernie_pad_ms": kernel_ms, "ernie_pad_device_ms": kernel_dev,
            "ernie_pad_plain_ms": plain_ms, "ernie_pad_library_ms": lib_ms,
            "ernie_pad_bound_ms": bd["bound_ms"],
            "ernie_pad_bound_by": bd["bound_by"]}


def per_env_phases(dev, card) -> int:
    """``make_env("Quadrupedal")`` vmapped at B=PER_ENV_B on the card for
    PER_ENV_STEPS control steps from the start of ``BatchedQuadrupedEnv``
    through the physics kernel, at the JAX tests' bounds, and against the
    same vmapped env on the CPU (``[per_env]``). Returns the physics
    launches of the batched env in that run."""
    from torch.func import vmap

    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.envs import make_env
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.ops import physics_step

    Bp = PER_ENV_B
    env = make_env("Quadrupedal")                    # on the card
    env_cpu = make_env("Quadrupedal", device="cpu")
    benv = BatchedQuadrupedEnv(QuadrupedConfig(), Bp)
    g = torch.Generator(dev)
    g.manual_seed(40)
    draws = env.sample_draws(g, (Bp,))
    draws_cpu = type(draws)(*[x.cpu() for x in draws])
    reset = vmap(lambda d: env.reset(draws=d))
    step, step_cpu = vmap(env.step), vmap(env_cpu.step)
    ps, pobs = reset(draws)
    cs, cobs = vmap(lambda d: env_cpu.reset(draws=d))(draws_cpu)
    bs, bobs = benv.reset(g)
    err = {"obs_reset": (pobs - bobs).abs().max().item()}
    idx = torch.full((Bp,), 5, dtype=torch.int32, device=dev)
    err["etg_residual"] = (vmap(env._etg_residual)(ps.etg_w, ps.etg_b, idx)[0]
                           - benv._etg_residual(bs.etg_w, bs.etg_b, idx)[0].T
                           ).abs().max().item()
    rng = np.random.default_rng(41)
    actions = [torch.as_tensor(0.05 * rng.standard_normal((Bp, 12)),
                               dtype=torch.float32, device=dev)
               for _ in range(PER_ENV_STEPS)]
    physics_step.control_step.launches = 0
    step_ms, cpu_err, cpu_close = [], 0.0, True
    for a in actions:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ps, pobs, prew, pdone, _ = step(ps, a)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        bs, bobs, _, bdone, _ = benv.step(bs, a)
        cs, cobs, _, _, _ = step_cpu(cs, a.cpu())
        cpu_err = max(cpu_err, (pobs.cpu() - cobs).abs().max().item())
        cpu_close &= torch.allclose(pobs.cpu(), cobs, rtol=PER_ENV_CPU_TOL,
                                    atol=PER_ENV_CPU_TOL)
    torch.cuda.synchronize()
    launches = physics_step.control_step.launches
    s = bs.robot.s
    err["q"] = (ps.robot.state.q - s.q.T).abs().max().item()
    err["pos"] = (ps.robot.state.base_pos - s.pos.T).abs().max().item()
    err["quat"] = (ps.robot.state.base_quat - s.quat.T).abs().max().item()
    bound = {"obs_reset": 2e-3, "etg_residual": 1e-4, "q": 2e-3,
             "pos": 5e-3, "quat": 2e-3}
    cpu_state_err = max((getattr(ps.robot.state, f).cpu()
                         - getattr(cs.robot.state, f)).abs().max().item()
                        for f in ("q", "base_pos", "base_quat"))
    b_ms = timed(lambda: benv.step(bs, actions[0]), 20, 2)
    ok = (all(err[k] <= bound[k] for k in bound) and launches == PER_ENV_STEPS
          and cpu_close and cpu_state_err <= PER_ENV_CPU_TOL
          and not bool(pdone.any()) and not bool(bdone.any()))
    log("per_env", B=Bp, steps=PER_ENV_STEPS,
        **{f"max_abs_err_{k}_vs_batched": v for k, v in err.items()},
        bounds=json.dumps(bound), batched_kernel_launches=launches,
        obs_max_abs_err_card_vs_cpu=cpu_err, obs_allclose_card_vs_cpu=cpu_close,
        state_max_abs_err_card_vs_cpu=cpu_state_err,
        cpu_tol=PER_ENV_CPU_TOL,
        ms_per_control_step=json.dumps([round(x, 2) for x in step_ms]),
        batched_kernel_ms_per_control_step=round(b_ms, 4),
        result="pass" if ok else "FAIL", card=repr(card))
    if not ok:
        raise RuntimeError("the per-env env disagrees with the batched env or "
                           "with itself on the CPU")
    return launches


def count_ops_per_env(sim, h_fn) -> float:
    """Elementwise arithmetic operations per env of one plain control step,
    counted on the CPU at a small batch (each op's output elements)."""
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


if __name__ == "__main__":
    sys.exit(main())
