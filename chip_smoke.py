"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds both hand-written kernels from the checkout (in parallel) and holds
each against its plain PyTorch version on the card. Drives the two paths
of the port through their entry points, each with the launch counts set
to 0 just before it and read just after:

- physics: the batched A1 env and the deterministic-policy rollout
  ``train.etg_rl.evaluate`` at B=4096 (one physics launch per step);
- HRI serving: ``ProactiveGreetingService.process_frame`` with YOLOv4 at
  416² and the 317-action attention controller at its default widths (6
  attention launches per decided frame), then ``STEADY_FRAMES`` decided
  frames once the window is full, then ``OfflineEvaluator`` at 64
  windows; both against the same path on the plain attention.

Times each kernel beside its bound, its plain version and, for attention,
``F.scaled_dot_product_attention`` as the library yardstick, and the
attention wrapper's host cost per call. Imports nothing of JAX.

    python3 chip_smoke.py

Exits non-zero on any failure and when no CUDA device is present. The
last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches, error and times.
"""

from __future__ import annotations

import json
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
HOST_CALLS = 1000                       # wrapper calls of [attn_host]


def log(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def instance(kernel_name: str) -> str:
    """A kernel's template arguments from its mangled name, e.g. '64,4,1,64'."""
    return ",".join(re.findall(r"Li(\d+)E", kernel_name)) or kernel_name


def attn_bound(B: int, H: int, T: int, S: int, hd: int) -> dict:
    """Least time of one attention call on the card (ms): q, k, v, the mask
    and the output moved once each at the HBM rate; the two products,
    4·B·H·T·S·hd operations, at the fp32 CUDA-core peak (the figure of the
    first kernel, kept for continuity) and, as the kernel computes them, in
    three TF32 passes at the dense TF32 peak. The bound is the larger of
    the bytes and the tensor-core figure."""
    flops = 4 * B * H * T * S * hd
    n_bytes = 4 * (2 * B * H * T * hd + 2 * B * H * S * hd + B * T * S)
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
    from paddlerobotics_torch.ops import attention, physics_step
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
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(physics_step.build), ex.submit(attention.build)]:
            f.result()
    for name, info in (("physics_step", physics_step.build_info),
                       ("attention", attention.build_info)):
        regs = {instance(k): v for k, v in info["ptxas"].items()}
        log("build", kernel=name, seconds=round(info["seconds"], 1),
            ptxas=json.dumps(regs, sort_keys=True))
        if not info["ptxas"]:
            raise RuntimeError(f"no -Xptxas -v report for {name}")
    log("build", wall_seconds=round(time.perf_counter() - t0, 1))

    # --- kernel against plain ------------------------------------------------
    rng = np.random.default_rng(0)

    def nrm(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    def start(h_fn, L, spread):
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
        e = torch.zeros(B, device=dev)
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
    ]
    worst, failed = 0.0, []
    for name, simkw, mode, L, kw in cases:
        cfg = SimConfig(**simkw)
        h_fn = terrain.height_fn(TaskConfig(task_mode=mode, terrain_start=0.0))
        rb0 = start(h_fn, L, spread=mode != "ground")
        p = sbatch.BDynParams.default(B, device=dev)
        if kw.get("dr"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            p = randomize.sample_dynamics(B, gen, device=dev)
        torque = kw.get("torque", False)
        qd_ref = tau_ff = None
        if kw.get("hybrid"):
            qd_ref, tau_ff = nrm(12, B, scale=0.3), nrm(12, B, scale=1.5)
        rk, rp = rb0, rb0
        errs, tau_err, con_mis = [], 0.0, 0
        for _ in range(3):
            act = (nrm(12, B, scale=5.0) if torque else
                   (rb0.s.q + nrm(12, B, scale=0.1)).contiguous())
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
        log("kernel_vs_plain", case=name, L=L, S=min(L, n),
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
    # on a small input (32 steps). The kernel is bit-equal to the plain
    # version above, so 1e-3 of the return leaves room for rounding only.
    ref_steps, Bs = 32, 512
    env_s = BatchedQuadrupedEnv(cfg, Bs)
    r_k = etg_rl.evaluate(env_s, actor, w0, b0, ref_steps)
    orig = physics_step.control_step
    physics_step.control_step = sbatch.control_step     # the env's call
    try:
        r_p = etg_rl.evaluate(env_s, actor, w0, b0, ref_steps)
    finally:
        physics_step.control_step = orig
    d_ret = abs(r_k[0].item() - r_p[0].item())
    d_len = abs(r_k[1].item() - r_p[1].item())
    log("evaluate_vs_plain", B=Bs, steps=ref_steps, return_kernel=r_k[0].item(),
        return_plain=r_p[0].item(), abs_diff_return=d_ret,
        abs_diff_length=d_len)
    if d_ret > 1e-3 * max(1.0, abs(r_p[0].item())) or d_len > 0.5:
        raise RuntimeError("kernel rollout disagrees with the plain rollout")

    # autoreset rollout with zero actions, as bench.py does
    state, obs = env.reset(gen)
    zeros = torch.zeros((B, 12), device=dev)
    for _ in range(10):
        state, obs, rew, done, _ = env.step(state, zeros)
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start_ev.record()
    for _ in range(4):
        for _ in range(100):
            state, obs, rew, done, _ = env.step(state, zeros)
    end_ev.record()
    torch.cuda.synchronize()
    sec = start_ev.elapsed_time(end_ev) / 1e3
    sps = B * 400 / sec
    log("env_step_bench", a1_env_steps_per_sec_4096envs=round(sps, 1),
        ms_per_step=round(sec / 400 * 1e3, 4), card=repr(card),
        obs_finite=bool(torch.isfinite(obs).all().item()))

    # where an env step's time goes on the card (torch.profiler)
    holder = [state]

    def one_step():
        holder[0] = env.step(holder[0], zeros)[0]

    prof = profiler.device_breakdown(one_step, reps=5)
    log("env_step_profile", **{k: (json.dumps(v) if k == "top" else
                                   round(v, 4))
                               for k, v in prof.items()})

    # --- kernel time beside its bound ------------------------------------------
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

    # bound: every input read once and every output written once, and the
    # plain version's elementwise operations on these inputs at FP32 peak
    ptrs, floats, ints, outs, keep = physics_step.launch_args(
        rb, act, p, sim, h_fn, False, None, None)
    n_in = sum(t.numel() for t in keep[:len(keep) - len(outs)]
               if t is not None) - p.control_latency.numel()
    n_out = sum(t.numel() for t in outs)
    bytes_moved = 4 * (n_in + n_out)
    ops = count_ops_per_env(sim, h_fn) * B
    bound_bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    log("kernel_time", B=B, kernel_ms=round(kernel_ms, 5),
        plain_ms=round(plain_ms, 3), bytes=bytes_moved, ops=ops,
        bound_bytes_ms=round(bound_bytes_ms, 5),
        bound_ops_ms=round(bound_ops_ms, 5), bound_ms=round(bound_ms, 5),
        bound_share=round(bound_ms / kernel_ms, 4), library_ms=None,
        card=repr(card))

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
    }]
    kernels.append(hri_phases(dev, card))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def hri_phases(dev, card) -> dict:
    """The HRI serving path and the attention kernel; returns the kernel's
    entry of the ``kernels`` line."""
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
    return entry


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
