"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the physics kernel from the checkout, holds it against its plain
PyTorch version at B=4096, drives the slice's entry points (the batched A1
env and the deterministic-policy rollout ``train.etg_rl.evaluate``) on the
card, and times the kernel beside its bound. Imports nothing of JAX.

    python3 chip_smoke.py

Exits non-zero on any failure and when no CUDA device is present. The
last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B = 4096
EVAL_STEPS = 200
# H100 SXM data sheet: HBM3 bandwidth and FP32 (non-tensor) peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Kernel vs plain: after one control step every env agrees to TOL; after
# three, contact onsets (the damping term d·vn·[phi > 0] jumps at phi = 0)
# may let a last-bit difference grow in an env that is just touching down,
# so at most MAX_DRIFT_FRAC of the envs may exceed TOL.
TOL = 1e-4
MAX_DRIFT_FRAC = 1e-3


def log(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from paddlerobotics_torch.core.config import QuadrupedConfig, SimConfig, TaskConfig
    from paddlerobotics_torch.envs import randomize
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.etg import fit
    from paddlerobotics_torch.algos.networks import Actor
    from paddlerobotics_torch.ops import physics_step
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

    # --- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    physics_step.build()
    info = physics_step.build_info
    regs = {k.split("ILi")[-1].split("E")[0] if "ILi" in k else k: v
            for k, v in info["ptxas"].items()}
    log("build", seconds=round(time.perf_counter() - t0, 1),
        ptxas=json.dumps(regs, sort_keys=True))
    if not info["ptxas"]:
        raise RuntimeError("no -Xptxas -v report for the kernel")

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

    def timed(fn, reps, warm):
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
