"""Fused rollout+learn throughput on the card (PyTorch port of the JAX
package's ``cli/train_bench.py``).

The training hot loop (``ETGRLTrainer.rollout_chunk``: policy draw, env
step with one physics-kernel launch, replay write, one gather of K batches
and K SAC updates per control step) at the two shipped schedules:

    python -m paddlerobotics_torch.cli.train_bench

prints one JSON line per schedule with env steps/s, grad updates/s and
batch rows/s, timed on the host clock from a synchronize after a warm-up
chunk to a synchronize after the last chunk, and the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from paddlerobotics_torch.core.config import (ESConfig, QuadrupedConfig,
                                              SACConfig, TrainConfig)
from paddlerobotics_torch.train.etg_rl import ETGRLTrainer

SCHEDULES = [
    # (tag, num_envs, updates_per_step)
    ("default_B4096_K4", 4096, 4),
    ("sample_efficient_B1024_K16", 1024, 16),
]


def make_trainer(B: int, K: int, outdir: str, bf16: bool = False,
                 device=None) -> ETGRLTrainer:
    """A pure SAC loop: no warm-up, ES and eval out of reach, 100k-row
    replay (the JAX bench's settings)."""
    cfg = QuadrupedConfig(
        sac=SACConfig(warmup_steps=0, memory_size=100_000, bf16_matmul=bf16),
        es=ESConfig(es_every_steps=10 ** 12),
        train=TrainConfig(num_envs=B, eval_every_steps=10 ** 12))
    return ETGRLTrainer(cfg, num_envs=B, outdir=outdir, updates_per_step=K,
                        device=device)


def bench_schedule(tag: str, B: int, K: int, chunk_steps: int, iters: int,
                   outdir: str, bf16: bool = False, device=None) -> dict:
    tr = make_trainer(B, K, os.path.join(outdir, tag), bf16, device)
    carry, _, _ = tr.init_carry(0)
    tr.rollout_chunk(carry, 600, chunk_steps, True)                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = tr.rollout_chunk(carry, 600, chunk_steps, True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(out["critic_loss"]):
        raise RuntimeError(f"{tag}: non-finite critic loss")
    steps = iters * chunk_steps
    return {
        "schedule": tag, "num_envs": B, "updates_per_step": K,
        "env_steps_per_s": round(steps * B / dt, 1),
        "grad_updates_per_s": round(steps * K / dt, 1),
        "batch_rows_per_s": round(steps * K * tr.cfg.sac.batch_size / dt, 1),
        "wall_s": round(dt, 2),
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chunk_steps", type=int, default=50)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--use_pallas", type=int, default=None,
                   help="the JAX bench's flag: default and 1 run the "
                        "physics kernel; 0 (the plain physics) is refused, "
                        "the bench measures the card")
    p.add_argument("--num_envs", type=int, default=0,
                   help="override: bench a single custom (B, K) point")
    p.add_argument("--updates_per_step", type=int, default=4)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 critic products (SACConfig.bf16_matmul)")
    p.add_argument("--outdir", type=str, default="train_log/train_bench",
                   help="where each schedule's trainer writes its metrics")
    args = p.parse_args(argv)
    if args.use_pallas == 0:
        raise SystemExit("--use_pallas 0 on the card: the plain physics is "
                         "the tests' reference, the card runs the kernel")
    if not torch.cuda.is_available():
        raise SystemExit("train_bench measures the card: no CUDA device")
    schedules = SCHEDULES if not args.num_envs else [
        (f"custom_B{args.num_envs}_K{args.updates_per_step}",
         args.num_envs, args.updates_per_step)]
    for tag, B, K in schedules:
        r = bench_schedule(tag, B, K, args.chunk_steps, args.iters,
                           args.outdir, bf16=args.bf16)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
