"""A1 env throughput on one card (the port's counterpart of the repo's
``bench.py`` and of ``scripts_dev/longring_probe.py``).

The batched A1 env stepped with zero actions and autoreset, one physics
kernel launch per control step, in two regimes:

- ``no_dr``: ``QuadrupedConfig()``, the minimal substep ring (what
  ``bench.py`` times);
- ``dr_long_ring``: the same with ``random_dynamics=True``: per-env dynamics
  with a 0–80 ms policy-obs latency, so the ring holds
  ``latency_buffer_len`` rows rounded up to a multiple of ``action_repeat``
  and the observation blends over the whole ring.

Timing as in ``bench.py``: one warm-up rollout of ``--steps`` control steps,
a synchronize, then the host clock over ``--reps`` × ``--steps`` steps up to
a synchronize, with CUDA events over the same window beside it.

    python -m paddlerobotics_torch.cli.env_bench [--regime both]

prints one JSON line per regime (``regime``, ``env_steps_per_s``,
``ring_len``, the event ms), ``dr_over_nodr`` when both ran, and last, when
``no_dr`` ran, ``bench.py``'s line ``{"metric":
"a1_env_steps_per_sec_per_chip_4096envs", "value", "unit", "device"}`` with
the card's name and power limit. ``bench.py``'s ``vs_baseline`` is left
out: its denominator is a target for the TPU. ``--device cpu`` runs the
plain physics on the CPU and names the metric ``..._cpu_<B>envs``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

REGIMES = ("no_dr", "dr_long_ring")


def regime_config(regime: str) -> QuadrupedConfig:
    cfg = QuadrupedConfig()
    if regime == "dr_long_ring":
        cfg = dataclasses.replace(cfg, random=dataclasses.replace(
            cfg.random, random_dynamics=True))
    elif regime != "no_dr":
        raise ValueError(f"unknown regime {regime!r}; one of {REGIMES}")
    return cfg


def rollout(env: BatchedQuadrupedEnv, state, steps: int):
    """``steps`` control steps of zero actions with autoreset; returns the
    last step's (state, obs, reward, done)."""
    zeros = torch.zeros((env.B, env.action_dim), device=env.device)
    for _ in range(steps):
        state, obs, rew, done, _ = env.step(state, zeros)
    return state, obs, rew, done


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_rollout(env: BatchedQuadrupedEnv, state, steps: int,
                  reps: int) -> dict:
    """``bench.py``'s timing of ``rollout``: a warm-up rollout from a copy
    of ``state`` (its own generator), then ``reps`` rollouts from ``state``
    on the host clock up to a synchronize, CUDA events beside it on the
    card. Returns the rate, the seconds, the event ms (None on the CPU) and
    the final (state, obs, reward, done)."""
    dev = env.device
    warm_gen = torch.Generator(device=dev)
    warm_gen.set_state(state.rng.get_state())
    rollout(env, state.replace(rng=warm_gen), steps)
    _sync(dev)
    events = None
    if dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    out = (state,)
    for _ in range(reps):
        out = rollout(env, out[0], steps)
    if events:
        events[1].record()
    _sync(dev)
    dt = time.perf_counter() - t0
    return {"env_steps_per_s": env.B * steps * reps / dt, "seconds": dt,
            "event_ms": events[0].elapsed_time(events[1]) if events else None,
            "final": out}


def bench_env(regime: str, num_envs: int = 4096, steps: int = 100,
              reps: int = 4, device=None) -> dict:
    """One regime's env from ``env.reset`` on a generator seeded with 0
    (``bench.py`` resets on key 0), timed by ``timed_rollout``; adds the
    ring length and the regime to its result."""
    env = BatchedQuadrupedEnv(regime_config(regime), num_envs,
                              device=resolve_device(device))
    gen = torch.Generator(device=env.device)
    gen.manual_seed(0)
    state, _ = env.reset(gen)
    out = timed_rollout(env, state, steps, reps)
    out.update(regime=regime, ring_len=env._hist_len, num_envs=num_envs,
               steps=steps, reps=reps)
    return out


def card(dev: torch.device) -> dict:
    """The device's name and power limit (``nvidia-smi``; the CPU has
    neither a power limit nor a card)."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def regime_line(r: dict) -> dict:
    ev = r["event_ms"]
    n = r["steps"] * r["reps"]
    return {"regime": r["regime"], "env_steps_per_s": round(
        r["env_steps_per_s"], 1), "ring_len": r["ring_len"],
        "num_envs": r["num_envs"], "control_steps": n,
        "host_ms_per_step": round(r["seconds"] / n * 1e3, 4),
        "event_ms_per_step": None if ev is None else round(ev / n, 4)}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--regime", choices=REGIMES + ("both",), default="no_dr")
    p.add_argument("--device", default=None,
                   help="default: the card (raises without one); cpu runs "
                        "the plain physics")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    regimes = REGIMES if args.regime == "both" else (args.regime,)
    lines, rates = [], {}

    def emit(line: dict) -> None:
        lines.append(line)
        print(json.dumps(line), flush=True)

    for regime in regimes:
        emit(regime_line(bench_env(regime, args.num_envs, args.steps,
                                   args.reps, dev)))
        rates[regime] = lines[-1]["env_steps_per_s"]
    if len(rates) == 2:
        emit({"dr_over_nodr": round(rates["dr_long_ring"] / rates["no_dr"],
                                    4)})
    if "no_dr" in rates:
        where = "per_chip" if dev.type == "cuda" else "cpu"
        emit({"metric": f"a1_env_steps_per_sec_{where}_{args.num_envs}envs",
              "value": rates["no_dr"], "unit": "env_steps/s",
              "device": card(dev)})
    return lines


if __name__ == "__main__":
    main()
