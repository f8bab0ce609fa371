"""Closed-loop rollout: the seeded actor's deterministic action
(``sac.predict``, scaled by ``act_bound``) into ``env.step`` with autoreset,
B envs, no learner.

Traffic parameters: ``num_envs``, ``warmup_steps`` (untimed steps before the
window), ``trace_steps`` (steps under the profiler after it).

The check holds, against the reference: the reset from the seed
(``start_gap``); at the steps drawn from the seed, the actor's action from
the program's observation (``action_gap``) and the env step from the
program's state and action (``step_gap``: state with the ring, the
dynamics and the carried ETG readout, observation, reward, done).
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, harness, trace as trace_mod


def build(cell, seed, device):
    from paddlerobotics_torch.algos.networks import Actor
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

    cfg = harness.quadruped_config(QuadrupedConfig,
                                   cell.config["quadruped"])
    env = BatchedQuadrupedEnv(cfg, cell.traffic["num_envs"], device=device)
    actor = Actor(env.obs_dim, env.action_dim, hidden=cfg.sac.hidden_dim,
                  device=device)
    weights = harness.make_params(actor, harness.seeded_generator(
        seed, 1, device))
    harness.load_params(actor, weights).requires_grad_(False)
    return cfg, env, actor, weights


def run(cell, seed, seconds, trace_on, device, stand_ins=()):
    from paddlerobotics_torch.algos import sac

    t = cell.traffic
    cfg, env, actor, weights = build(cell, seed, device)
    bound = torch.as_tensor(env.act_bound, device=device)
    offset = torch.as_tensor(env.act_offset, device=device)
    gen = harness.seeded_generator(seed, 2, device)
    reset_gen = gen.get_state()
    state, obs = env.reset(gen)
    start = (state, obs)
    spans = harness.Spans(on=trace_on)
    picks = set(harness.sample_steps(seed, cell.check["samples"],
                                     cell.check["sample_below"]))
    kept = []
    loop = {"state": state, "obs": obs}

    def step(i, keep=False):
        s, o = loop["state"], loop["obs"]
        gen_bytes = s.rng.get_state() if keep else None
        with torch.no_grad():
            with spans.span("policy"):
                a = sac.predict(actor, o) * bound + offset
            with spans.span("env.step"):
                out = env.step(s, a)
        loop["state"], loop["obs"] = out[0], out[1]
        if keep:
            kept.append((i, s, o, gen_bytes, a, out))

    for i in range(t["warmup_steps"]):
        step(-1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    spans.reset()
    window_start = time.perf_counter()
    steps, window_s = harness.timed_window(
        seconds, lambda i: step(i, keep=i in picks))
    spans_ms = {k: list(v) for k, v in spans.ms.items()}
    tr = None
    if trace_on:
        tr = trace_mod.profile(step, t["trace_steps"], spans, cell.name)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    B = env.B
    shapes = {"num_envs": B, "obs_dim": env.obs_dim,
              "action_dim": env.action_dim, "hidden": cfg.sac.hidden_dim,
              "ring_rows": env._hist_len}
    del env, actor, loop
    check, stand_ins, failed = check_rollout(
        cell, weights, reset_gen, start, kept, device, stand_ins)
    return harness.RunResult(
        metrics={"env_steps_per_s": steps * B / window_s},
        check=check, attempted=steps, failed=failed,
        memory_peak_bytes=peak, window_s=window_s, steps=steps,
        spans=spans_ms, trace=tr, shapes=shapes, stand_ins=stand_ins,
        window_start=window_start)


def reference_side(cell, weights, device):
    """The reference env and actor on the same configuration and
    weights."""
    from benchmark.reference import config as rconfig
    from benchmark.reference import networks
    from benchmark.reference.env import BatchedQuadrupedEnv

    cfg = harness.quadruped_config(rconfig.QuadrupedConfig,
                                   cell.config["quadruped"])
    env = BatchedQuadrupedEnv(cfg, cell.traffic["num_envs"], device=device)
    actor = networks.Actor(env.obs_dim, env.action_dim,
                           hidden=cfg.sac.hidden_dim, device=device)
    harness.load_params(actor, weights).requires_grad_(False)
    return cfg, env, actor


def check_rollout(cell, weights, reset_gen, start, kept, device,
                  stand_ins=()):
    """The check of a rollout run: (its ``Check``, each stand-in's, the
    kept steps over a limit). The one stand-in is ``control``: the
    reference in TF32 makes the reset, the action and the step from the
    program's inputs, in the program's place."""
    from benchmark.reference import precision
    from benchmark.reference import sac as rsac

    _, renv, ractor = reference_side(cell, weights, device)
    bound = torch.as_tensor(renv.act_bound, device=device)
    offset = torch.as_tensor(renv.act_offset, device=device)
    etg = renv.default_etg()

    def reset():
        return renv.reset(compare.generator_at(reset_gen, device))

    def act(o):
        return rsac.predict(ractor, o) * bound + offset

    def env_step(s, gen_bytes, a):
        return renv.step(compare.reference_state(s, gen_bytes, device, etg),
                         a)

    def judge(start, kept):
        check = harness.Check(dict(cell.check["limits"]))
        g = compare.step_gaps(start, reset())
        check.add("start_gap", *reversed(harness.widest(g)))
        failed = 0
        for i, s, o, gen_bytes, a, out in kept:
            ag = harness.gap(a, act(o))
            check.add("action_gap", ag, f"step {i}")
            name, worst = harness.widest(compare.step_gaps(
                out, env_step(s, gen_bytes, a)))
            check.add("step_gap", worst, f"step {i} {name}")
            failed += not (ag <= check.limits["action_gap"] and
                           worst <= check.limits["step_gap"])
            check.compared += 1
        return check, failed

    with torch.no_grad():
        check, failed = judge(start, kept)
        stand = {}
        for v in stand_ins:
            if v != "control":
                raise ValueError(f"no stand-in {v!r} for a rollout")
            with precision.tf32():
                low_start = reset()
                low = []
                for i, s, o, gen_bytes, _, _ in kept:
                    la = act(o)
                    low.append((i, s, o, gen_bytes, la,
                                env_step(s, gen_bytes, la)))
            stand[v] = judge(low_start, low)[0]
    return check, stand, failed
