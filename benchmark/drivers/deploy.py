"""One robot's paced control loop: an open loop of ticks due every ``dt_s``
(26 ms, 38 Hz), each ``SimRobotIO.read_state`` → ``DeployPolicy(obs, i)`` →
``SimRobotIO.apply_action`` (one B=1 env step), as
``deploy/realtime.run_control_loop`` runs it (deployment/test.py:93-103),
then the next observation brought to the host.

A tick's latency runs from its due time on the fixed schedule to the moment
its targets are applied and the next observation is on the host, so a late
tick also delays the ticks after it. ``tick_p95_ms`` is the 95th
percentile over every tick of the window.

Traffic parameters: ``num_envs`` (1), ``dt_s``, ``gait_steps`` (the
exported gait table's rows), ``warmup_ticks`` (unpaced, before the
window), ``trace_ticks`` (paced, under the profiler after it),
``env_overrides`` (the simulator's settings on top of the configuration:
``step_y`` 0 passes the targets through unchanged).

The check holds, against the reference: the simulator's reset from the seed
(``start_gap``); at the ticks drawn from the seed, the policy's targets
(``target_gap``, the reference's gait table and actor on the same
observation and index) and the env step from the program's state and
targets (``step_gap``).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchmark import compare, harness, trace as trace_mod


def run(cell, seed, seconds, trace_on, device, stand_ins=()):
    from paddlerobotics_torch.algos.networks import Actor
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.deploy import policy_export, realtime
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.etg import fit

    t = cell.traffic
    dt = float(t["dt_s"])
    cfg = harness.quadruped_config(QuadrupedConfig, cell.config["quadruped"])
    sim_cfg = harness.quadruped_config(QuadrupedConfig,
                                       cell.config["quadruped"],
                                       t["env_overrides"])
    env = BatchedQuadrupedEnv(sim_cfg, t["num_envs"], device=device)
    actor = Actor(env.obs_dim, env.action_dim, hidden=cfg.sac.hidden_dim,
                  device=device)
    weights = harness.make_params(actor, harness.seeded_generator(
        seed, 1, device))
    harness.load_params(actor, weights)
    w0, b0 = fit.opt_with_points(cfg.etg, device=device)
    table = policy_export.export_gait_table(cfg, w0, b0, t["gait_steps"],
                                            device=device)
    policy = policy_export.export_policy_fn(actor, table, env.act_bound,
                                            device=device)
    gen = harness.seeded_generator(seed, 2, device)
    reset_gen = gen.get_state()
    io = realtime.SimRobotIO(env, generator=gen)
    start = (io.state, io.obs)
    spans = harness.Spans(on=trace_on)
    picks = set(harness.sample_steps(seed, cell.check["samples"],
                                     cell.check["sample_below"]))
    kept = []
    pacer = harness.Pacer(dt)
    lat_ms, work_s = [], []     # per paced tick: latency, work seconds

    def tick(i, paced=True, keep=False):
        if paced:
            with spans.span("sleep"):
                due = pacer.wait(i)
        t0 = time.perf_counter()
        s, gen_bytes = io.state, (io.state.rng.get_state() if keep
                                  else None)
        with torch.no_grad():
            obs = io.read_state()["obs"]
            with spans.span("policy"):
                target = policy(obs, i)
            with spans.span("env.step"):
                io.apply_action(target)
            with spans.span("obs.to_host"):
                io.obs[0].cpu()
        if paced:
            lat_ms.append(pacer.latency_ms(due))
            work_s.append(time.perf_counter() - t0)
        if keep:
            kept.append((i, s, obs, gen_bytes, target, (io.state, io.obs)))

    for i in range(t["warmup_ticks"]):
        tick(i, paced=False)
    spans.reset()
    window_start = pacer.start()
    ticks, window_s = harness.timed_window(
        seconds, lambda i: tick(i, keep=i in picks))
    spans_ms = {k: list(v) for k, v in spans.ms.items()}
    p95 = float(np.percentile(lat_ms, 95))
    step_s = statistics.fmean(work_s)
    tr = None
    if trace_on:
        base = ticks + 1

        def traced(i):
            if i == 0:     # the profiler's first, untimed tick: due now
                pacer.start(time.perf_counter() - base * dt)
            tick(base + i)

        tr = trace_mod.profile(traced, t["trace_ticks"], spans, cell.name,
                               rest=("sleep",))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    shapes = {"num_envs": env.B, "obs_dim": env.obs_dim,
              "action_dim": env.action_dim, "hidden": cfg.sac.hidden_dim,
              "ring_rows": env._hist_len}
    act_bound = env.act_bound
    del env, io, policy, actor
    check, stand_ins, failed = check_deploy(
        cell, weights, act_bound, reset_gen, start, kept, device, stand_ins)
    return harness.RunResult(
        metrics={"tick_p95_ms": p95}, check=check, attempted=ticks,
        failed=failed, memory_peak_bytes=peak, window_s=window_s,
        steps=ticks, spans=spans_ms, trace=tr, shapes=shapes,
        stand_ins=stand_ins, window_start=window_start,
        step_s=step_s)


def check_deploy(cell, weights, act_bound, reset_gen, start, kept, device,
                 stand_ins=()):
    """The check of a deploy run: (its ``Check``, each stand-in's, the kept
    ticks over a limit). The one stand-in is ``control``: the reference in
    TF32 makes the reset, the gait table, the targets and the step from the
    program's inputs, in the program's place."""
    from benchmark.reference import config as rconfig
    from benchmark.reference import deploy, etg_fit, networks, precision
    from benchmark.reference.env import BatchedQuadrupedEnv

    t = cell.traffic
    cfg = harness.quadruped_config(rconfig.QuadrupedConfig,
                                   cell.config["quadruped"])
    sim_cfg = harness.quadruped_config(rconfig.QuadrupedConfig,
                                       cell.config["quadruped"],
                                       t["env_overrides"])
    env = BatchedQuadrupedEnv(sim_cfg, t["num_envs"], device=device)
    actor = networks.Actor(env.obs_dim, env.action_dim,
                           hidden=cfg.sac.hidden_dim, device=device)
    harness.load_params(actor, weights).requires_grad_(False)
    H = sim_cfg.etg.H
    zero = (torch.zeros((3, H, env.B), device=device),
            torch.zeros((3, env.B), device=device))

    def reset():
        return env.reset(compare.generator_at(reset_gen, device),
                         etg_w=zero[0], etg_b=zero[1])

    def policy():
        w0, b0 = etg_fit.opt_with_points(cfg.etg, device=device)
        table = deploy.gait_table(cfg, w0, b0, t["gait_steps"])
        return deploy.DeployPolicy(actor, table, act_bound, device)

    def env_step(s, gen_bytes, target):
        rin = compare.reference_state(s, gen_bytes, device, zero)
        return env.step(rin, deploy.residual_action(target, env.B),
                        autoreset=False)[:2]

    def judge(start, kept, pol):
        check = harness.Check(dict(cell.check["limits"]))
        g = compare.step_gaps(start, reset())
        check.add("start_gap", *reversed(harness.widest(g)))
        failed = 0
        for i, s, obs, gen_bytes, target, out in kept:
            tg = harness.gap(target, pol(obs, i))
            check.add("target_gap", tg, f"tick {i}")
            name, worst = harness.widest(compare.step_gaps(
                out, env_step(s, gen_bytes, target)))
            check.add("step_gap", worst, f"tick {i} {name}")
            failed += not (tg <= check.limits["target_gap"] and
                           worst <= check.limits["step_gap"])
            check.compared += 1
        return check, failed

    with torch.no_grad():
        pol = policy()
        check, failed = judge(start, kept, pol)
        stand = {}
        for v in stand_ins:
            if v != "control":
                raise ValueError(f"no stand-in {v!r} for the deploy loop")
            with precision.tf32():
                low_start = reset()
                low_pol = policy()
                low = []
                for i, s, obs, gen_bytes, _, _ in kept:
                    lt = low_pol(obs, i)
                    low.append((i, s, obs, gen_bytes, lt,
                                env_step(s, gen_bytes, lt)))
            stand[v] = judge(low_start, low, pol)[0]
    return check, stand, failed
