"""Planning policy loop: the seeded TD-MPC2 agent
(``algos/tdmpc2.TDMPC2Planner``) through ``envs/wrappers.PlanRunner`` over
``env.step`` with autoreset, B envs: every control step all envs plan
together by MPPI through the world model (the published budget: samples,
iterations, horizon, elites and policy trajectories of the configuration's
``tdmpc2`` group), and the planned actions run one env step; an env that
resets starts its next plan cold.

Traffic parameters: ``num_envs``, ``warmup_steps`` (untimed control steps
before the window: graph capture, cuBLAS's first calls), ``trace_steps``
(steps under the profiler after it). ``env_steps_per_s`` is control steps ×
B over the window. Traced, the program's spans and counters are on for the
traced steps only (``benchmark/program_trace.py``).

The check holds, against the reference (``reference/tdmpc2.py`` and the
reference env): the reset from the seed (``start_gap``); at step 0 and
steps drawn from the seed, each from the program's own inputs there: the
latent from the observation and the policy trajectories from the latent
and their noise (``encode_gap``), the warm-start mean from the previous
mean and the reset mask (``warm_gap``), the values of iteration 0's and of
one drawn iteration's sequences from the latent, actions and noise
(``value_gap``), those iterations' samples from their mean, std and noise
and their elites, weights, mean and std from their values and actions
(``refit_gap``; the top-k runs on the program's values, so a near-tie in
float32 cannot fail a sound run), the executed action from the final
elites, weights and Gumbel draw (``action_gap``), and the env step from the
program's state and action (``step_gap``).
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from benchmark import compare, harness, program_trace

PROGRAM_SPANS = ("policy.tdmpc2", "policy.tdmpc2.encode",
                 "policy.tdmpc2.pi_trajs", "policy.tdmpc2.value",
                 "policy.tdmpc2.refit", "policy.tdmpc2.select", "env.plan")


def build(cell, seed, device):
    from benchmark.reference import tdmpc2 as rtd
    from paddlerobotics_torch.algos.tdmpc2 import TDMPC2Config, TDMPC2Planner
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.envs.wrappers import PlanRunner

    cfg = harness.quadruped_config(QuadrupedConfig,
                                   cell.config["quadruped"])
    d = cell.config["tdmpc2"]
    env = BatchedQuadrupedEnv(cfg, cell.traffic["num_envs"], device=device)
    planner = TDMPC2Planner(TDMPC2Config(**d), device=device)
    weights = rtd.make_weights(d, harness.seeded_generator(seed, 1, device))
    planner.model.load_state_dict(weights)
    runner = PlanRunner(env, planner,
                        harness.seeded_generator(seed, 3, device))
    return env, planner, runner, weights


class _Recorder:
    """Stands in for ``planner.plan``: an armed call keeps its inputs and
    the plan's inner tensors (the iterations the record names)."""

    def __init__(self, planner):
        self.plan, self.armed = planner.plan, None
        planner.plan = self

    def __call__(self, obs, t0, prev_mean, noise):
        rec, self.armed = self.armed, None
        if rec is None:
            return self.plan(obs, t0, prev_mean, noise)
        rec.update(obs=obs, t0=t0, prev_mean=prev_mean, noise=noise,
                   inner={"iterations": rec["iterations"]})
        a, mean = self.plan(obs, t0, prev_mean, noise, rec["inner"])
        rec["mean"] = mean
        return a, mean


def drawn_iteration(seed: int, step: int, iterations: int) -> int:
    """The iteration besides the first whose numbers a kept step compares."""
    rng = np.random.default_rng([seed % 2 ** 63, 11, step])
    return int(rng.integers(1, iterations)) if iterations > 1 else 0


def run(cell, seed, seconds, trace_on, device, stand_ins=()):
    t = cell.traffic
    env, planner, runner, weights = build(cell, seed, device)
    gen = harness.seeded_generator(seed, 2, device)
    reset_gen = gen.get_state()
    state, obs = runner.reset(gen)
    start = (state.env_state, obs)
    recorder = _Recorder(planner)
    spans = harness.Spans(on=trace_on)
    spans.wrap(planner, "plan", "policy")
    spans.wrap(env, "step", "env.step")
    picks = set(harness.sample_steps(seed, cell.check["samples"],
                                     cell.check["sample_below"]))
    iterations = cell.config["tdmpc2"]["iterations"]
    kept = []
    loop = {"state": state}

    def step(i, keep=False):
        s = loop["state"]
        rec = None
        if keep:
            rec = {"step": i, "iterations": {
                0, drawn_iteration(seed, i, iterations)},
                "env_in": (s.env_state, s.env_state.rng.get_state())}
            recorder.armed = rec
        with torch.no_grad():
            out = runner.step(s)
        loop["state"] = out[0]
        if keep:
            rec["action"] = out[4]["action"]
            rec["env_out"] = (out[0].env_state,) + tuple(out[1:4])
            kept.append(rec)

    for _ in range(t["warmup_steps"]):
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
        tr = program_trace.profile(step, t["trace_steps"], spans, cell.name,
                                   PROGRAM_SPANS)
        print(f"{cell.name}: counters over {t['trace_steps']} traced "
              f"steps {tr['counters']}", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    B = env.B
    shapes = {"num_envs": B}
    del env, planner, runner, loop
    resets = sum(int(r["t0"].sum()) for r in kept)
    print(f"{cell.name}: {resets} of {B * len(kept)} kept plans started "
          f"cold", file=sys.stderr)
    check, stand, failed = check_plan(cell, weights, reset_gen, start, kept,
                                      device, stand_ins)
    return harness.RunResult(
        metrics={"env_steps_per_s": steps * B / window_s},
        check=check, attempted=steps, failed=failed,
        memory_peak_bytes=peak, window_s=window_s, steps=steps,
        spans=spans_ms, trace=tr, shapes=shapes, stand_ins=stand,
        window_start=window_start)


def check_plan(cell, weights, reset_gen, start, kept, device,
               stand_ins=()):
    """The check of a plan run: (its ``Check``, each stand-in's, the kept
    steps over a limit). The one stand-in is ``control``: the reference in
    TF32 makes the reset, the latent, the trajectories, the values, the
    refits, the action and the step from the program's inputs, in the
    program's place."""
    from benchmark.reference import config as rconfig
    from benchmark.reference import precision
    from benchmark.reference import tdmpc2 as rtd
    from benchmark.reference.env import BatchedQuadrupedEnv

    rcfg = harness.quadruped_config(rconfig.QuadrupedConfig,
                                    cell.config["quadruped"])
    d = cell.config["tdmpc2"]
    P = d["num_pi_trajs"]
    renv = BatchedQuadrupedEnv(rcfg, cell.traffic["num_envs"], device=device)
    bound = torch.as_tensor(renv.act_bound, device=device)
    offset = torch.as_tensor(renv.act_offset, device=device)
    etg = renv.default_etg()

    def fit_parts(fit: dict):
        """A refit's compared tensors, by name."""
        return {k: fit[k] for k in ("elite_value", "elite_actions", "score",
                                    "mean", "std")}

    def outputs(low: bool):
        """The reference's outputs from the program's inputs, in float32 or
        (``low``) under TF32."""
        mm = rtd.tf32 if low else contextlib.nullcontext
        env_mm = precision.tf32 if low else contextlib.nullcontext
        with env_mm():
            out = {"start": renv.reset(compare.generator_at(reset_gen,
                                                             device)),
                   "steps": []}
        for r in kept:
            inner, noise = r["inner"], r["noise"]
            with mm():
                z = rtd.encode(weights, r["obs"], d)
                trajs = rtd.pi_trajectories(weights, inner["z"],
                                            noise.pi_trajs, d)
                iters = {}
                for i, it in inner["iters"].items():
                    value = rtd.estimate_value(
                        weights, inner["z"], it["actions"], noise.pi_value[i],
                        noise.q_pair[i], d).nan_to_num(0)
                    iters[i] = {"value": value, "samples": rtd.sample(
                        it["mean"], it["std"], noise.samples[i]),
                        **fit_parts(rtd.refit(it["value"], it["actions"], d))}
            fit = inner["refit"]
            action = rtd.select(fit.elite_actions, fit.score,
                                noise.gumbel) * bound + offset
            s_in, gen_bytes = r["env_in"]
            with env_mm():
                env_out = renv.step(compare.reference_state(
                    s_in, gen_bytes, device, etg), r["action"])
            out["steps"].append({
                "z": z, "trajs": trajs,
                "warm": rtd.warm_start(r["prev_mean"], r["t0"]),
                "iters": iters, "action": action, "env_out": env_out})
        return out

    def judge(got, want):
        check = harness.Check(dict(cell.check["limits"]))
        check.add("start_gap", *reversed(harness.widest(
            compare.step_gaps(got["start"], want["start"]))))
        failed = 0
        for r, p, w in zip(kept, got["steps"], want["steps"]):
            where = f"step {r['step']}"
            enc = {"z": harness.gap(p["z"], w["z"]),
                   "pi_trajs": harness.gap(p["trajs"], w["trajs"])}
            value, fits = {}, {}
            for i, pi in p["iters"].items():
                wi = w["iters"][i]
                value[f"iteration {i}"] = harness.gap(pi["value"],
                                                      wi["value"])
                for k in ("samples", "elite_value", "elite_actions", "score",
                          "mean", "std"):
                    fits[f"iteration {i} {k}"] = harness.gap(pi[k], wi[k])
            names = {}
            vals = {}
            for key, gaps in (("encode_gap", enc), ("value_gap", value),
                              ("refit_gap", fits)):
                names[key], vals[key] = harness.widest(gaps)
            vals["warm_gap"] = harness.gap(p["warm"], w["warm"])
            vals["action_gap"] = harness.gap(p["action"], w["action"])
            names["step_gap"], vals["step_gap"] = harness.widest(
                compare.step_gaps(p["env_out"], w["env_out"]))
            for k, v in vals.items():
                check.add(k, v, where + (f" {names[k]}" if k in names
                                         else ""))
            failed += any(not v <= check.limits[k] for k, v in vals.items())
            check.compared += 1
        return check, failed

    def program_step(r):
        inner = r["inner"]
        iters = {i: {"value": it["value"],
                     "samples": it["actions"][:, :, P:],
                     **fit_parts(it["fit"]._asdict())}
                 for i, it in inner["iters"].items()}
        return {"z": inner["z"], "trajs": inner["pi_actions"],
                "warm": inner["mean0"], "iters": iters,
                "action": r["action"], "env_out": r["env_out"]}

    program_out = {"start": start,
                   "steps": [program_step(r) for r in kept]}
    with torch.no_grad():
        want = outputs(low=False)
        check, failed = judge(program_out, want)
        stand = {}
        for v in stand_ins:
            if v != "control":
                raise ValueError(f"no stand-in {v!r} for a plan run")
            stand[v] = judge(outputs(low=True), want)[0]
    return check, stand, failed
