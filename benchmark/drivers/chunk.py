"""Chunked policy loop: the seeded Diffusion Policy
(``algos/diffusion_policy.DiffusionPolicy``) through
``envs/wrappers.ChunkRunner`` over ``env.step`` with autoreset, B envs:
every Ta control steps all envs replan together from fresh noise (DDIM, a
U-Net call a denoising step), and each control step executes the plan's
next action; an env that resets inside a chunk holds the zero residual
until the next replan.

Traffic parameters: ``num_envs``, ``warmup_chunks`` (untimed chunks before
the window: graph captures, cuDNN's first calls), ``trace_chunks`` (chunks
under the profiler after it). The window times whole chunks, a replan and
its Ta control steps each; ``env_steps_per_s`` is control steps × B over
the window. Traced, the program's spans and counters are on for the traced
chunks only (``benchmark/program_trace.py``).

The check holds, against the reference (``reference/diffusion_policy.py``
and the reference env): the reset from the seed (``start_gap``: the env's
state and observation, and the repeated history); at chunk 0 and chunks
drawn from the seed, one U-Net call's ε on the first denoising input, the
noise and the history the program had (``eps_gap``), the whole DDIM sample
from them (``chunk_gap``), each control step's executed action, hold mask
and history from the program's plan, mask, history and step outputs by the
hold rule (``select_gap``), and the env step of the chunk's last control
step from the program's state and action (``step_gap``).
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from benchmark import compare, harness, program_trace

PROGRAM_SPANS = ("policy.diffusion", "policy.diffusion.cond",
                 "policy.diffusion.unet", "policy.diffusion.ddim",
                 "env.chunk")


def build(cell, seed, device):
    from benchmark.reference import diffusion_policy as rdp
    from paddlerobotics_torch.algos.diffusion_policy import (DiffusionConfig,
                                                             DiffusionPolicy)
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.envs.wrappers import ChunkRunner

    cfg = harness.quadruped_config(QuadrupedConfig,
                                   cell.config["quadruped"])
    d = cell.config["diffusion"]
    env = BatchedQuadrupedEnv(cfg, cell.traffic["num_envs"], device=device)
    policy = DiffusionPolicy(DiffusionConfig(
        **dict(d, down_dims=tuple(d["down_dims"]))), device=device)
    weights = rdp.make_weights(d, harness.seeded_generator(seed, 1, device))
    policy.load_state_dict(weights)
    policy.requires_grad_(False)
    runner = ChunkRunner(env, policy,
                         harness.seeded_generator(seed, 3, device))
    return cfg, env, policy, runner, weights


class _FirstCall:
    """A forward hook that keeps the first call's input and output."""

    def __init__(self, module):
        self.seen = None
        self.handle = module.register_forward_hook(self)

    def __call__(self, module, args, out):
        if self.seen is None:
            self.seen = (args[0], args[1], out)
            self.handle.remove()


def run(cell, seed, seconds, trace_on, device, stand_ins=()):
    t = cell.traffic
    cfg, env, policy, runner, weights = build(cell, seed, device)
    Ta = runner.Ta
    gen = harness.seeded_generator(seed, 2, device)
    reset_gen = gen.get_state()
    state, obs = runner.reset(gen)
    start = (state.env_state, obs, state.history)
    spans = harness.Spans(on=trace_on)
    spans.wrap(policy, "predict_action", "policy")
    spans.wrap(env, "step", "env.step")
    picks = set(harness.sample_steps(seed, cell.check["samples"],
                                     cell.check["sample_below"]))
    kept = []
    loop = {"state": state}

    def chunk(i, keep=False):
        rec = {"chunk": i, "steps": []} if keep else None
        for k in range(Ta):
            s = loop["state"]
            if keep and k == 0:
                hook = _FirstCall(policy.model)
                rec["history"] = s.history
            if keep and k == Ta - 1:
                rec["env_in"] = (s.env_state, s.env_state.rng.get_state())
            with torch.no_grad():
                out = runner.step(s)
            loop["state"] = out[0]
            if keep:
                n = out[0]
                rec["steps"].append({
                    "k": k, "held0": s.held,
                    "hist0": s.history, "action": out[4]["action"],
                    "obs": out[1], "done": out[3], "held1": n.held,
                    "hist1": n.history})
                if k == 0:
                    rec["noise"], rec["t"], rec["eps"] = hook.seen
                    rec["plan"] = n.plan
                if k == Ta - 1:
                    rec["env_out"] = (n.env_state,) + tuple(out[1:4])
        if keep:
            kept.append(rec)

    for _ in range(t["warmup_chunks"]):
        chunk(-1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    spans.reset()
    window_start = time.perf_counter()
    chunks, window_s = harness.timed_window(
        seconds, lambda i: chunk(i, keep=i in picks))
    spans_ms = {k: list(v) for k, v in spans.ms.items()}
    tr = None
    if trace_on:
        tr = program_trace.profile(chunk, t["trace_chunks"], spans,
                                   cell.name, PROGRAM_SPANS)
        print(f"{cell.name}: counters over {t['trace_chunks']} traced "
              f"chunks {tr['counters']}", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    B = env.B
    steps = chunks * Ta
    shapes = {"num_envs": B, "n_action_steps": Ta}
    del env, policy, runner, loop
    clipped = torch.cat([(r["plan"].abs() >= 1).flatten() for r in kept])
    print(f"{cell.name}: {100 * float(clipped.float().mean()):.4f}% of the "
          f"kept plans' entries clipped at ±1", file=sys.stderr)
    check, stand_ins, failed = check_chunk(
        cell, weights, reset_gen, start, kept, device, stand_ins)
    return harness.RunResult(
        metrics={"env_steps_per_s": steps * B / window_s},
        check=check, attempted=chunks, failed=failed,
        memory_peak_bytes=peak, window_s=window_s, steps=steps,
        spans=spans_ms, trace=tr, shapes=shapes, stand_ins=stand_ins,
        window_start=window_start)


def check_chunk(cell, weights, reset_gen, start, kept, device,
                stand_ins=()):
    """The check of a chunk run: (its ``Check``, each stand-in's, the kept
    chunks over a limit). The one stand-in is ``control``: the reference in
    TF32 makes the reset, ε, the plan, the selection and the step from the
    program's inputs, in the program's place."""
    from benchmark.reference import config as rconfig
    from benchmark.reference import diffusion_policy as rdp
    from benchmark.reference import precision
    from benchmark.reference.env import BatchedQuadrupedEnv

    rcfg = harness.quadruped_config(rconfig.QuadrupedConfig,
                                    cell.config["quadruped"])
    d = cell.config["diffusion"]
    To = d["n_obs_steps"]
    renv = BatchedQuadrupedEnv(rcfg, cell.traffic["num_envs"], device=device)
    bound = torch.as_tensor(renv.act_bound, device=device)
    offset = torch.as_tensor(renv.act_offset, device=device)
    etg = renv.default_etg()

    def outputs(low: bool):
        """The reference's outputs from the program's inputs, in float32 or
        (``low``) under TF32."""
        mm = rdp.tf32 if low else contextlib.nullcontext
        env_mm = precision.tf32 if low else contextlib.nullcontext
        with env_mm():
            st, obs = renv.reset(compare.generator_at(reset_gen, device))
        out = {"start": (st, obs, obs[:, None].repeat(1, To, 1)),
               "chunks": []}
        for r in kept:
            with mm():
                cond = rdp.global_cond(weights, r["history"], d)
                eps = rdp.unet(weights, r["noise"], r["t"], cond, d)
                plan = rdp.ddim_sample(weights, r["history"], r["noise"], d)
            steps = []
            for s in r["steps"]:
                a = rdp.select(r["plan"], s["held0"], s["k"], d, bound,
                               offset)
                held1, hist1 = rdp.hold_rule(s["held0"], s["k"], s["hist0"],
                                             s["obs"], s["done"])
                steps.append((a, held1, hist1))
            s_in, gen_bytes = r["env_in"]
            with env_mm():
                env_out = renv.step(compare.reference_state(
                    s_in, gen_bytes, device, etg), r["steps"][-1]["action"])
            out["chunks"].append({"eps": eps, "plan": plan, "steps": steps,
                                  "env_out": env_out})
        return out

    def judge(got, want):
        check = harness.Check(dict(cell.check["limits"]))
        g = compare.step_gaps(got["start"][:2], want["start"][:2])
        g["history"] = harness.gap(got["start"][2], want["start"][2])
        check.add("start_gap", *reversed(harness.widest(g)))
        failed = 0
        for r, p, w in zip(kept, got["chunks"], want["chunks"]):
            where = f"chunk {r['chunk']}"
            vals = {"eps_gap": harness.gap(p["eps"], w["eps"]),
                    "chunk_gap": harness.gap(p["plan"], w["plan"])}
            sel = {}
            for s, ps, ws in zip(r["steps"], p["steps"], w["steps"]):
                for name, x, y in zip(("action", "held", "history"), ps, ws):
                    sel[f"step {s['k']} {name}"] = harness.gap(x, y)
            name, vals["select_gap"] = harness.widest(sel)
            step_name, vals["step_gap"] = harness.widest(
                compare.step_gaps(p["env_out"], w["env_out"]))
            for k, v in vals.items():
                extra = {"select_gap": f" {name}",
                         "step_gap": f" {step_name}"}.get(k, "")
                check.add(k, v, where + extra)
            failed += any(not v <= check.limits[k] for k, v in vals.items())
            check.compared += 1
        return check, failed

    program_out = {"start": start, "chunks": [
        {"eps": r["eps"], "plan": r["plan"],
         "steps": [(s["action"], s["held1"], s["hist1"])
                   for s in r["steps"]],
         "env_out": r["env_out"]} for r in kept]}
    with torch.no_grad():
        want = outputs(low=False)
        check, failed = judge(program_out, want)
        stand = {}
        for v in stand_ins:
            if v != "control":
                raise ValueError(f"no stand-in {v!r} for a chunk run")
            stand[v] = judge(outputs(low=True), want)[0]
    return check, stand, failed

