"""The fused rollout+learn loop: ``ETGRLTrainer.rollout_chunk`` with K SAC
updates per control step, as training runs it between ES and eval phases
(ETGRL/train.py:137-160), both of which lie out of reach here.

Set-up builds the trainer, starts it from the seed (``init_carry``) with the
benchmark's weights, runs the reference's warm-up (``warmup_env_steps`` of
uniform and gait actions, in whole control steps) and then the first
learning control step through the window's own call. The window goes on
with the same trainer, ``chunk_steps`` control steps to a call.

Traffic parameters: ``num_envs``, ``updates_per_step``, ``warmup_env_steps``,
``e_step`` (the episode cap), ``chunk_steps``, ``trace_steps`` (control
steps under the profiler after the window).

The check has two parts. From the seed, the reference's training step
(``reference/trainer.py``) follows the trainer through the warm-up and the
first learning control step: the replay rows (``rows_gap``: reset, env
steps, replay write) and the first ``updates_compared`` updates, each
critic and actor loss (``loss_gap``), each leaf's first gradient as Adam got
it (``grad_gap``) and each leaf's change after them (``change_gap``). In the
window, at the updates drawn from the seed (update 0 and ``samples`` below
``sample_below``), the learner's inputs are kept (weights, target, Adam's
moments, the sampled batch, the generator that draws the noise) with its
outputs; after the window the reference's ``SAC.learn`` makes the same
update from the same inputs: the losses (``window_loss_gap``), each leaf's
gradient as Adam got it, from its moments before and after
(``window_grad_gap``), and each leaf's change, the target's with it
(``window_change_gap``). Norms are compared leaf by leaf, as the gap of the
leaf's norms over the larger of the reference's norm of that leaf and of the
median leaf. Leaves whose reference gradient is under a thousandth of the
median leaf's are left out.

A stand-in (``control``: the reference in TF32; ``fault:half_batch``,
``fault:altered_reward``: the reference with the fault planted) makes the
from-seed rows and updates and the window's updates in the program's place,
from the same inputs, and is judged by the same check.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark import compare, harness, trace as trace_mod


def _leaves(state):
    return [p for m in (state.actor, state.critic) for p in m.parameters()]


def _weights(state):
    """The actor's, the critic's and the target's leaves, in that order."""
    return [p for m in (state.actor, state.critic, state.target_critic)
            for p in m.parameters()]


def _adam_leaves(state):
    """(optimizer, its group, leaf) of each actor and critic leaf."""
    return [(opt, g, p) for opt in (state.actor_opt, state.critic_opt)
            for g in opt.param_groups for p in g["params"]]


def snapshot(state) -> dict:
    """The learner's weights (``_weights``) and Adam's state and β1 of each
    actor and critic leaf, cloned."""
    adam = _adam_leaves(state)
    return {"weights": [p.detach().clone() for p in _weights(state)],
            "adam": [{k: v.clone() for k, v in opt.state.get(p, {}).items()}
                     for opt, _, p in adam],
            "beta1": [g["betas"][0] for _, g, _ in adam]}


@torch.no_grad()
def restore(state, snap: dict) -> None:
    """Load a ``snapshot`` into a learner state of the same shapes."""
    for p, w in zip(_weights(state), snap["weights"], strict=True):
        p.copy_(w)
    for (opt, _, p), st in zip(_adam_leaves(state), snap["adam"],
                               strict=True):
        opt.state[p] = {k: v.clone() for k, v in st.items()}


def capture(learn, state_of, n: int):
    """A stand-in for ``learn`` that records each update's losses, the
    gradients after the first and the weights after the n-th."""
    from benchmark.reference.trainer import adam_grads

    rec = {"losses": [], "grads": None, "weights": None}

    def learn_and_read(state, batch, *a, **k):
        out = learn(state, batch, *a, **k)
        i = len(rec["losses"])
        rec["losses"].append(torch.stack([out["critic_loss"],
                                          out["actor_loss"]]).detach())
        if i == 0:
            st = state_of()
            rec["grads"] = [g.clone() for g in adam_grads(st.actor_opt)
                            + adam_grads(st.critic_opt)]
        if i == n - 1:
            rec["weights"] = [p.detach().clone() for p in _leaves(state)]
        return out

    return rec, learn_and_read


def keep_updates(learn, picks):
    """A stand-in for ``learn`` that keeps, at each update whose index is
    in ``picks``, the learner's inputs (state before, batch, noise, the
    generator's position) and its outputs (state after, losses)."""
    kept = []
    count = [0]

    def learn_and_keep(state, batch, noise=None, generator=None):
        i = count[0]
        count[0] += 1
        if i not in picks:
            return learn(state, batch, noise=noise, generator=generator)
        cap = {"update": i, "before": snapshot(state), "batch": batch,
               "noise": noise, "gen": generator.get_state()}
        out = learn(state, batch, noise=noise, generator=generator)
        cap["after"] = snapshot(state)
        cap["losses"] = torch.stack([out["critic_loss"],
                                     out["actor_loss"]]).detach()
        kept.append(cap)
        return out

    return kept, learn_and_keep


def run(cell, seed, seconds, trace_on, device, stand_ins=()):
    from paddlerobotics_torch.core.config import QuadrupedConfig
    from paddlerobotics_torch.train.etg_rl import ETGRLTrainer

    t = cell.traffic
    B, K, e_step = t["num_envs"], t["updates_per_step"], t["e_step"]
    n_cmp = cell.check["updates_compared"]
    cfg = harness.quadruped_config(QuadrupedConfig, cell.config["quadruped"])
    outdir = str(harness.scratch_dir() / "benchmark_train_log")
    tr = ETGRLTrainer(cfg, num_envs=B, outdir=outdir, updates_per_step=K,
                      device=device)
    tr.logger.close()
    carry, _, _ = tr.init_carry(seed)
    st = carry.sac_state
    g = harness.seeded_generator(seed, 1, device)
    actor_w = harness.make_params(st.actor, g)
    critic_w = harness.make_params(st.critic, g)
    harness.load_params(st.actor, actor_w)
    harness.load_params(st.critic, critic_w)
    harness.load_params(st.target_critic, critic_w)
    cold = math.ceil(t["warmup_env_steps"] / B)
    tr.rollout_chunk(carry, e_step, cold, False)
    rec, tr.sac.learn = capture(tr.sac.learn, lambda: carry.sac_state,
                                n_cmp)
    tr.rollout_chunk(carry, e_step, 1, True)
    del tr.sac.learn                      # the class's method again
    rows = carry.buffer.data[:(cold + 1) * B].clone()
    picks = set(harness.sample_steps(seed, cell.check["samples"],
                                     cell.check["sample_below"]))
    kept, tr.sac.learn = keep_updates(tr.sac.learn, picks)
    spans = harness.Spans(on=trace_on)
    spans.wrap(tr.env, "step", "env.step")
    spans.wrap(tr.sac, "learn", "sac.learn")
    chunk = t["chunk_steps"]

    def step(i):
        with spans.span("rollout_chunk"):
            tr.rollout_chunk(carry, e_step, chunk, True)

    if device.type == "cuda":
        torch.cuda.synchronize()
    window_start = time.perf_counter()
    calls, window_s = harness.timed_window(seconds, step)
    steps = calls * chunk
    spans_ms = dict(spans.ms)
    trace = None
    if trace_on:
        trace = trace_mod.profile(
            lambda i: tr.rollout_chunk(carry, e_step, 1, True),
            t["trace_steps"], spans, cell.name)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    shapes = {"num_envs": B, "obs_dim": tr.env.obs_dim,
              "action_dim": tr.env.action_dim, "hidden": cfg.sac.hidden_dim,
              "ring_rows": tr.env._hist_len, "updates_per_step": K,
              "batch_size": cfg.sac.batch_size}
    del tr, carry, st
    check, stand_ins = check_train(cell, seed, actor_w, critic_w,
                                   (rows, rec, kept), device, stand_ins)
    return harness.RunResult(
        metrics={"train_env_steps_per_s": steps * B / window_s},
        check=check, attempted=steps, failed=int(not check.correct),
        memory_peak_bytes=peak, window_s=window_s, steps=steps,
        spans=spans_ms, trace=trace, shapes=shapes, stand_ins=stand_ins,
        window_start=window_start)


def _half(batch):
    half = batch["obs"].shape[0] // 2
    return {f: v[:half] for f, v in batch.items()}


def follow(cell, seed, actor_w, critic_w, device, fault=None):
    """The reference trainer from the seed through the warm-up and the
    first learning control step; returns (replay rows, record). ``fault``
    plants one of a training step's faults in it."""
    from benchmark.reference import config as rconfig
    from benchmark.reference.trainer import Trainer

    t = cell.traffic
    B = t["num_envs"]
    cfg = harness.quadruped_config(rconfig.QuadrupedConfig,
                                   cell.config["quadruped"])
    rt = Trainer(cfg, B, t["updates_per_step"], device)
    rc = rt.init(seed, actor_w, critic_w)
    cold = math.ceil(t["warmup_env_steps"] / B)
    for _ in range(cold):
        rt.step(rc, t["e_step"], False)
    learn = rt.learn
    if fault == "half_batch":
        def learn(state, batch, *a, **k):
            return rt.sac.learn(state, _half(batch), *a, **k)
    elif fault == "altered_reward":
        env_step = rt.env.step

        def altered(*a, **k):
            # one env's reward, off by 1 where the step produces it
            out = list(env_step(*a, **k))
            out[2] = out[2].clone()
            out[2][0] += 1.0
            return tuple(out)
        rt.env.step = altered
    rec, rt.learn = capture(learn, lambda: rc.sac_state,
                            cell.check["updates_compared"])
    rt.step(rc, t["e_step"], True)
    return rc.buffer.data[:(cold + 1) * B].clone(), rec


def window_updates(cell, kept, device, fault=None):
    """The reference's ``SAC.learn`` at each kept update, from the
    program's inputs there: the kept records with the reference's state
    after and losses. ``fault`` ``half_batch`` plants that fault."""
    from benchmark.reference import config as rconfig
    from benchmark.reference.sac import SAC

    cfg = harness.quadruped_config(rconfig.QuadrupedConfig,
                                   cell.config["quadruped"])
    out = []
    for cap in kept:
        b = cap["batch"]
        sac = SAC(b["obs"].shape[1], b["act"].shape[1], cfg.sac,
                  device=device)
        st = sac.init(None)
        restore(st, cap["before"])
        gen = compare.generator_at(cap["gen"], device)
        o = sac.learn(st, _half(b) if fault == "half_batch" else b,
                      noise=cap["noise"], generator=gen)
        out.append(dict(cap, after=snapshot(st), losses=torch.stack(
            [o["critic_loss"], o["actor_loss"]]).detach()))
    return out


def leaf_gap(p, r, keep, what):
    """The widest gap of the leaves' norms in ``keep``, each over the
    larger of the reference's norm of that leaf and of the median kept
    leaf; (gap, where)."""
    pn, rn = [float(x.norm()) for x in p], [float(x.norm()) for x in r]
    med = statistics.median(rn[i] for i in keep)
    return max((abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30),
                f"{what} of leaf {i}") for i in keep)


def kept_leaves(grads):
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more."""
    gr = [float(g.norm()) for g in grads]
    med = statistics.median(gr)
    return [i for i, x in enumerate(gr) if x >= 1e-3 * med]


def seed_gaps(rows_p, rec_p, rows_r, rec_r, initial, n):
    """The four numbers of the check from the seed, with where each is
    widest."""
    out = {"rows_gap": (harness.gap(rows_p, rows_r), "replay rows")}
    if len(rec_p["losses"]) < n:
        out["loss_gap"] = (math.inf, "fewer updates than compared")
    else:
        out["loss_gap"] = max(
            (harness.gap(rec_p["losses"][k][j], rec_r["losses"][k][j]),
             f"update {k} {('critic', 'actor')[j]} loss")
            for k in range(n) for j in range(2))
    keep = kept_leaves(rec_r["grads"])
    left = f"({len(rec_r['grads']) - len(keep)} of " \
           f"{len(rec_r['grads'])} leaves left out)"
    out["grad_gap"] = leaf_gap(rec_p["grads"], rec_r["grads"], keep,
                               f"gradient {left}")
    if rec_p["weights"] is None:
        out["change_gap"] = (math.inf, "no weights after the updates")
    else:
        dp = [w - w0 for w, w0 in zip(rec_p["weights"], initial)]
        dr = [w - w0 for w, w0 in zip(rec_r["weights"], initial)]
        out["change_gap"] = leaf_gap(dp, dr, keep, "change")
    return out


def adam_step_grads(cap):
    """Each actor and critic leaf's gradient as Adam got it in the kept
    update, from its first moment before and after: (m1 − β1·m0)/(1 − β1);
    a moment Adam never made is zero."""
    def m(st, like):
        return st.get("exp_avg", torch.zeros_like(like))

    return [(m(a, w) - b1 * m(b, w)) / (1.0 - b1)
            for b, a, b1, w in zip(cap["before"]["adam"],
                                   cap["after"]["adam"],
                                   cap["before"]["beta1"],
                                   cap["before"]["weights"])]


def window_gaps(kept_p, kept_r):
    """The three numbers of the check in the window, with where each is
    widest."""
    names = ("window_loss_gap", "window_grad_gap", "window_change_gap")
    if not kept_p:
        return {k: (math.inf, "no update of the window kept") for k in names}
    out = {k: (-math.inf, "") for k in names}
    for p, r in zip(kept_p, kept_r):
        u = p["update"]
        loss = max((harness.gap(p["losses"][j], r["losses"][j]),
                    f"window update {u} {('critic', 'actor')[j]} loss")
                   for j in range(2))
        gp, gr = adam_step_grads(p), adam_step_grads(r)
        keep = kept_leaves(gr)
        grad = leaf_gap(gp, gr, keep, f"window update {u} gradient")
        # the target's leaves follow the critic's: kept where the critic's
        # leaf is
        n_ac, n_actor = len(gr), len(gr) - (len(p["before"]["weights"])
                                            - len(gr))
        keep_w = keep + [n_ac + i - n_actor for i in keep if i >= n_actor]
        w0 = p["before"]["weights"]
        dp = [w - x for w, x in zip(p["after"]["weights"], w0)]
        dr = [w - x for w, x in zip(r["after"]["weights"], w0)]
        change = leaf_gap(dp, dr, keep_w, f"window update {u} change")
        for k, v in zip(names, (loss, grad, change)):
            if not v[0] <= out[k][0]:
                out[k] = v
    return out


def check_train(cell, seed, actor_w, critic_w, record, device,
                stand_ins=()):
    """The check of a train run: (its ``Check``, each stand-in's).
    ``record`` is the program's (replay rows, from-seed updates, kept
    window updates)."""
    from benchmark.reference import precision

    n = cell.check["updates_compared"]
    initial = [w.to(device) for w in actor_w + critic_w]
    kept = record[2]
    rows_r, rec_r = follow(cell, seed, actor_w, critic_w, device)
    kept_r = window_updates(cell, kept, device)

    def judge(rows, rec, kept_p):
        check = harness.Check(dict(cell.check["limits"]))
        gaps = seed_gaps(rows, rec, rows_r, rec_r, initial, n)
        gaps.update(window_gaps(kept_p, kept_r))
        for name, (v, where) in gaps.items():
            check.add(name, v, where)
        check.compared = 1 + len(kept_p)
        return check

    stand = {}
    for v in stand_ins:
        if v == "control":
            with precision.tf32():
                rows_v, rec_v = follow(cell, seed, actor_w, critic_w,
                                       device)
                kept_v = window_updates(cell, kept, device)
        elif v.startswith("fault:"):
            fault = v.split(":", 1)[1]
            rows_v, rec_v = follow(cell, seed, actor_w, critic_w, device,
                                   fault=fault)
            kept_v = window_updates(cell, kept, device, fault=fault)
        else:
            raise ValueError(f"no stand-in {v!r} for training")
        stand[v] = judge(rows_v, rec_v, kept_v)
    return judge(*record), stand
