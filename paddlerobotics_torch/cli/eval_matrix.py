"""Task-matrix trainer/evaluator (PyTorch port of the JAX package's
``cli/eval_matrix.py``): the reference eval protocol as a command.

The reference ships "well-trained ETG and neural network model in nine
tasks" (ETGRL/README.md) and its eval protocol is a deterministic
(mean-action) 600-step episode with the agent restored from a checkpoint
(run_evaluate_episodes + --load, train.py:182-211, 333-343). This CLI
reproduces both directions:

    # score existing checkpoints (one dir per task under --root)
    python -m paddlerobotics_torch.cli.eval_matrix --root matrix

    # train every task from its registered preset, checkpoint, and eval
    python -m paddlerobotics_torch.cli.eval_matrix --root matrix \\
        --train --budget 20000000

Results land in <root>/matrix.json; --md prints the markdown table. Runs
on the card (``--device cuda``, the default) with the physics kernel, or
with ``--device cpu`` on the plain physics; checkpoints are the trainer's
``itr_<step>.pt`` files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from paddlerobotics_torch.core.config import (ESConfig, QuadrupedConfig,
                                              RewardConfig, SACConfig,
                                              TaskConfig, TrainConfig)
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.envs.registry import TASK_PRESETS
from paddlerobotics_torch.etg import seeds as etg_seeds
from paddlerobotics_torch.sim.terrain import TASK_MODES
from paddlerobotics_torch.train import checkpoints
from paddlerobotics_torch.train.etg_rl import ETGRLTrainer


def _preset(mode: str, overrides: dict | None) -> dict:
    preset = dict(TASK_PRESETS.get(mode, {}))
    preset.update(overrides or {})
    return preset


def build_task_config(mode: str, eval_steps: int = 600,
                      num_envs_default: int = 4096,
                      use_pallas: bool = True,
                      overrides: dict | None = None):
    """Per-task QuadrupedConfig from envs/registry.TASK_PRESETS, the single
    source the matrix trainer and evaluator share, so a restored checkpoint
    is scored in the env it was trained in. Returns (config, num_envs,
    updates_per_step)."""
    preset = _preset(mode, overrides)
    nb = preset.get("num_envs", num_envs_default)
    ups = preset.get("updates_per_step", 4)
    base = QuadrupedConfig()
    # temporal obs modes (SENSOR_MODE['RNN'], train.py:273-277) and DR
    # toggles, overridable per arm
    sensors = dataclasses.replace(
        base.sensors,
        rnn_mode=preset.get("rnn_mode", base.sensors.rnn_mode),
        rnn_time_steps=preset.get("rnn_time_steps",
                                  base.sensors.rnn_time_steps),
        rnn_time_interval=preset.get("rnn_time_interval",
                                     base.sensors.rnn_time_interval))
    random = dataclasses.replace(
        base.random,
        random_dynamics=bool(preset.get("random_dynamics",
                                        base.random.random_dynamics)),
        dynamics_scale=preset.get("dynamics_scale",
                                  base.random.dynamics_scale))
    task_kw = {k: preset[k] for k in ("beam_width", "step_height",
                                      "step_width", "slope")
               if k in preset}
    cfg = QuadrupedConfig(
        sim=dataclasses.replace(base.sim, use_pallas=use_pallas),
        sensors=sensors,
        random=random,
        etg=dataclasses.replace(
            base.etg, step_y=preset.get("step_y", base.etg.step_y)),
        sac=SACConfig(warmup_steps=preset.get("warmup_steps", 200_000),
                      ln_critic=preset.get("ln_critic", False),
                      critic_reset_steps=preset.get("critic_reset_steps", 0),
                      det_rollout_frac=preset.get("det_frac", 0.0),
                      alpha_anneal_steps=preset.get("alpha_anneal_steps", 0),
                      alpha_final=preset.get("alpha_final", 0.05),
                      bf16_matmul=bool(preset.get("bf16_matmul", False))),
        reward=RewardConfig(lateral=preset.get("lateral", 0.0),
                            vel_d=preset.get("vel_d", 0.5)),
        # ES at the wall-ratio-preserving cadence (400·B)
        es=ESConfig(es_every_steps=400 * nb),
        task=TaskConfig(task_mode=mode, **task_kw),
        train=TrainConfig(num_envs=nb,
                          eval_every_steps=(4_000_000
                                            if preset.get("keep_best_eval")
                                            else 10**10),
                          e_step=400, eval_episode_len=eval_steps,
                          spawn_x_max=preset.get("spawn_x_max", 0.0),
                          spawn_x_frac=preset.get("spawn_x_frac", 0.5),
                          spawn_y=preset.get("spawn_y", 0.0),
                          spawn_yaw=preset.get("spawn_yaw", 0.0),
                          keep_best_eval=bool(
                              preset.get("keep_best_eval", 0))),
    )
    return cfg, nb, ups


def _tail(xs, n=8):
    xs = xs[-n:]
    return round(sum(xs) / max(len(xs), 1), 3)


def _eval_row(trainer, actor, w, b, eval_steps: int) -> dict:
    """The deterministic eval (train.py:182-211) as a matrix row's
    columns."""
    ret, steps, infos = trainer.evaluate(actor, w, b, eval_steps)
    steps_f = max(float(steps), 1.0)
    return {"eval_velx": round(float(infos["velx"]) / steps_f, 3),
            "eval_success": round(float(infos["success"]) / steps_f, 3),
            "eval_return": round(float(ret), 2),
            "eval_steps": round(steps_f, 1)}


def _restore_and_eval(trainer, outdir: str, eval_steps: int) -> dict:
    """Restore the newest ``itr_<step>.pt`` under ``outdir`` and run the
    deterministic eval (train.py:333-343 + 182-211)."""
    step = checkpoints.latest_step(outdir)
    if step is None:
        raise FileNotFoundError(
            f"no itr_* checkpoint under {outdir} — train first "
            f"(--train, or cli.train_quadruped --outdir)")
    restored = checkpoints.restore(os.path.join(outdir, f"itr_{step}"),
                                   device=trainer.device)
    sac_state = trainer.sac.init(None)
    checkpoints.load_sac_state(sac_state, restored["sac"])
    w, b = trainer.fit_etg(restored["etg_param"])
    return _eval_row(trainer, sac_state.actor, w, b, eval_steps)


def run_task(mode: str, root: str, train: bool, budget: int,
             eval_steps: int, overrides: dict | None = None,
             seed: int = 0, device: str | torch.device | None = None
             ) -> dict:
    """Train (``train``) or restore, then evaluate one task; returns its
    matrix row. The card runs the physics kernel; ``device="cpu"`` the
    plain physics."""
    dev = resolve_device(device)
    cfg, nb, ups = build_task_config(
        mode, eval_steps=eval_steps, use_pallas=dev.type == "cuda",
        overrides=overrides)
    outdir = os.path.join(root, mode)
    os.makedirs(outdir, exist_ok=True)
    preset = _preset(mode, overrides)
    trainer = ETGRLTrainer(cfg, num_envs=nb, outdir=outdir,
                           updates_per_step=ups, device=dev)
    seed_param = (None if preset.get("ETG_path") == "None"
                  else etg_seeds.load_seed_param(mode))
    row = {"task": mode,
           "schedule": f"B={nb}/K={ups}"
                       + ("/LN" if cfg.sac.ln_critic else "")
                       + ("/seed" if seed_param is not None else "")}

    if train:
        t0 = time.time()
        carry, (w, b, p) = trainer.train(
            max_steps=budget, chunk_steps=50, checkpoint=False, seed=seed,
            init_etg_param=seed_param)
        row["wall_s"] = round(time.time() - t0, 1)
        # final-state checkpoint so eval mode can re-score later
        checkpoints.save(outdir, carry.sac_state, w, b, p, budget)
        velx, succ = [], []
        with open(os.path.join(outdir, "metrics.jsonl")) as f:
            for line in f:
                d = json.loads(line)
                if d["tag"] == "train/mean_velx":
                    velx.append(d["value"])
                elif d["tag"] == "train/mean_success":
                    succ.append(d["value"])
        row.update(train_velx=_tail(velx), train_success=_tail(succ))
        row.update(_eval_row(trainer, carry.sac_state.actor, w, b,
                             eval_steps))
    else:
        row.update(_restore_and_eval(trainer, outdir, eval_steps))
    return row


def to_markdown(rows) -> str:
    head = ("| task | schedule | eval velx | eval succ | eval steps |\n"
            "|---|---|---|---|---|")
    body = "\n".join(
        f"| {r['task']} | {r.get('schedule', '?')} | "
        f"{r.get('eval_velx', '—')} | {r.get('eval_success', '—')} | "
        f"{r.get('eval_steps', '—')} |"
        for r in rows if "error" not in r)
    return head + "\n" + body


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", type=str, required=True,
                   help="matrix root: one subdir per task")
    p.add_argument("--tasks", type=str, default="",
                   help="comma list; default = all TASK_MODES")
    p.add_argument("--train", action="store_true",
                   help="train each task from its preset before eval "
                        "(else: restore existing checkpoints)")
    p.add_argument("--budget", type=int, default=20_000_000)
    p.add_argument("--eval_steps", type=int, default=600)
    p.add_argument("--md", action="store_true",
                   help="print the markdown table")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    tasks = (args.tasks.split(",") if args.tasks else list(TASK_MODES))
    os.makedirs(args.root, exist_ok=True)
    results = []
    for mode in tasks:
        print(f"=== {mode} ===", flush=True)
        try:
            r = run_task(mode, args.root, args.train, args.budget,
                         args.eval_steps, device=dev)
        except Exception:
            # a failed task is recorded as an error row, as the JAX CLI
            # does, and the matrix goes on with the next one
            traceback.print_exc()
            r = {"task": mode, "error": traceback.format_exc()[-300:]}
        print(json.dumps(r), flush=True)
        results.append(r)
        with open(os.path.join(args.root, "matrix.json"), "w") as f:
            json.dump(results, f, indent=1)
    if args.md:
        print(to_markdown(results))
    return results


if __name__ == "__main__":
    main()
