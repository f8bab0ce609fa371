"""``make_env`` — the entry point mirroring ``rlschool.make_env('Quadrupedal',
task=..., sensor_mode=..., reward_param=..., ...)`` (ETGRL/train.py:305-309),
returning the per-env functional ``QuadrupedEnv`` (port of the JAX package's
``envs/registry.py``), and the per-task training recipes ``TASK_PRESETS``
(``cli/train_quadruped.apply_task_preset`` makes a task's entry the default
of its flags).
"""

from __future__ import annotations

import dataclasses

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs.quadruped_env import QuadrupedEnv

_ENV_REGISTRY = {}

# Per-task training recipes (the reference ships trained artifacts for
# its nine tasks, README.md:77; here the registry carries the schedule
# that reproduces each task from scratch — docs/task_matrix.md). Tasks
# absent from this dict train with the CLI defaults (B=4096, K=4,
# warmup 2e5). The uphill modes need the sample-efficiency schedule
# (docs/update_schedule.md) + the shipped ETG seed
# (paddlerobotics_torch/assets/etg_seeds/, auto-resolved by
# --ETG_path auto) + a plasticity stabilizer to hold their plateau.
TASK_PRESETS: dict = {
    # alpha annealed 0.2→0.05 over the nominal 20M budget: settles the
    # high-entropy schedule's train-trace wander (velx 0.34-0.39 →
    # ~1.1) with the deterministic eval at full strength
    # (docs/task_matrix.md round-4 arm; re-validated through
    # cli.eval_matrix before shipping). Longer budgets simply hold the
    # annealed floor past 20M.
    "up_slope": dict(num_envs=1024, updates_per_step=16,
                     warmup_steps=200_000, ln_critic=True,
                     alpha_anneal_steps=20_000_000),
    "slopeslope": dict(num_envs=1024, updates_per_step=16,
                       warmup_steps=200_000, ln_critic=True),
    # periodic critic reset counters the 25M+ high-reuse decay at K=4
    # (docs/reward_calibration.md round-3 takeaway (c); stabilizer
    # verdict in docs/update_schedule.md) so the deterministic eval
    # policy keeps hardening past the 20M mark on the two tasks whose
    # mean-action policy still falls mid-course there.
    "stairstair": dict(critic_reset_steps=5_000_000),
    # Balance beam — the round-4 recipe that closes the deterministic
    # 600-step eval (scripts_dev/beam_arms.py arm psl_v03_noreset:
    # eval 600/600 steps, success 0.988, velx 0.80): golden stance
    # step_y=0.05 on the 0.4 m matrix plank, NO ETG seed (the shipped
    # beam seed falls open-loop in 14 steps under current physics while
    # the default prior walks the plank 345 steps), spawn-on-course
    # curriculum (autoreset respawns mid-plank with heading/lateral
    # jitter — without it every episode dies at plank ENTRY and replay
    # holds no on-plank data), mild centerline shaping, vel_d=0.3 (the
    # progress reward saturates at 2·vel_d; sprinting kills on the
    # plank), NO critic reset (each 5M reset destroyed the survival
    # value structure — every reset-arm peaked at an early checkpoint
    # then decayed), and eval-peak artifact selection against the
    # remaining late decay.
    # Schedule: sample-efficiency B=1024/K=16 + LayerNorm critic — the
    # arm whose FINAL policy (no checkpoint selection needed) runs
    # 600/600 at 0.985 success / 0.75 m/s; its eval-peak reaches
    # 0.993 / 1.07 m/s (arm table in docs/task_matrix.md).
    # OUT-OF-PRESET (known limitation, measured): the WIDE-stance
    # geometry (step_y=0.09) does NOT close at 40M under any tried
    # schedule (best 0.897 success, 58-step survival — docs/
    # task_matrix.md "40M hardening"). The beam is shipped as solved by
    # THIS configuration (golden stance 0.05), not robustly across
    # stance geometries; arms that widen step_y should expect to redo
    # the curriculum study.
    "balance_beam": dict(step_y=0.05, beam_width=0.4, lateral=0.5,
                         vel_d=0.3, ETG_path="None", spawn_x_max=3.0,
                         spawn_y=0.08, spawn_yaw=0.2, keep_best_eval=1,
                         num_envs=1024, updates_per_step=16,
                         ln_critic=True),
}


def register_env(name: str, factory):
    """``make_env(name, task=..., config=..., device=..., **overrides)``
    then calls ``factory`` with those keywords."""
    _ENV_REGISTRY[name] = factory


def make_env(name: str = "Quadrupedal", *,
             task: str = "ground",
             config: QuadrupedConfig | None = None,
             device=None,
             **overrides) -> QuadrupedEnv:
    """Build a quadruped env, on the card unless ``device`` says otherwise.

    Args:
      name: env family (only 'Quadrupedal', like the reference).
      task: one of the terrain task modes (sim/terrain.py TASK_MODES).
      config: full config (its task_mode is replaced by ``task``).
      **overrides: field overrides routed to the sub-config that owns them,
        in the order reward, task, sensors, etg, train, sim, e.g.
        reward_p=5.0, vel_d=0.5, act_mode='traj', step_y=0.05; a name no
        sub-config has raises TypeError.
    """
    if name in _ENV_REGISTRY:
        return _ENV_REGISTRY[name](task=task, config=config, device=device,
                                   **overrides)
    if name != "Quadrupedal":
        raise ValueError(f"unknown env {name!r}")
    cfg = config or QuadrupedConfig()
    cfg = cfg.replace(task=dataclasses.replace(cfg.task, task_mode=task))

    # route keyword overrides into the sub-configs that own them
    def route(sub, **kw):
        fields = {f.name for f in dataclasses.fields(sub)}
        hit = {k: v for k, v in kw.items() if k in fields}
        return dataclasses.replace(sub, **hit), {
            k: v for k, v in kw.items() if k not in fields}

    rest = overrides
    new_reward, rest = route(cfg.reward, **rest)
    new_task, rest = route(cfg.task, **rest)
    new_sensors, rest = route(cfg.sensors, **rest)
    new_etg, rest = route(cfg.etg, **rest)
    new_train, rest = route(cfg.train, **rest)
    new_sim, rest = route(cfg.sim, **rest)
    if rest:
        raise TypeError(f"unknown make_env overrides: {sorted(rest)}")
    cfg = cfg.replace(reward=new_reward, task=new_task, sensors=new_sensors,
                      etg=new_etg, train=new_train, sim=new_sim)
    return QuadrupedEnv(cfg, device=device)
