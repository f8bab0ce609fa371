"""ETG-RL training CLI (PyTorch port): flag for flag the JAX package's
``cli/train_quadruped.py``, a mirror of ETGRL/train.py:451-506, plus
``--device``.

Usage:
    python -m paddlerobotics_torch.cli.train_quadruped --task_mode ground \
        --max_steps 10000000 --num_envs 4096

Runs on the card (``--device cuda``, the default) with the physics kernel;
``--device cpu`` runs the plain physics.

``--mesh`` takes the JAX CLI's values: ``0`` (one process), ``1`` (every
card on the env axis) or ``NxM`` (N env × M model ranks). Started plainly,
the CLI starts one rank per card itself (NCCL; a mesh larger than the cards
raises); under ``torchrun`` it joins the ranks given:

    python -m paddlerobotics_torch.cli.train_quadruped --mesh 1 ...
    torchrun --nproc_per_node 4 -m paddlerobotics_torch.cli.train_quadruped \
        --mesh 2x2 ...

With ``--device cpu`` the ranks are gloo ranks on the CPU and the mesh must
be given as ``NxM``. Rank 0 writes the metrics and checkpoints.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from paddlerobotics_torch.core.config import (ESConfig, ETGConfig,
                                              QuadrupedConfig, RandomConfig,
                                              RewardConfig, SACConfig,
                                              SensorConfig, SimConfig,
                                              TaskConfig, TrainConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # mirrors train.py:451-506
    p.add_argument("--outdir", type=str, default="train_log")
    p.add_argument("--max_steps", type=int, default=int(1e7))
    p.add_argument("--sigma", type=float, default=0.02)
    p.add_argument("--sigma_decay", type=float, default=0.99)
    p.add_argument("--popsize", type=int, default=40)
    p.add_argument("--random_dynamic", type=int, default=0)
    p.add_argument("--random_force", type=int, default=0)
    p.add_argument("--task_mode", type=str, default="stairstair")
    p.add_argument("--step_y", type=float, default=0.09,
                   help="lateral stance offset; 0.05 = the reference's "
                        "exact golden stance, 0.09 (default) = +4cm, "
                        "needed for stair stability under penalty "
                        "contact (docs/reward_calibration.md)")
    p.add_argument("--load", type=str, default="")
    p.add_argument("--eval", type=int, default=0)
    p.add_argument("--suffix", type=str, default="exp0")
    p.add_argument("--normal", type=int, default=1)
    p.add_argument("--vel_d", type=float, default=0.5)
    p.add_argument("--ETG_T", type=float, default=0.5)
    p.add_argument("--reward_p", type=float, default=5.0)
    p.add_argument("--footheight", type=float, default=0.1)
    p.add_argument("--steplen", type=float, default=0.05)
    p.add_argument("--ETG", type=int, default=1)
    p.add_argument("--ETG_T2", type=float, default=0.5)
    p.add_argument("--e_step", type=int, default=400)
    p.add_argument("--act_mode", type=str, default="traj")
    p.add_argument("--ETG_H", type=int, default=20)
    p.add_argument("--stand", type=float, default=0.0)
    p.add_argument("--torso", type=float, default=1.5)
    p.add_argument("--up", type=float, default=0.6)
    p.add_argument("--tau", type=float, default=0.07)
    p.add_argument("--feet", type=float, default=0.3)
    p.add_argument("--badfoot", type=float, default=0.1)
    p.add_argument("--footcontact", type=float, default=0.1)
    p.add_argument("--lateral", type=float, default=0.0,
                   help="centerline-tracking shaping weight (|y| + "
                        "lateral speed + yaw); balance-beam preset "
                        "turns it on, 0 = reference weight vector")
    p.add_argument("--act_bound", type=float, default=0.3)
    p.add_argument("--sensor_dis", type=int, default=1)
    p.add_argument("--sensor_motor", type=int, default=1)
    p.add_argument("--sensor_imu", type=int, default=1)
    p.add_argument("--sensor_contact", type=int, default=1)
    p.add_argument("--sensor_ETG", type=int, default=1)
    p.add_argument("--sensor_ETG_obs", type=int, default=0)
    p.add_argument("--sensor_footpose", type=int, default=0)
    p.add_argument("--sensor_dynamic", type=int, default=0)
    p.add_argument("--sensor_exforce", type=int, default=0)
    p.add_argument("--sensor_noise", type=int, default=0)
    p.add_argument("--timesteps", type=int, default=5)
    p.add_argument("--timeinterval", type=int, default=1)
    p.add_argument("--RNN_mode", type=str, default="None")
    p.add_argument("--enable_action_filter", type=int, default=0)
    p.add_argument("--ES", type=int, default=1)
    p.add_argument("--ES_every", type=int, default=50_000,
                   help="env steps between ES phases (reference "
                        "constant 5e4, train.py:457 — a SINGLE-env "
                        "cadence; at large --num_envs this fires every "
                        "few batched steps and ES rollouts dominate "
                        "wall-clock. Scale it with B — e.g. 400*B keeps "
                        "the ES:SAC wall ratio near the reference's "
                        "data ratio)")
    p.add_argument("--es_rpm", type=int, default=1)
    p.add_argument("--x_noise", type=int, default=0)
    # additions of the batched trainer
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--updates_per_step", type=int, default=4,
                   help="SGD updates per batched env step. The reference "
                        "does 1 update per SINGLE-env step (train.py:163-"
                        "167); 4 at B=4096 is the measured wall-clock/"
                        "sample-efficiency sweet spot, 16 at B=1024 "
                        "reaches success-velocity in <2M env steps — "
                        "docs/update_schedule.md")
    p.add_argument("--chunk_steps", type=int, default=50)
    p.add_argument("--mesh", type=str, default="0",
                   help="device mesh: 0 = off, 1 = every card on the env "
                        "(data-parallel) axis, or 'NxM' = N-way env data "
                        "parallelism × M-way column-parallel MLPs over "
                        "torch.distributed (NCCL on the card, gloo with "
                        "--device cpu, where NxM is required)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_pallas", type=int, default=1,
                   help="the physics kernel (kept for flag parity): on the "
                        "card 0 is refused, since the plain physics is the "
                        "tests' reference alone; on the CPU the plain "
                        "physics runs whatever it says")
    p.add_argument("--dynamics_scale", type=float, default=1.0,
                   help="scale on the normalized DR sample (1.0 = full "
                        "reference ranges)")
    p.add_argument("--dr_scale_start", type=float, default=0.2)
    p.add_argument("--dr_curriculum_steps", type=int, default=0,
                   help="anneal DR scale from dr_scale_start to "
                        "dynamics_scale over this many env steps "
                        "(0 = constant)")
    p.add_argument("--warmup_steps", type=int, default=10_000,
                   help="env steps of random-action warmup before SAC "
                        "learning (reference constant 1e4, train.py:41; "
                        "scale up with --updates_per_step at small "
                        "--num_envs — see docs/update_schedule.md)")
    p.add_argument("--dr_adaptive", type=int, default=0,
                   help="success-gated DR curriculum (ADR-style): grow "
                        "the scale while EMA success >= dr_success_hi, "
                        "shrink below dr_success_lo; overrides "
                        "--dr_curriculum_steps")
    p.add_argument("--dr_success_lo", type=float, default=0.30)
    p.add_argument("--dr_success_hi", type=float, default=0.50)
    p.add_argument("--dr_jitter", type=int, default=0,
                   help="per-draw scale ~ U(0, scale) so part of the "
                        "batch always trains near nominal dynamics "
                        "(load-bearing for stairs+DR, docs/dr_study.md)")
    p.add_argument("--beam_width", type=float, default=0.30,
                   help="balance_beam plank width (m); pair with a "
                        "narrow --step_y (README.md:65)")
    p.add_argument("--beam_length", type=float, default=3.0,
                   help="balance_beam plank length (m)")
    p.add_argument("--terrain_start", type=float, default=0.5,
                   help="flat run-in before the terrain feature (m)")
    p.add_argument("--step_height", type=float, default=0.08)
    p.add_argument("--step_width", type=float, default=0.3)
    p.add_argument("--slope", type=float, default=0.2)
    p.add_argument("--ETG_path", type=str, default="auto",
                   help="npz with pretrained ETG 'param' (train.py:281). "
                        "'auto' (default) resolves the shipped per-task "
                        "seed from paddlerobotics_torch/assets/etg_seeds/ "
                        "when one exists (etg/seeds.py); 'None' forces "
                        "the zero-offset prior")
    p.add_argument("--ln_critic", type=int, default=0,
                   help="LayerNorm critics — plasticity stabilizer for "
                        "high --updates_per_step schedules "
                        "(docs/update_schedule.md finding 3)")
    p.add_argument("--critic_reset_steps", type=int, default=0,
                   help="re-initialize critic+target+opt every N env "
                        "steps (primacy-bias reset; 0 = never)")
    p.add_argument("--warmup_gait_frac", type=float, default=0.5,
                   help="fraction of envs rolling the open-loop ETG "
                        "gait (small-noise residual) instead of uniform "
                        "random during warmup, so early replay contains "
                        "walking transitions (0 = all-random warmup)")
    p.add_argument("--spawn_x_max", type=float, default=0.0,
                   help="spawn-on-course curriculum: autoreset respawns "
                        "a slice of envs at x~U(0,max) on the course "
                        "(TrainConfig.spawn_x_max; balance-beam preset)")
    p.add_argument("--spawn_x_frac", type=float, default=0.5)
    p.add_argument("--spawn_y", type=float, default=0.0)
    p.add_argument("--spawn_yaw", type=float, default=0.0)
    p.add_argument("--keep_best_eval", type=int, default=0,
                   help="return the eval-peak policy from training "
                        "instead of the final step's (the reference "
                        "ships its best eval-window artifact)")
    p.add_argument("--alpha_anneal_steps", type=int, default=0,
                   help="linearly anneal SAC alpha to --alpha_final "
                        "over N env steps (0 = reference fixed alpha)")
    p.add_argument("--alpha_final", type=float, default=0.05)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; the CPU runs the plain "
                        "physics")
    p.add_argument("--det_frac", type=float, default=0.0,
                   help="fraction of envs rolling the deterministic "
                        "(mean) action during training so replay covers "
                        "the eval-time state distribution "
                        "(SACConfig.det_rollout_frac)")
    return p


def config_from_args(args) -> QuadrupedConfig:
    return QuadrupedConfig(
        sim=SimConfig(use_pallas=bool(getattr(args, "use_pallas", 1))),
        sac=SACConfig(warmup_steps=args.warmup_steps,
                      ln_critic=bool(getattr(args, "ln_critic", 0)),
                      critic_reset_steps=getattr(args, "critic_reset_steps",
                                                 0),
                      warmup_gait_frac=getattr(args, "warmup_gait_frac",
                                               0.5),
                      det_rollout_frac=getattr(args, "det_frac", 0.0),
                      alpha_anneal_steps=getattr(args, "alpha_anneal_steps",
                                                 0),
                      alpha_final=getattr(args, "alpha_final", 0.05)),
        sensors=SensorConfig(
            dis=bool(args.sensor_dis), motor=args.sensor_motor,
            imu=args.sensor_imu, contact=bool(args.sensor_contact),
            etg=bool(args.sensor_ETG), etg_obs=bool(args.sensor_ETG_obs),
            footpose=bool(args.sensor_footpose),
            dynamic_vec=bool(args.sensor_dynamic),
            force_vec=bool(args.sensor_exforce),
            noise=bool(args.sensor_noise), normal=bool(args.normal),
            rnn_time_steps=args.timesteps if args.RNN_mode != "None" else 0,
            rnn_time_interval=args.timeinterval, rnn_mode=args.RNN_mode),
        reward=RewardConfig(
            torso=args.torso, up=args.up, feet=args.feet, tau=args.tau,
            stand=args.stand, badfoot=args.badfoot,
            footcontact=args.footcontact, reward_p=args.reward_p,
            vel_d=args.vel_d, lateral=getattr(args, "lateral", 0.0)),
        random=RandomConfig(
            random_dynamics=bool(args.random_dynamic),
            random_force=bool(args.random_force),
            dynamics_scale=args.dynamics_scale,
            dr_scale_start=args.dr_scale_start,
            dr_curriculum_steps=args.dr_curriculum_steps,
            dr_adaptive=bool(args.dr_adaptive),
            dr_scale_jitter=bool(args.dr_jitter),
            dr_success_lo=args.dr_success_lo,
            dr_success_hi=args.dr_success_hi),
        etg=ETGConfig(T=args.ETG_T, T2=args.ETG_T2, H=args.ETG_H,
                      steplen=args.steplen, footheight=args.footheight,
                      step_y=args.step_y),
        task=TaskConfig(task_mode=args.task_mode,
                        terrain_start=args.terrain_start,
                        step_height=args.step_height,
                        step_width=args.step_width, slope=args.slope,
                        beam_width=args.beam_width,
                        beam_length=args.beam_length),
        es=ESConfig(popsize=args.popsize if args.ES else 0,
                    sigma_init=args.sigma, sigma_decay=args.sigma_decay,
                    es_every_steps=args.ES_every,
                    es_rpm=bool(args.es_rpm)),
        train=TrainConfig(max_steps=args.max_steps, e_step=args.e_step,
                          act_mode=args.act_mode, act_bound=args.act_bound,
                          num_envs=args.num_envs, seed=args.seed,
                          enable_action_filter=bool(
                              args.enable_action_filter),
                          x_noise=bool(args.x_noise),
                          spawn_x_max=getattr(args, "spawn_x_max", 0.0),
                          spawn_x_frac=getattr(args, "spawn_x_frac", 0.5),
                          spawn_y=getattr(args, "spawn_y", 0.0),
                          spawn_yaw=getattr(args, "spawn_yaw", 0.0),
                          keep_best_eval=bool(
                              getattr(args, "keep_best_eval", 0))),
    )


def apply_task_preset(parser, argv):
    """Make the registered per-task recipe the DEFAULT for its flags.

    The reference ships well-trained artifacts per task (README.md:77);
    here `envs/registry.TASK_PRESETS` carries the schedule that
    reproduces each task from scratch (docs/task_matrix.md). Flags the
    user passes explicitly always win — the preset only replaces the
    parser defaults.
    """
    from paddlerobotics_torch.envs.registry import TASK_PRESETS

    # parse_known_args (not an argv scan) so argparse prefix
    # abbreviations like `--task_mod stairstair` still pick the preset.
    # Strip help flags from the probe so `--help` renders AFTER the
    # preset defaults are applied.
    import sys

    av = [a for a in (sys.argv[1:] if argv is None else argv)
          if a not in ("-h", "--help")]
    probe, _ = parser.parse_known_args(av)
    mode = probe.task_mode
    preset = TASK_PRESETS.get(mode, {})
    if preset:
        parser.set_defaults(**{k: (int(v) if isinstance(v, bool) else v)
                               for k, v in preset.items()})
        print(f"task preset [{mode}]: {preset} (explicit flags override)")
    return preset


def check_args(args) -> None:
    """Refuse what the port does not run: the plain physics on the card (it
    is the tests' reference; nothing falls back to it)."""
    if args.ES_every < 1:
        raise SystemExit("--ES_every must be >= 1 (it divides the step "
                         "counter; use --ES 0 to disable ES)")
    if torch.device(args.device).type != "cpu" and not args.use_pallas:
        raise SystemExit("--use_pallas 0 on the card: the plain physics is "
                         "the tests' reference, the card runs the kernel")


def parse_args(argv=None):
    parser = build_parser()
    apply_task_preset(parser, argv)
    args = parser.parse_args(argv)
    check_args(args)
    return args


def main(argv=None, deadline_s: float | None = None):
    """Train (or ``--eval``) in this process, or with ``--mesh`` on every
    rank of the mesh: the ranks ``torchrun`` started, else one new rank per
    card (``--device cpu``: per gloo rank of an ``NxM`` mesh), killed past
    ``deadline_s``."""
    from paddlerobotics_torch.parallel import launch

    args = parse_args(argv)
    shape = launch.mesh_shape(args.mesh, args.device)
    if shape is None:
        return run(args)
    print(f"mesh training over {shape[0]}x{shape[1]} rank(s): env axis "
          f"data-parallel, model axis column-parallel, replay rows in "
          f"blocks, gradients all-reduced "
          f"({launch.backend_for(args.device)})")
    launch.run_ranks(_mesh_rank, shape[0] * shape[1],
                     (args, shape), args.device, deadline_s)


def _mesh_rank(local_rank: int, args, shape):
    """One rank of a ``--mesh`` run (a module-level function: spawned ranks
    import it by name)."""
    from paddlerobotics_torch.parallel import launch, sharding

    device = launch.rank_device(args.device, local_rank)
    mesh = sharding.make_mesh(*shape, device_type=device.type)
    run(args, mesh=mesh, device=device)


def run(args, mesh=None, device=None):
    from paddlerobotics_torch.parallel import sharding
    from paddlerobotics_torch.train import checkpoints
    from paddlerobotics_torch.train.etg_rl import ETGRLTrainer

    cfg = config_from_args(args)
    outdir = os.path.join(args.outdir, args.suffix)
    trainer = ETGRLTrainer(cfg, num_envs=args.num_envs, outdir=outdir,
                           updates_per_step=args.updates_per_step,
                           mesh=mesh, device=device or args.device)
    say = print if sharding.is_writer() else (lambda *a, **k: None)
    if args.load:
        trainer.restore(args.load)
    if args.eval:
        # Evaluate a TRAINED checkpoint (the reference restores the agent
        # before eval, train.py:333-343), never a fresh random policy.
        if not args.load:
            raise SystemExit("--eval requires --load <checkpoint file>")
        restored = checkpoints.restore(args.load, device=trainer.device)
        sac_state = trainer.sac.init(None)
        checkpoints.load_sac_state(sac_state, restored["sac"])
        w, b = trainer.fit_etg(restored["etg_param"])
        ret, steps, infos = trainer.evaluate(sac_state.actor, w, b,
                                             cfg.train.eval_episode_len)
        steps_f = max(float(steps), 1.0)
        say(f"eval reward {float(ret):.2f} steps {float(steps):.1f} "
            f"velx {float(infos['velx']) / steps_f:.3f} "
            f"success {float(infos['success']) / steps_f:.3f}")
        return
    init_param = None
    if args.ETG_path == "auto":
        from paddlerobotics_torch.etg import seeds as etg_seeds

        init_param = etg_seeds.load_seed_param(args.task_mode)
        if init_param is not None:
            say(f"ETG seed: shipped {args.task_mode} artifact "
                f"({etg_seeds.seed_path(args.task_mode)})")
    elif args.ETG_path not in ("", "None") and os.path.exists(args.ETG_path):
        init_param = np.load(args.ETG_path)["param"].reshape(-1)
    trainer.train(max_steps=args.max_steps, chunk_steps=args.chunk_steps,
                  seed=args.seed, init_etg_param=init_param)


if __name__ == "__main__":
    main()
