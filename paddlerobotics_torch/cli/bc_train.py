"""BC distillation CLI (PyTorch port of the JAX package's
``cli/bc_train.py``, mirror of ETGRL/BCtrain.py).

Loads an expert SAC checkpoint (a task-matrix artifact: the newest
``itr_<step>.pt`` of ``cli.eval_matrix --train``), rolls the STUDENT to
collect paired (student_obs, expert_obs) transitions, distills the
truncated/noised student (cal_agent_obs, BCtrain.py:77-81), and reports
the reference's headline metric: the student/expert deterministic
eval-reward ratio ("ref_ratio", BCtrain.py:183-186).

    python -m paddlerobotics_torch.cli.bc_train --task ground \\
        --expert_dir matrix/ground --outdir bc_ground \\
        --bc_steps 200000 --obs2noise 1

Writes ``<outdir>/bc_result.json`` and ``<outdir>/itr_<bc_steps>.pt`` (the
student's modules and optimisers). Runs on the card (``--device cuda``,
the default) or with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from paddlerobotics_torch.algos.sac import SAC
from paddlerobotics_torch.cli.eval_matrix import build_task_config
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.etg import fit as etg_fit
from paddlerobotics_torch.train import checkpoints
from paddlerobotics_torch.train.bc_train import BCTrainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", type=str, default="ground")
    p.add_argument("--expert_dir", type=str, required=True,
                   help="task-matrix checkpoint dir (contains itr_*.pt)")
    p.add_argument("--outdir", type=str, default="bc_log")
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--bc_steps", type=int, default=200_000)
    p.add_argument("--distill_epochs", type=int, default=10)
    p.add_argument("--final_epochs", type=int, default=10)
    p.add_argument("--eval_steps", type=int, default=600)
    p.add_argument("--obs2noise", type=int, default=0,
                   help="apply BCtrain.py:53-58 sensor noise to the "
                        "student view (collection AND eval)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, _, _ = build_task_config(args.task, eval_steps=args.eval_steps,
                                  use_pallas=dev.type == "cuda")
    step = checkpoints.latest_step(args.expert_dir)
    if step is None:
        raise FileNotFoundError(
            f"no itr_* checkpoint under {args.expert_dir} — train the "
            f"expert first (cli.eval_matrix --train)")
    restored = checkpoints.restore(
        os.path.join(args.expert_dir, f"itr_{step}"), device=dev)
    expert_state = SAC(cfg.sensors.base_obs_dim, 12, cfg.sac,
                       device=dev).init(None)
    checkpoints.load_sac_state(expert_state, restored["sac"])
    # refit the expert's gait as the matrix evaluator does
    # (ETGRLTrainer.fit_etg: prior points + 12-param offsets → proximal LS)
    prior = torch.as_tensor(etg_fit.prior_points(cfg.etg),
                            dtype=torch.float32, device=dev)
    w0, b0 = etg_fit.opt_with_points(cfg.etg, device=dev)
    pts = prior + torch.as_tensor(restored["etg_param"], dtype=torch.float32,
                                  device=dev).reshape(6, 2)
    w, b = etg_fit.opt_with_points(cfg.etg, points=pts, w0=w0, b0=b0)

    trainer = BCTrainer(cfg, expert_state, etg_w=w, etg_b=b,
                        num_envs=args.num_envs, outdir=args.outdir,
                        sensor_noise=bool(args.obs2noise), device=dev)
    bc_state, losses = trainer.train(total_steps=args.bc_steps,
                                     distill_epochs=args.distill_epochs,
                                     final_epochs=args.final_epochs,
                                     seed=args.seed)
    torch.save({"bc": {k: getattr(bc_state, k).state_dict()
                       for k in ("actor", "critic", "actor_opt",
                                 "critic_opt")},
                "step": args.bc_steps},
               os.path.join(args.outdir, f"itr_{args.bc_steps}.pt"))
    row = {"task": args.task, "bc_steps": args.bc_steps,
           "obs2noise": args.obs2noise,
           "actor_loss": round(losses["actor_loss"], 4),
           "critic_loss": round(losses["critic_loss"], 4)}
    row.update(trainer.ratio_report(bc_state, args.eval_steps))
    with open(os.path.join(args.outdir, "bc_result.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
