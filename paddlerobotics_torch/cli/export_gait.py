"""Gait-table export CLI (PyTorch port of the JAX package's
``cli/export_gait.py``, mirror of ETGRL/env_test.py:30-60): the (steps, 12)
joint-residual table of a fixed ETG, saved as
``gait_action_list_ETG_<suffix>.npy`` in the working directory for
deployment replay.

    python -m paddlerobotics_torch.cli.export_gait --steps 600 --suffix exp

Runs on the card (``--device cuda``, the default) or with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.deploy.policy_export import export_gait_table
from paddlerobotics_torch.etg import fit as etg_fit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--load", type=str, default="",
                   help="npz with (w, b, param); default prior gait")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--suffix", type=str, default="exp")
    p.add_argument("--save", type=int, default=1)
    p.add_argument("--task_mode", type=str, default="ground",
                   help="task the gait was trained for; 'gallop' "
                        "resolves pairing='auto' to the bound gait")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = QuadrupedConfig()
    cfg = dataclasses.replace(
        cfg, task=dataclasses.replace(cfg.task, task_mode=args.task_mode))
    if args.load:
        data = np.load(args.load)
        w, b = data["w"], data["b"]
    else:
        w, b = etg_fit.opt_with_points(cfg.etg, device=dev)
    path = (f"gait_action_list_ETG_{args.suffix}.npy" if args.save else None)
    table = export_gait_table(cfg, w, b, n_steps=args.steps, path=path,
                              device=dev)
    print(f"gait table {table.shape}" + (f" → {path}" if path else ""))
    return table


if __name__ == "__main__":
    main()
