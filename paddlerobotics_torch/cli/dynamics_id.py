"""Sim-to-real dynamics identification CLI (PyTorch port of the JAX
package's ``cli/dynamics_id.py``, mirror of ETGRL/Dynamic_train.py): fit
48 normalized dynamics parameters so sim traces match recorded robot logs.

    python -m paddlerobotics_torch.cli.dynamics_id --gait gait.npy \\
        --real_q q.npy --real_gyro gyro.npy --epochs 50

Writes the best vector to ``--save`` (``dynamic_param.npy``). Runs on the
card (``--device cuda``, the default) or with ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.train.dynamics_id import DynamicsIdentifier


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gait", type=str, required=True,
                   help="npy of recorded joint commands (T,12)")
    p.add_argument("--real_q", type=str, required=True,
                   help="npy of recorded joint angles (T,12)")
    p.add_argument("--real_gyro", type=str, required=True,
                   help="npy of recorded gyro (T,3)")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--popsize", type=int, default=40)
    p.add_argument("--sigma", type=float, default=0.5)
    p.add_argument("--outdir", type=str, default="dyn_id_log")
    p.add_argument("--save", type=str, default="dynamic_param.npy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    ident = DynamicsIdentifier(
        QuadrupedConfig(), np.load(args.gait), np.load(args.real_q),
        np.load(args.real_gyro), popsize=args.popsize, sigma=args.sigma,
        outdir=args.outdir, device=args.device)
    best, _ = ident.identify(epochs=args.epochs, seed=args.seed)
    np.save(args.save, best.cpu().numpy())   # Dynamic_parallel_model.py:150
    print(f"saved {args.save}")
    return ident, best


if __name__ == "__main__":
    main()
