"""ES-only ETG pretraining CLI (PyTorch port of the JAX package's
``cli/pretrain_etg.py``, mirror of ETGRL/pretrain.py).

    python -m paddlerobotics_torch.cli.pretrain_etg --popsize 40 \\
        --num_envs 4080 --generations 100 --save_path etg_pretrained.npz

Takes ``cli/train_quadruped``'s flags; runs on the card (``--device cuda``,
the default) with the physics kernel, or with ``--device cpu`` on the plain
physics. ``num_envs`` must be a multiple of the popsize, as in the JAX
package (which fails at its default 4096 with popsize 40).
"""

from __future__ import annotations

import numpy as np

from paddlerobotics_torch.cli.train_quadruped import (build_parser,
                                                      check_args,
                                                      config_from_args)
from paddlerobotics_torch.train.pretrain import ETGPretrainer


def main(argv=None):
    p = build_parser()
    p.add_argument("--generations", type=int, default=100)
    p.add_argument("--save_path", type=str, default="etg_pretrained.npz")
    p.add_argument("--alive_bonus", type=float, default=1.0,
                   help="per-step survival bonus added to the ES fitness "
                        "(see train/pretrain.py docstring)")
    args = p.parse_args(argv)
    check_args(args)
    if args.mesh not in ("0", "", "none"):
        raise SystemExit(f"--mesh {args.mesh}: ETG pretraining runs in one "
                         "process (the JAX CLI takes the flag and ignores it)")
    cfg = config_from_args(args)
    trainer = ETGPretrainer(cfg, num_envs=max(args.num_envs, args.popsize),
                            outdir=args.outdir, alive_bonus=args.alive_bonus,
                            device=args.device)
    best, best_r, (w, b) = trainer.train(generations=args.generations,
                                         seed=args.seed)
    # artifact layout mirrors train.py:301: npz with (w, b, param)
    np.savez(args.save_path, w=w.cpu().numpy(), b=b.cpu().numpy(),
             param=best.cpu().numpy())
    print(f"best fitness {best_r:.2f} → {args.save_path}")
    return best, best_r


if __name__ == "__main__":
    main()
