"""Ablation-fleet trainer (PyTorch port of the JAX package's
``cli/parallel_train_attn.py``, rebuild of scripts/parallel_train_attn.py).

Every input variant trains in one process: one host loop dispatches each
variant's train step before it reads any loss, so each card's queue holds
its variants' work. Variants are placed round-robin over the cards, variant
i on ``cuda:i % torch.cuda.device_count()``, as the JAX CLI places them over
``jax.devices()``. A real-data stream (``*.npz``
windows carrying every token key) is shared by all variants, each taking
the keys its ``inputs_type`` consumes; synthetic batches are shared by the
variants of the first variant's type, and the others draw their own.

    python -m paddlerobotics_torch.cli.parallel_train_attn \\
        --variants visual_token,instance,without_inst_fm \\
        --synthetic 50 --epochs 2

Writes ``<outdir>/<variant>/metrics.jsonl`` and one
``<outdir>/<variant>/itr_<step>.pt`` per epoch. Runs on the card
(``--device cuda``, the default) or with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

# the reference's Config map (parallel_train_attn.py:25-31): variant →
# subdirectory
VARIANTS = ("visual_token", "instance", "without_inst_fm",
            "without_inst_cls", "without_inst_pos")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--variants", type=str,
                   default="visual_token,instance")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--num_actions", type=int, default=317)
    p.add_argument("--num_frames", type=int, default=10)
    p.add_argument("--tokens_per_frame", type=int, default=20)
    p.add_argument("--model_dim", type=int, default=512)
    p.add_argument("--num_decoder_blocks", type=int, default=6)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--ffn_dim", type=int, default=2048)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--l2", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--outdir", type=str, default="attn_fleet")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    return p


def main(argv=None):
    """Returns {variant: {"state": AttnTrainState, "seconds": host seconds
    spent in its train steps' dispatch and batch draws}}."""
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from paddlerobotics_torch.cli.train_attention import (ctrl_config,
                                                          npz_batches)
    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                          synthetic_batch)
    from paddlerobotics_torch.train import checkpoints, metrics as m

    names = [v.strip() for v in args.variants.split(",") if v.strip()]
    for v in names:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r} (choose from "
                             f"{', '.join(VARIANTS)})")
    dev = resolve_device(args.device)

    fleet = []
    for i, name in enumerate(names):
        cfg = ctrl_config(args, name)
        v_dev = (torch.device("cuda", i % torch.cuda.device_count())
                 if dev.type == "cuda" else dev)
        trainer = AttentionTrainer(cfg, lr=args.lr, weight_decay=args.l2,
                                   device=v_dev)
        gen = torch.Generator(v_dev)
        gen.manual_seed(i)
        outdir = os.path.join(args.outdir, name)
        fleet.append({"name": name, "cfg": cfg, "trainer": trainer,
                      "device": v_dev,
                      "state": trainer.init(gen), "outdir": outdir,
                      "logger": m.MetricsLogger(outdir, use_tensorboard=False),
                      "seconds": 0.0})

    rng = np.random.RandomState(0)
    first = fleet[0]["cfg"]
    step = 0
    last_loss = {}
    for epoch in range(args.epochs):
        if args.data_dir:
            batches = npz_batches(args.data_dir, args.batch_size, dev)
        else:
            batches = (synthetic_batch(first, rng, args.batch_size, dev)
                       for _ in range(max(args.synthetic, 1)))
        for shared in batches:
            step += 1
            # dispatch every variant's step, then read the losses
            auxes = []
            for v in fleet:
                t = time.perf_counter()
                if args.data_dir or v["cfg"].inputs_type == first.inputs_type:
                    # _tokens() selects per variant
                    batch = {k: x.to(v["device"]) for k, x in shared.items()}
                else:
                    batch = synthetic_batch(v["cfg"], rng, args.batch_size,
                                            v["device"])
                auxes.append((v, v["trainer"].train_step(v["state"], batch)))
                v["seconds"] += time.perf_counter() - t
            if step % 10 == 0 or args.synthetic:
                for v, aux in auxes:
                    last_loss[v["name"]] = float(aux["loss"])
                    v["logger"].add_scalar("train/loss", last_loss[v["name"]],
                                           step)
        for v in fleet:
            checkpoints.save_attn(v["outdir"], v["state"])
        print(f"epoch {epoch}: " + "  ".join(
            f"{v['name']}={last_loss.get(v['name'], float('nan')):.4f}"
            for v in fleet))
    for v in fleet:
        v["logger"].close()
    return {v["name"]: {"state": v["state"], "seconds": v["seconds"]}
            for v in fleet}


if __name__ == "__main__":
    main()
