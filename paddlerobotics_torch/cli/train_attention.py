"""Attention-controller training CLI (PyTorch port of the JAX package's
``cli/train_attention.py``, mirror of scripts/train_attention_controller.py's
argparse surface).

Trains on tokenized windows: a directory of ``*.npz`` window files (one
window each, the batch keys of ``hri.train_attention.synthetic_batch``), or
``--synthetic N`` random batches per epoch for smoke and bench runs.

    python -m paddlerobotics_torch.cli.train_attention --synthetic 50 \\
        --epochs 2 --outdir attn_log

Writes ``<outdir>/metrics.jsonl`` and one ``<outdir>/itr_<step>.pt`` per
epoch (``train.checkpoints.save_attn``); ``--init_params itr_<step>.pt``
resumes weights, optimiser and step counter. Training runs the plain
attention (the kernel has no backward); ``--use_pallas_attention`` is kept
in the checkpoint's config, for scoring and serving, which take the
attention kernel on the card whatever it says. Runs on the card
(``--device cuda``, the default) or with ``--device cpu``.

``--distributed 1`` trains data-parallel over every card (the JAX CLI's
mesh over every device on "env"): each rank takes its rows of each batch
and the gradients are all-reduced (``AttentionTrainer(mesh=)``). Started
plainly the CLI starts one NCCL rank per card; under ``torchrun`` it joins
the ranks given. With ``--device cpu`` give the gloo ranks' count,
``--distributed N`` (N ≥ 2). Rank 0 writes the metrics and checkpoints.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic batches (smoke/bench)")
    p.add_argument("--inputs_type", type=str, default="visual_token")
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
    p.add_argument("--outdir", type=str, default="attn_log")
    p.add_argument("--use_pallas_attention", type=int, default=0)
    p.add_argument("--distributed", type=int, default=0,
                   help="shard batches over devices: 1 = every card (or "
                   "every rank torchrun started); with --device cpu, N >= 2 "
                   "gloo ranks")
    p.add_argument("--init_params", type=str, default="",
                   help="checkpoint (itr_<step>.pt) to resume from: "
                   "weights, optimiser and step counter")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    return p


def npz_batches(data_dir: str, batch_size: int, device):
    """Batches of ``batch_size`` windows from ``data_dir/*.npz`` in name
    order (a short last batch is dropped); every file carries the same
    keys."""
    from paddlerobotics_torch.hri.train_attention import to_device

    files = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    for i in range(0, len(files) - batch_size + 1, batch_size):
        arrs = [np.load(f) for f in files[i:i + batch_size]]
        yield to_device({k: np.stack([a[k] for a in arrs])
                         for k in arrs[0].files}, device)


def ctrl_config(args, inputs_type: str, use_pallas_attention: bool = False):
    """The controller's config from the CLI's width flags."""
    from paddlerobotics_torch.hri.attention_ctrl import AttnCtrlConfig

    return AttnCtrlConfig(
        inputs_type=inputs_type, num_actions=args.num_actions,
        num_frames=args.num_frames, tokens_per_frame=args.tokens_per_frame,
        model_dim=args.model_dim,
        num_decoder_blocks=args.num_decoder_blocks,
        num_heads=args.num_heads, ffn_dim=args.ffn_dim,
        use_pallas_attention=use_pallas_attention)


def main(argv=None):
    """Train in this process, or with ``--distributed`` on every rank."""
    import torch.distributed as dist

    from paddlerobotics_torch.parallel import launch

    args = build_parser().parse_args(argv)
    if not args.distributed:
        return run(args)
    cpu = torch.device(args.device).type == "cpu"
    if cpu and args.distributed == 1 and not (
            dist.is_initialized() or launch.under_torchrun()):
        raise SystemExit("--distributed 1 on the CPU: give the gloo ranks' "
                         "count, --distributed N")
    shape = launch.mesh_shape(
        f"{args.distributed}x1" if cpu and args.distributed > 1 else "1",
        args.device)
    launch.run_ranks(_dist_rank, shape[0], (args, shape[0]), args.device)


def _dist_rank(local_rank: int, args, n_env: int):
    """One rank of a ``--distributed`` run (spawned ranks import it by
    name)."""
    from paddlerobotics_torch.parallel import launch, sharding

    device = launch.rank_device(args.device, local_rank)
    run(args, sharding.make_mesh(n_env, 1, device_type=device.type), device)


def run(args, mesh=None, device=None):
    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                          synthetic_batch)
    from paddlerobotics_torch.parallel import sharding
    from paddlerobotics_torch.train import checkpoints, metrics as m

    dev = resolve_device(device or args.device)
    cfg = ctrl_config(args, args.inputs_type,
                      bool(args.use_pallas_attention))
    trainer = AttentionTrainer(cfg, lr=args.lr, weight_decay=args.l2,
                               mesh=mesh, device=dev)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    state = trainer.init(gen)
    sharding.replicate(mesh, state.model)
    writer = sharding.is_writer()
    if args.init_params:
        restored = checkpoints.restore(args.init_params, device=dev)
        checkpoints.load_attn_state(state, restored["attn"])
        if writer:
            print(f"resumed from {args.init_params} at step {state.step}")
    logger = (m.MetricsLogger(args.outdir, use_tensorboard=False) if writer
              else m.NullLogger())
    rng = np.random.RandomState(0)

    aux = None
    for epoch in range(args.epochs):
        batches = ([synthetic_batch(cfg, rng, args.batch_size, dev)
                    for _ in range(args.synthetic)]
                   if args.synthetic else
                   npz_batches(args.data_dir, args.batch_size, dev))
        for batch in batches:
            aux = trainer.train_step(state, trainer.shard_batch(batch))
            if state.step % 10 == 0 or args.synthetic:
                logger.add_scalar("train/loss", float(aux["loss"]),
                                  state.step)
                logger.add_scalar("train/trigger_loss",
                                  float(aux["trigger_loss"]), state.step)
        loss = float("nan") if aux is None else float(aux["loss"])
        if writer:
            checkpoints.save_attn(args.outdir, state)
            print(f"epoch {epoch} loss {loss:.4f}")
    logger.close()
    return state


if __name__ == "__main__":
    main()
