"""Export a trained attention controller as a serving bundle (PyTorch port
of the JAX package's ``cli/export_hri_model.py``, rebuild of
scripts/save_infer_model_params.py).

    python -m paddlerobotics_torch.cli.export_hri_model \\
        --ckpt attn_log/itr_100.pt --out bundle/ [--wae raw_wae.npy]

Reads a ``cli.train_attention`` checkpoint on the CPU and writes the
port's bundle (``hri.export``); ``hri.export.load_bundle`` builds it on the
card. The width flags must describe the checkpoint's controller.
``--darknet_cfg`` adds a scene sensor built from a Darknet cfg at 416²
(``DarknetSceneSensor``), its weights from ``--darknet_weights`` when given
and otherwise drawn from a seed; the bundle's manifest names both files.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint (cli/train_attention itr_<step>.pt)")
    p.add_argument("--out", required=True, help="bundle output dir")
    p.add_argument("--inputs_type", type=str, default="visual_token")
    p.add_argument("--num_actions", type=int, default=317)
    p.add_argument("--num_frames", type=int, default=10)
    p.add_argument("--tokens_per_frame", type=int, default=20)
    p.add_argument("--model_dim", type=int, default=512)
    p.add_argument("--num_decoder_blocks", type=int, default=6)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--ffn_dim", type=int, default=2048)
    p.add_argument("--darknet_cfg", type=str, default="",
                   help="darknet .cfg → scene params too")
    p.add_argument("--darknet_weights", type=str, default="",
                   help="darknet .weights for --darknet_cfg")
    p.add_argument("--wae", type=str, default="",
                   help="action embedding table .npy")
    p.add_argument("--trigger_threshold", type=float, default=0.8)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from paddlerobotics_torch.cli.train_attention import ctrl_config
    from paddlerobotics_torch.hri import export as export_mod
    from paddlerobotics_torch.hri.attention_ctrl import AttentionController
    from paddlerobotics_torch.train import checkpoints

    cfg = ctrl_config(args, args.inputs_type)
    restored = checkpoints.restore(args.ckpt, device="cpu")
    # the flags' controller must take the checkpoint's weights
    ctrl = AttentionController(cfg, device="cpu")
    ctrl.load_state_dict(restored["attn"]["model"])
    scene = scene_meta = None
    if args.darknet_cfg:
        from paddlerobotics_torch.hri.perception import darknet
        from paddlerobotics_torch.hri.perception.scene import \
            DarknetSceneSensor

        with open(args.darknet_cfg) as f:
            sections = darknet.parse_cfg(f.read())
        gen = torch.Generator()
        gen.manual_seed(1)
        scene = DarknetSceneSensor(sections, input_size=416, device="cpu",
                                   generator=gen)
        if args.darknet_weights:
            darknet.load_darknet_weights(scene.model, sections,
                                         args.darknet_weights)
        scene_meta = {"cfg": args.darknet_cfg,
                      "weights": args.darknet_weights}
    wae = np.load(args.wae) if args.wae else None
    export_mod.save_bundle(
        args.out, cfg, ctrl.state_dict(), scene=scene, wae=wae,
        extra={"trigger_threshold": args.trigger_threshold},
        scene_meta=scene_meta)
    print(f"bundle written to {args.out}")


if __name__ == "__main__":
    main()
