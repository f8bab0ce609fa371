"""Dataset preparation CLI (port of the JAX package's
``cli/prepare_dataset.py``, a rebuild of scripts/prepare_dataset.py):
split annotated moments into train/test sets, optionally build the
salutation-classifier dataset.

Variants (the reference's --data_version):
  ds          annotations + tracking pkls → train/test json
              (XiaoduHiDataset.build_dataset equivalent)
  salutation  per-video jsonl salutation annos → salutation train/test
              npz (SalutationClsDataset equivalent)

The reference's `ds_decord` variant (a second dataloader around the
same pkls, data_via_decord.py) is collapsed by design — one loader
serves both (hri/data.py PrefetchLoader).
"""

from __future__ import annotations

import argparse
import glob
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_version", "-dv", type=str, default="ds",
                   choices=["ds", "salutation"])
    p.add_argument("--output_dir", "-o", type=str, default="data")
    p.add_argument("--anno_dir", "-ad", type=str, default="data/annos")
    p.add_argument("--video_tracking_dir", "-vd", type=str,
                   default="data/clips")
    p.add_argument("--wae_dir", "-wd", type=str, default="",
                   help="dir with raw_wae.npy (collect_act_emb output); "
                   "copied into the dataset dir when given")
    p.add_argument("--test_frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    return p


def prepare_ds(args):
    from paddlerobotics_torch.hri.data import (XiaoduHiDataset,
                                               parse_annotation_file)

    moments = []
    for path in sorted(glob.glob(os.path.join(args.anno_dir, "*.txt"))):
        moments.extend(parse_annotation_file(path))
    if not moments:
        raise SystemExit(f"no annotation files under {args.anno_dir}")
    ds = XiaoduHiDataset(moments, test_frac=args.test_frac,
                         seed=args.seed)
    out = os.path.join(args.output_dir, "dataset.json")
    ds.save(out)
    print(f"{len(ds.train)} train / {len(ds.test)} test moments → {out}")

    if args.wae_dir:
        import shutil

        src = os.path.join(args.wae_dir, "raw_wae.npy")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.output_dir, "raw_wae.npy"))
            print("copied raw_wae.npy")


def prepare_salutation(args):
    import json

    from paddlerobotics_torch.hri.augment import SalutationDataset

    ds = SalutationDataset(args.anno_dir, test_percentage=args.test_frac,
                           seed=args.seed)
    ser = lambda samples: [
        {"video": s.video, "track_id": s.track_id,
         "salutation": s.salutation, "tree_targets": s.tree_targets}
        for s in samples]
    out = os.path.join(args.output_dir, "salutation.json")
    with open(out, "w") as f:
        json.dump({"train": ser(ds.train), "test": ser(ds.test)}, f)
    print(f"{len(ds.train)} train / {len(ds.test)} test salutation "
          f"samples → {out} (crops materialized by the training loader "
          f"via SalutationDataset.build)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.data_version == "ds":
        prepare_ds(args)
    else:
        prepare_salutation(args)


if __name__ == "__main__":
    main()
