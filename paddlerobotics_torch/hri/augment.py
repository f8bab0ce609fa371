"""Video augmentation and salutation dataset construction (port of the JAX
package's ``hri/augment.py``).

- `VideoAugmentor` ← VideoAugmentorV2 (data.py:222-241): probabilistic
  per-clip intensity multiplication, drawn from numpy's ``RandomState`` in
  the JAX package's order, so one seed augments the same clips the same
  way; a tensor clip stays on its device, a numpy clip stays numpy.
- `SalutationDataset` ← SalutationClsDataset (data.py:89-220): collects
  per-video jsonl annotations with a `Salutation` label, splits
  train/test BY VIDEO, and encodes each label through the decision-tree
  targets (tree_mask, cls0, cls1, cls2) that SalutationClsTree consumes
  (salutation_cls.py; mapping at data.py:181-194). Crop/feature
  extraction is injected as a callable.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Salutation → (tree_mask, cls0 gender, cls1 male-age, cls2 female-age)
# exactly data.py:181-194.
SALUTATION_TREE = {
    "man": ("100", 0, -1, -1),
    "woman": ("100", 1, -1, -1),
    "young_boy": ("110", 0, 0, -1),
    "uncle": ("110", 0, 1, -1),
    "young_girl": ("101", 1, -1, 0),
    "aunt": ("101", 1, -1, 1),
}


class VideoAugmentor:
    """Per-clip intensity augmentation (VideoAugmentorV2 semantics):
    each (prob, value) pair independently multiplies the whole clip's
    intensity with probability `prob`."""

    def __init__(self,
                 intensity_mul_probs: Sequence[float] = (0.2, 0.2),
                 intensity_mul_values: Sequence[float] = (1.1, 0.9),
                 seed: int = 0):
        assert len(intensity_mul_probs) == len(intensity_mul_values)
        self.probs = list(intensity_mul_probs)
        self.values = list(intensity_mul_values)
        self.rng = np.random.RandomState(seed)

    def __call__(self, frames):
        """frames (T,H,W,3) in [0,1], an array or a tensor → augmented
        clip, same shape, float32, of the same kind (a tensor on its
        device)."""
        if isinstance(frames, torch.Tensor):
            out = frames.to(torch.float32)
            clip = torch.clamp
        else:
            out = np.asarray(frames, np.float32)
            clip = np.clip
        for p, v in zip(self.probs, self.values):
            if self.rng.rand() < p:
                out = clip(out * v, 0.0, 1.0)
        return out


@dataclasses.dataclass
class SalutationSample:
    video: str
    track_id: int
    salutation: str

    @property
    def tree_targets(self) -> Tuple[str, int, int, int]:
        return SALUTATION_TREE[self.salutation]


class SalutationDataset:
    """Salutation-classification dataset from per-video jsonl annos.

    anno_dir layout (SalutationClsDataset._collect_annotations,
    data.py:101-112): one `<video>_<take>_*.jsonl`-style file per video,
    each line a JSON object with at least {"ID": track_id,
    "Salutation": label}; 'null' labels are dropped. The train/test
    split is by VIDEO (test_percentage of videos go to test,
    data.py:114-133) so a person never straddles the split.
    """

    def __init__(self, anno_dir: str, test_percentage: float = 0.2,
                 seed: int = 0):
        self.annos: List[SalutationSample] = []
        for fname in sorted(os.listdir(anno_dir)):
            video_id = "_".join(fname.split("_")[:2])
            with open(os.path.join(anno_dir, fname)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    a = json.loads(line)
                    if a.get("Salutation", "null") == "null":
                        continue
                    self.annos.append(SalutationSample(
                        video_id, int(a["ID"]), a["Salutation"]))
        videos = sorted({a.video for a in self.annos})
        rng = np.random.RandomState(seed)
        rng.shuffle(videos)
        n_test = int(len(videos) * test_percentage)
        test_videos = set(videos[:n_test])
        self.test = [a for a in self.annos if a.video in test_videos]
        self.train = [a for a in self.annos if a.video not in test_videos]
        rng.shuffle(self.train)

    def build(self, crop_fn: Callable[[SalutationSample], Optional[np.ndarray]]
              ) -> Dict[str, List[Tuple[np.ndarray, Tuple[str, int, int, int]]]]:
        """Materialize (feature, tree-target) pairs per split.

        `crop_fn` maps a sample to its person-crop feature (the
        reference runs YOLOv4 RoI feats over tracked frames,
        data.py:135-200); returning None skips the sample (the
        reference's max_iou miss warning)."""
        out = {"train": [], "test": []}
        for split, samples in (("train", self.train), ("test", self.test)):
            for s in samples:
                feat = crop_fn(s)
                if feat is None:
                    continue
                out[split].append((feat, s.tree_targets))
        return out
