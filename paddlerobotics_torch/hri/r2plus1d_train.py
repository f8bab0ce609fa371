"""R(2+1)D baseline: dataset, trainer, eval sweep, inference program (port
of the JAX package's ``hri/r2plus1d_train.py``).

- ``ClipDataset``: positive annotated moments labelled by Scenario or
  WAE_id plus full-negative clips labelled as the null class, split and
  shuffled by a numpy ``RandomState`` as in JAX; clip loading is a callable
  returning (T,H,W,3) arrays.
- ``R2Plus1DTrainer``: softmax-CE training steps with Adam (optax's
  defaults are torch's) and flax-style BatchNorm running statistics, an
  epoch loop and an accuracy eval. Clips come in the JAX layout
  (B,T,H,W,3) and go to the model as (B,3,T,H,W).
- ``precision_recall_sweep``: the trigger-threshold sweep over
  P(non-null) (numpy, as in JAX).
- ``make_inference_fn``: logits/temperature → softmax probs, and a top-k
  sample over the non-null actions (null masked to −1e10, the top k
  renormalised, ``argmax(log(p + 1e-20) + g)`` with Gumbel g, as
  ``jax.random.categorical`` draws it; g is injectable).
- ``ClipScorer``: that program as the score callback of
  ``hri/native_pipeline.NativeClipEvalServer``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.attention_ctrl import gumbel
from paddlerobotics_torch.hri.r2plus1d import R2PLUS1D18_BLOCKS, R2Plus1D18


@dataclasses.dataclass
class ClipAnno:
    """One positive annotated moment (dataset.py pos_anno_lst rows)."""

    video: str
    time_ms: int
    scenario_id: int = 0
    wae_id: int = 0


class ClipDataset:
    """FramesDataset-equivalent clip dataset. ``group_by`` selects the label
    space: 'Scenario' → scenario_id, 'WAE_id' → wae_id; full negatives get
    label 0, the null class."""

    def __init__(self, annos: Sequence[ClipAnno], full_neg: Sequence[str],
                 load_clip: Callable[[str, int], np.ndarray],
                 num_classes: int, group_by: str = "WAE_id",
                 sample_length: int = 8, test_frac: float = 0.2,
                 seed: int = 0):
        if group_by not in ("Scenario", "WAE_id"):
            raise ValueError(f"group_by {group_by!r}: Scenario or WAE_id")
        self.load_clip = load_clip
        self.sample_length = sample_length
        self.num_classes = num_classes
        rows: List[Tuple[str, int, int]] = []
        for a in annos:
            label = a.scenario_id if group_by == "Scenario" else a.wae_id
            rows.append((a.video, a.time_ms, int(label)))
        for path in full_neg:
            rows.append((path, 0, 0))
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(rows))
        n_test = int(len(rows) * test_frac)
        self.test = [rows[i] for i in idx[:n_test]]
        self.train = [rows[i] for i in idx[n_test:]]
        self.rng = rng

    def _clip(self, row) -> Tuple[np.ndarray, int]:
        video, t, label = row
        clip = self.load_clip(video, t)
        if clip.shape[0] != self.sample_length:
            raise ValueError(f"clip of {clip.shape[0]} frames, expected "
                             f"{self.sample_length}")
        return clip.astype(np.float32), label

    def batches(self, split: str, batch_size: int):
        rows = self.train if split == "train" else self.test
        order = self.rng.permutation(len(rows)) if split == "train" \
            else np.arange(len(rows))
        for i in range(0, len(rows) - batch_size + 1, batch_size):
            batch = [self._clip(rows[j]) for j in order[i:i + batch_size]]
            clips = np.stack([b[0] for b in batch])
            labels = np.asarray([b[1] for b in batch], np.int32)
            yield clips, labels


class R2Plus1DTrainer:
    """Trains ``R2Plus1D18`` on the card unless ``device`` says otherwise;
    ``seed`` draws flax-default weights. ``model`` and ``opt`` (a
    ``torch.optim.Adam``) are updated in place."""

    def __init__(self, num_classes: int, lr: float = 1e-4, seed: int = 0,
                 blocks=None, stem_kernel: int = 7, device=None):
        self.device = resolve_device(device)
        g = torch.Generator(self.device)
        g.manual_seed(seed)
        self.model = R2Plus1D18(num_classes, blocks or R2PLUS1D18_BLOCKS,
                                stem_kernel, device=self.device, generator=g)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr)

    def _clips(self, clips) -> torch.Tensor:
        """(B,T,H,W,3) → (B,3,T,H,W) on the trainer's device."""
        return torch.as_tensor(np.asarray(clips), dtype=torch.float32,
                               device=self.device).permute(0, 4, 1, 2, 3)

    def train_step(self, clips, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on a batch; returns (loss, accuracy) tensors."""
        self.model.train()
        y = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                            device=self.device)
        logits = self.model(self._clips(clips))
        loss = F.cross_entropy(logits, y)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return loss.detach(), acc

    def fit(self, data: ClipDataset, epochs: int = 10, batch_size: int = 8,
            log: Optional[Callable[[str], None]] = None) -> Dict[str, float]:
        hist = {}
        for ep in range(epochs):
            losses, accs = [], []
            for clips, labels in data.batches("train", batch_size):
                loss, acc = self.train_step(clips, labels)
                losses.append(loss)
                accs.append(acc)
            hist = {"loss": float(torch.stack(losses).mean()),
                    "acc": float(torch.stack(accs).mean()), "epoch": ep}
            if log:
                log(f"epoch {ep}: loss {hist['loss']:.4f} "
                    f"acc {hist['acc']:.3f}")
        return hist

    @torch.no_grad()
    def predict_probs(self, clips) -> np.ndarray:
        self.model.eval()
        return torch.softmax(self.model(self._clips(clips)), -1).cpu().numpy()

    def evaluate(self, data: ClipDataset, batch_size: int = 8
                 ) -> Dict[str, float]:
        correct = total = 0
        probs_all, labels_all = [], []
        for clips, labels in data.batches("test", batch_size):
            probs = self.predict_probs(clips)
            correct += int((probs.argmax(-1) == labels).sum())
            total += len(labels)
            probs_all.append(probs)
            labels_all.append(labels)
        probs = np.concatenate(probs_all) if probs_all else np.zeros((0, 1))
        labels = np.concatenate(labels_all) if labels_all else np.zeros(0)
        return {"accuracy": correct / max(total, 1),
                "probs": probs, "labels": labels}


def precision_recall_sweep(probs: np.ndarray, labels: np.ndarray,
                           thresholds: Sequence[float] = tuple(
                               np.round(np.arange(0.05, 1.0, 0.05), 2)),
                           null_id: int = 0) -> List[Dict[str, float]]:
    """Trigger P/R sweep: predict 'interaction' when P(non-null) =
    1 − P(null) ≥ threshold."""
    p_trigger = 1.0 - probs[:, null_id]
    is_pos = labels != null_id
    rows = []
    for th in thresholds:
        pred = p_trigger >= th
        tp = int(np.sum(pred & is_pos))
        fp = int(np.sum(pred & ~is_pos))
        fn = int(np.sum(~pred & is_pos))
        rows.append({
            "threshold": float(th),
            "precision": tp / max(tp + fp, 1),
            "recall": tp / max(tp + fn, 1),
        })
    return rows


def make_inference_fn(model: R2Plus1D18, null_act_idx: int = 0):
    """infer(clip (B,3,T,H,W), temperature, top_k, noise=None,
    generator=None) → (probs over all classes (B,C), sampled non-null
    action ids (B,)). ``noise`` (B,C) is the Gumbel draw when given, else
    it is drawn from ``generator``."""

    @torch.no_grad()
    def infer(clip, temperature: float, top_k: int,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        model.eval()
        logits = model(clip) / temperature
        probs = torch.softmax(logits, -1)
        non_null = torch.ones(logits.shape[-1], device=logits.device)
        non_null[null_act_idx] = 0.0
        masked = logits * non_null - 1e10 * (1.0 - non_null)
        p = torch.softmax(masked, -1)
        kth = torch.topk(p, top_k, dim=-1).values[..., -1:]
        p_top = torch.where(p >= kth, p, 0.0)
        p_top = p_top / p_top.sum(-1, keepdim=True)
        if noise is None:
            if generator is None:
                raise ValueError("infer needs noise or a generator")
            noise = gumbel(p_top.shape, generator).to(p_top.device)
        return probs, torch.argmax(torch.log(p_top + 1e-20) + noise, -1)

    return infer


class ClipScorer:
    """The score callback of ``NativeClipEvalServer`` over a model on its
    device: clip (T,3,H,W) numpy → (probs (C,), sampled id), one read-back;
    draws from ``generator`` on the model's device."""

    def __init__(self, model: R2Plus1D18, temperature: float = 1.0,
                 top_k: int = 5, generator: Optional[torch.Generator] = None):
        self.device = next(model.parameters()).device
        self.infer = make_inference_fn(model)
        self.temperature, self.top_k = temperature, top_k
        if generator is None:
            generator = torch.Generator(self.device)
            generator.manual_seed(0)
        self.generator = generator

    def __call__(self, clip: np.ndarray):
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            x = torch.as_tensor(clip, dtype=torch.float32,
                                device=self.device).permute(1, 0, 2, 3)[None]
            probs, sample = self.infer(x, self.temperature, self.top_k,
                                       generator=self.generator)
            host = torch.cat([probs[0], sample.to(torch.float32)]).cpu()
        return host[:-1].numpy(), int(host[-1])
