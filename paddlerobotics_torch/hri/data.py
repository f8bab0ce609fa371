"""Dataset pipeline for attention-controller training (port of the JAX
package's ``hri/data.py``).

Annotation parsing and the train/test split (``XiaoduHiDataset``), the
pos/neg window sampler and the per-window feed assembly are numpy code,
drawn in the JAX package's order, so one seed gives the same windows and
splits in both packages. The detector runs on the card inside the
loader's tokenize function over batched frames; the host side is video
decode, window sampling and a small prefetch thread.

``WindowTokenizer`` is the loader's tokenize function: a sampled batch of
windows → frames → the scene sensor (one detect over all their frames) →
tokens as ``hri/serving.py`` builds them → ``assemble_training_sample`` →
a training batch on the card.

``PrefetchLoader`` differs from the JAX loader in one behaviour: a worker
that raises records its exception, which ``__iter__`` raises once the
batches before it are consumed (the JAX worker stops on any exception and
its ``__iter__`` then waits forever), and ``close()`` joins the thread.

Sample layout matches attention_ctrl's feeds: visual_tokens (F·K, 562),
frame_ids, padding_mask, act_ids (F,), has_act (F,), is_obj (F·K,).
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class AnnotatedMoment:
    """One annotated trigger moment in a video (anno txt line)."""

    video: str
    frame: int
    act_id: int
    target_bbox: Optional[List[float]] = None


def parse_annotation_file(path: str) -> List[AnnotatedMoment]:
    """Parse the reference's anno txt (data.py:28-60): lines of
    `video_path frame_idx act_id [x0 y0 x1 y1]`."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            bbox = [float(v) for v in parts[3:7]] if len(parts) >= 7 else None
            out.append(AnnotatedMoment(parts[0], int(parts[1]),
                                       int(parts[2]), bbox))
    return out


class XiaoduHiDataset:
    """Annotation container with deterministic train/test split
    (data.py:62-88 pkl semantics, json instead of pickle)."""

    def __init__(self, moments: Sequence[AnnotatedMoment],
                 test_frac: float = 0.1, seed: int = 0):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(moments))
        n_test = int(len(moments) * test_frac)
        self.test = [moments[i] for i in idx[:n_test]]
        self.train = [moments[i] for i in idx[n_test:]]

    def save(self, path: str):
        def ser(ms):
            return [dataclasses.asdict(m) for m in ms]

        with open(path, "w") as f:
            json.dump({"train": ser(self.train), "test": ser(self.test)}, f)

    @staticmethod
    def load(path: str) -> "XiaoduHiDataset":
        with open(path) as f:
            d = json.load(f)
        ds = XiaoduHiDataset([], 0.0)
        ds.train = [AnnotatedMoment(**m) for m in d["train"]]
        ds.test = [AnnotatedMoment(**m) for m in d["test"]]
        return ds


def read_video_frames(path: str, indices: Sequence[int], size: int = 416,
                      device=None) -> torch.Tensor:
    """Decode specific frames on the host (cv2) → (N,size,size,3) in [0,1],
    letterboxed on the card unless ``device`` says otherwise. A frame that
    does not decode is black, as in the JAX package."""
    import cv2

    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.hri.utils import letterbox_image

    dev = resolve_device(device)
    cap = cv2.VideoCapture(path)
    frames = []
    for i in indices:
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, img = cap.read()
        if not ok:
            img = np.zeros((size, size, 3), np.uint8)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        frames.append(letterbox_image(torch.as_tensor(img, device=dev), size))
    cap.release()
    return torch.stack(frames)


class WindowSampler:
    """Pos/neg training-window sampler (data.py:244-500 semantics).

    Positive: the `num_frames` window ending at an annotated moment, with
    has_act=1 and act_id at the final frame. Negative: windows away from
    any annotation (plus externally mined full negatives from deployment
    logs — the reference's `full_neg` txt, train_attention_controller
    .py:51-55 — appended via `add_negatives`).
    """

    def __init__(self, dataset: Sequence[AnnotatedMoment],
                 num_frames: int = 10, neg_ratio: float = 1.0, seed: int = 0):
        self.moments = list(dataset)
        self.num_frames = num_frames
        self.neg_ratio = neg_ratio
        self.rng = np.random.RandomState(seed)
        self.extra_negatives: List[AnnotatedMoment] = []

    def add_negatives(self, moments: Sequence[AnnotatedMoment]):
        self.extra_negatives.extend(moments)

    def sample(self) -> tuple:
        """→ (video, frame_indices, act_id, is_positive)."""
        pool_neg = self.extra_negatives
        p_neg = self.neg_ratio / (1.0 + self.neg_ratio)
        if pool_neg and self.rng.rand() < p_neg:
            m = pool_neg[self.rng.randint(len(pool_neg))]
            positive = False
            act_id = 0
        else:
            m = self.moments[self.rng.randint(len(self.moments))]
            positive = True
            act_id = m.act_id
        end = max(m.frame, self.num_frames - 1)
        if not positive:
            end += self.rng.randint(0, 50)
        frames = list(range(end - self.num_frames + 1, end + 1))
        return m.video, frames, act_id, positive


_FAILED = object()


class PrefetchLoader:
    """Background-thread prefetcher: host decode feeding a device tokenize
    function (replaces the reference's mp worker fleet).

    The worker samples ``batch_size`` items, tokenizes them and queues the
    result (a batch the consumer leaves queued for 5 s is dropped, as in the
    JAX loader). If ``sample_fn`` or ``tokenize_fn`` raises, the worker
    records the exception in ``error`` and stops; ``__iter__`` yields the
    batches queued before it and then raises it."""

    def __init__(self, sample_fn, tokenize_fn, batch_size: int,
                 prefetch: int = 4):
        self.sample_fn = sample_fn
        self.tokenize_fn = tokenize_fn
        self.batch_size = batch_size
        self.error: Optional[BaseException] = None
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = [self.sample_fn() for _ in range(self.batch_size)]
                self.q.put(self.tokenize_fn(batch), timeout=5)
            except queue.Full:
                continue
            except Exception as e:          # raised again by __iter__
                self.error = e
                break
        if self.error is not None:
            while not self._stop.is_set():
                try:
                    self.q.put(_FAILED, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        while True:
            item = self.q.get()
            if item is _FAILED:
                raise self.error
            yield item

    def close(self):
        """Stop the worker and join it (queued batches are discarded)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


class WindowTokenizer:
    """``PrefetchLoader``'s tokenize: windows ``(video, frame_indices,
    act_id, positive)`` (``WindowSampler.sample``) → the batch dict of
    ``AttentionTrainer.train_step`` on the card unless ``device`` says
    otherwise.

    ``read_frames(video, indices)`` gives a window's (F,S,S,3) frames in
    [0, 1] at the scene sensor's input size (default
    ``read_video_frames``); the scene sensor must be on the same device.
    The instances' tokens and valid masks are those the service windows
    (``scene.get_instances_with_feats``), read back for the numpy
    assembly."""

    def __init__(self, scene, read_frames=None, device=None):
        from paddlerobotics_torch.core.device import resolve_device

        self.device = resolve_device(device)
        self.scene = scene
        self.read_frames = read_frames or (
            lambda video, idx: read_video_frames(
                video, idx, scene.input_size, self.device))

    def __call__(self, windows) -> dict:
        from paddlerobotics_torch.hri.train_attention import to_device

        frames = torch.cat([torch.as_tensor(
            self.read_frames(video, idx), dtype=torch.float32,
            device=self.device) for video, idx, _, _ in windows])
        inst = self.scene.get_instances_with_feats(frames)
        n, F = len(windows), frames.shape[0] // len(windows)
        tokens = inst.tokens.reshape(n, F, *inst.tokens.shape[1:])
        valid = inst.valid.reshape(n, F, -1)
        tokens, valid = tokens.cpu().numpy(), valid.cpu().numpy()
        samples = [assemble_training_sample(tokens[i], valid[i], act, pos)
                   for i, (_, _, act, pos) in enumerate(windows)]
        return to_device({k: np.stack([s[k] for s in samples])
                          for k in samples[0]}, self.device)


def assemble_training_sample(tokens: np.ndarray, valid: np.ndarray,
                             act_id: int, positive: bool,
                             target_token: Optional[int] = None):
    """Per-window feeds for the controller (data.py token assembly).

    tokens (F,K,562), valid (F,K) → dict of flat arrays.
    """
    F, K, D = tokens.shape
    frame_ids = np.repeat(np.arange(1, F + 1), K)
    padding = valid.reshape(-1).astype(np.float32)
    has_act = np.zeros(F, np.float32)
    act_ids = np.zeros(F, np.int64)
    is_obj = np.zeros(F * K, np.float32)
    if positive:
        has_act[-1] = 1.0
        act_ids[-1] = act_id
        if target_token is not None:
            is_obj[(F - 1) * K + target_token] = 1.0
    return {
        "visual_tokens": tokens.reshape(F * K, D),
        "frame_ids": frame_ids,
        "padding_mask": padding,
        "has_act": has_act,
        "act_ids": act_ids,
        "is_obj": is_obj,
    }
