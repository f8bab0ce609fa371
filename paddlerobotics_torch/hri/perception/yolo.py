"""YOLOv4 and YOLOv3 with fixed-shape decode and NMS (port of the JAX
package's ``hri/perception/yolo.py``: ``SPP``, ``YOLOv4Neck``, ``YOLOHead``,
``YOLOv4``, ``YOLOv3``, the anchors, ``decode_predictions``, ``nms_topk``,
``nms_topk_multiclass``, ``_iou_one``).

The network runs NCHW; ``YOLOv4.forward`` returns the head outputs and the
stride-32 feature map NHWC, the JAX package's layout, so decode, NMS and
RoIAlign take the same arrays as their JAX counterparts. Submodules carry
the flax scope names (``CSPDarknet53_0``, ``YOLOv4Neck_0``, ``ConvBN_17``,
``YOLOHead_0``, ``Conv_2`` …) for ``convert.load_flax``; the neck's ConvBNs
are numbered in flax's order of creation.

NMS ranks candidates with a stable descending sort, so equal scores keep
the lower index first, as ``lax.top_k`` does; ``argmax`` picks the first
maximum in both frameworks.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.hri.perception.backbones import (ConvBN,
                                                           CSPDarknet53,
                                                           Darknet53)

# COCO anchors (yolov4.cfg / ppdet yolov3 defaults), per scale small→large
YOLOV4_ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)
YOLOV3_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)


class SPP(nn.Module):
    """Max pools 5, 9, 13 (stride 1, SAME), concatenated
    ``[pool13, pool9, pool5, x]``."""

    def forward(self, x):
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)]
        return torch.cat(pools[::-1], dim=1)


def _upsample(x):
    """Nearest 2× (``jax.image.resize`` "nearest" at exactly 2×)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _conv5_specs(cin: int, f: int):
    return [(cin, f, 1, 1), (f, 2 * f, 3, 1), (2 * f, f, 1, 1),
            (f, 2 * f, 3, 1), (2 * f, f, 1, 1)]


# (cin, features, kernel, stride) of the neck's ConvBN_0..ConvBN_33, in the
# order flax creates them (YOLOv4Neck.__call__)
_NECK = ([(1024, 512, 1, 1), (512, 1024, 3, 1), (1024, 512, 1, 1)]
         + _conv5_specs(2048, 512)                            # 3-7
         + [(512, 256, 1, 1), (512, 256, 1, 1)]               # 8 (h5), 9 (c4)
         + _conv5_specs(512, 256)                             # 10-14
         + [(256, 128, 1, 1), (256, 128, 1, 1)]               # 15 (h4), 16 (c3)
         + _conv5_specs(256, 128)                             # 17-21
         + [(128, 256, 3, 2)] + _conv5_specs(512, 256)        # 22, 23-27
         + [(256, 512, 3, 2)] + _conv5_specs(1024, 512))      # 28, 29-33


class YOLOv4Neck(nn.Module):
    """SPP + PANet over (C3, C4, C5)."""

    def __init__(self, device=None):
        super().__init__()
        for i, (cin, f, k, s) in enumerate(_NECK):
            setattr(self, f"ConvBN_{i}", ConvBN(cin, f, k, s, device=device))
        self.spp = SPP()

    def _cb(self, i, x):
        return getattr(self, f"ConvBN_{i}")(x)

    def _conv5(self, i0, x):
        for i in range(i0, i0 + 5):
            x = self._cb(i, x)
        return x

    def forward(self, c3, c4, c5):
        h5 = self._cb(2, self._cb(1, self._cb(0, c5)))
        h5 = self._conv5(3, self.spp(h5))
        up4 = _upsample(self._cb(8, h5))
        h4 = self._conv5(10, torch.cat([self._cb(9, c4), up4], dim=1))
        up3 = _upsample(self._cb(15, h4))
        h3 = self._conv5(17, torch.cat([self._cb(16, c3), up3], dim=1))
        d4 = self._cb(22, h3)
        h4 = self._conv5(23, torch.cat([d4, h4], dim=1))
        d5 = self._cb(28, h4)
        h5 = self._conv5(29, torch.cat([d5, h5], dim=1))
        return h3, h4, h5


class YOLOHead(nn.Module):
    def __init__(self, num_classes: int, channels=(128, 256, 512),
                 num_anchors: int = 3, device=None):
        super().__init__()
        out = num_anchors * (5 + num_classes)
        for i, c in enumerate(channels):
            setattr(self, f"ConvBN_{i}", ConvBN(c, 2 * c, 3, device=device))
            setattr(self, f"Conv_{i}", nn.Conv2d(2 * c, out, 1, device=device))

    def forward(self, feats):
        return [getattr(self, f"Conv_{i}")(getattr(self, f"ConvBN_{i}")(h))
                for i, h in enumerate(feats)]


class YOLOv4(nn.Module):
    """CSPDarknet53 + SPP/PAN + heads. ``forward`` takes NCHW images and
    returns (head outputs NHWC (B,H,W,3·(5+C)) per scale, the stride-32
    feature map h5 NHWC) — h5 is the map the visual tokens RoIAlign."""

    def __init__(self, num_classes: int = 80, device=None):
        super().__init__()
        self.CSPDarknet53_0 = CSPDarknet53(device=device)
        self.YOLOv4Neck_0 = YOLOv4Neck(device=device)
        self.YOLOHead_0 = YOLOHead(num_classes, device=device)

    def forward(self, img):
        c3, c4, c5 = self.CSPDarknet53_0(img)
        h3, h4, h5 = self.YOLOv4Neck_0(c3, c4, c5)
        preds = self.YOLOHead_0([h3, h4, h5])
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return [nhwc(p) for p in preds], nhwc(h5)


# (cin, features, kernel, stride) of YOLOv3's own ConvBN_0..ConvBN_16 in
# flax's order: conv5 on C5, the 1×1 before the first upsample, conv5 on
# [up4, C4], the 1×1 before the second, conv5 on [up3, C3]
_V3_NECK = (_conv5_specs(1024, 512) + [(512, 256, 1, 1)]
            + _conv5_specs(768, 256) + [(256, 128, 1, 1)]
            + _conv5_specs(384, 128))


class YOLOv3(nn.Module):
    """Darknet53 + FPN-style neck + heads; ``forward`` as ``YOLOv4``'s."""

    def __init__(self, num_classes: int = 80, device=None):
        super().__init__()
        self.Darknet53_0 = Darknet53(device=device)
        for i, (cin, f, k, s) in enumerate(_V3_NECK):
            setattr(self, f"ConvBN_{i}", ConvBN(cin, f, k, s, device=device))
        self.YOLOHead_0 = YOLOHead(num_classes, device=device)

    def _conv5(self, i0, x):
        for i in range(i0, i0 + 5):
            x = getattr(self, f"ConvBN_{i}")(x)
        return x

    def forward(self, img):
        c3, c4, c5 = self.Darknet53_0(img)
        h5 = self._conv5(0, c5)
        up4 = _upsample(self.ConvBN_5(h5))
        h4 = self._conv5(6, torch.cat([up4, c4], dim=1))
        up3 = _upsample(self.ConvBN_11(h4))
        h3 = self._conv5(12, torch.cat([up3, c3], dim=1))
        preds = self.YOLOHead_0([h3, h4, h5])
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return [nhwc(p) for p in preds], nhwc(h5)


def decode_predictions(preds: Sequence[torch.Tensor], anchors,
                       num_classes: int, input_size: int = 416,
                       scale_xy: float = 1.0):
    """Raw head outputs (NHWC) → (boxes xyxy (B,N,4), scores (B,N,C)).

    xy = (sigmoid(t)·s − (s−1)/2 + grid)·stride, wh = anchor·exp(clip(t)),
    score = sigmoid(obj)·sigmoid(cls)."""
    all_boxes, all_scores = [], []
    for p, anc in zip(preds, anchors):
        B, H, W, _ = p.shape
        A = len(anc)
        p = p.reshape(B, H, W, A, 5 + num_classes)
        stride = input_size // W
        dev = p.device
        gx = torch.arange(W, device=dev)[None, None, :, None]
        gy = torch.arange(H, device=dev)[None, :, None, None]
        sx = torch.sigmoid(p[..., 0]) * scale_xy - (scale_xy - 1) / 2
        sy = torch.sigmoid(p[..., 1]) * scale_xy - (scale_xy - 1) / 2
        cx = (gx + sx) * stride
        cy = (gy + sy) * stride
        aw = torch.tensor([a[0] for a in anc], dtype=torch.float32,
                          device=dev)[None, None, None, :]
        ah = torch.tensor([a[1] for a in anc], dtype=torch.float32,
                          device=dev)[None, None, None, :]
        w = aw * torch.exp(torch.clamp(p[..., 2], -10, 8))
        h = ah * torch.exp(torch.clamp(p[..., 3], -10, 8))
        obj = torch.sigmoid(p[..., 4:5])
        cls = torch.sigmoid(p[..., 5:])
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            dim=-1)
        all_boxes.append(boxes.reshape(B, -1, 4))
        all_scores.append((obj * cls).reshape(B, -1, num_classes))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, max_dets: int = 20,
             iou_threshold: float = 0.45, score_threshold: float = 0.25,
             return_indices: bool = False):
    """Fixed-shape class-agnostic NMS for one image.

    boxes (N,4), scores (N,) → (boxes (K,4), scores (K,), valid (K,)[,
    kept_idx (K,)]), K = max_dets: greedy suppression over the 4·K best
    candidates, K rounds, no host synchronisation."""
    N = boxes.shape[0]
    K = max_dets
    dev = boxes.device
    order = torch.sort(scores, descending=True, stable=True).indices
    top_idx = order[:min(4 * K, N)]
    top_scores = scores[top_idx]
    top_boxes = boxes[top_idx]
    n_top = top_idx.shape[0]

    keep_boxes = torch.zeros((K, 4), dtype=boxes.dtype, device=dev)
    keep_scores = torch.zeros(K, dtype=scores.dtype, device=dev)
    keep_idx = torch.zeros(K, dtype=torch.int64, device=dev)
    n_kept = torch.zeros((), dtype=torch.int64, device=dev)
    suppressed = torch.zeros(n_top, dtype=torch.bool, device=dev)
    slots = torch.arange(K, device=dev)
    cands = torch.arange(n_top, device=dev)
    for _ in range(K):
        s = torch.where(suppressed, -1.0, top_scores)
        j = torch.argmax(s)
        ok = (s[j] >= score_threshold) & (n_kept < K)
        cand = top_boxes[j]
        put = ok & (slots == n_kept)
        keep_boxes = torch.where(put[:, None], cand, keep_boxes)
        keep_scores = torch.where(put, s[j], keep_scores)
        keep_idx = torch.where(put, top_idx[j], keep_idx)
        iou = _iou_one(cand, top_boxes)
        suppressed = suppressed | (ok & (iou > iou_threshold)) | (cands == j)
        n_kept = n_kept + ok.to(torch.int64)
    valid = slots < n_kept
    if return_indices:
        return keep_boxes, keep_scores, valid, keep_idx
    return keep_boxes, keep_scores, valid


def nms_topk_multiclass(boxes: torch.Tensor, scores: torch.Tensor,
                        max_dets: int = 20, iou_threshold: float = 0.45,
                        score_threshold: float = 0.25):
    """Per-class NMS: suppression only within a class, by translating each
    class's boxes to a disjoint region and running one agnostic pass.

    boxes (N,4), scores (N,C) → (boxes (K,4), scores (K,), class_ids (K,),
    valid (K,))."""
    N, C = scores.shape
    lo = torch.min(boxes)
    b0 = boxes - lo                                       # coords ≥ 0
    span = torch.max(b0) + 1.0
    flat_scores = scores.reshape(-1)                      # (N*C,)
    cls_ids = torch.arange(C, device=boxes.device).repeat(N)
    box_rep = torch.repeat_interleave(b0, C, dim=0)       # (N*C,4)
    offset = (cls_ids.to(boxes.dtype) * span)[:, None]
    kept_b, kept_s, valid = nms_topk(box_rep + offset, flat_scores,
                                     max_dets, iou_threshold, score_threshold)
    kc = torch.clamp(torch.floor(kept_b[:, 0] / span), 0, C - 1).to(
        torch.int32)
    kc = torch.where(valid, kc, 0)
    kept_b = kept_b - (kc.to(boxes.dtype) * span)[:, None] + lo
    return kept_b, kept_s, kc, valid


def _iou_one(box, boxes):
    lt = torch.maximum(box[:2], boxes[:, :2])
    rb = torch.minimum(box[2:], boxes[:, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[:, 0] * wh[:, 1]
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / torch.clamp(a + b - inter, min=1e-9)
