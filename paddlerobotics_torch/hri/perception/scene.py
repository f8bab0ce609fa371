"""Scene sensor: YOLOv4 detector + visual tokenizer (port of the JAX
package's ``hri/perception/scene.py``, ``arch="yolov4"``).

Per image: decode, person-class NMS (score ≥ 0.25) to at most 20
instances, RoIAlign of
the stride-32 feature map (5×5), and per instance a 562-d token = the
RoI's global average (512) + the sin bbox position embedding (50); absent
slots are zero and marked invalid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri import utils
from paddlerobotics_torch.hri.perception import roi_align, yolo
from paddlerobotics_torch.utils.init import flax_default_

MAX_INSTANCES = 20       # attention_ctrl tokens_per_frame
SCORE_THRESHOLD = 0.25
TOKEN_DIM = 562          # 512 GAP + 50 pos emb
PERSON_CLASS = 0         # COCO person


class Instances(NamedTuple):
    boxes: torch.Tensor    # (B,K,4) xyxy in input coords
    scores: torch.Tensor   # (B,K)
    classes: torch.Tensor  # (B,K)
    valid: torch.Tensor    # (B,K) bool
    tokens: torch.Tensor   # (B,K,TOKEN_DIM) visual tokens
    feats: torch.Tensor    # (B,K,5,5,C) RoIAligned feature maps


class SceneSensor:
    """Holds the YOLOv4 module (inference mode); runs on the card unless
    ``device`` says otherwise. ``generator`` draws flax-default weights;
    ``convert.scene_from_flax`` carries trained ones across."""

    def __init__(self, num_classes: int = 80, input_size: int = 416,
                 arch: str = "yolov4", device=None,
                 generator: Optional[torch.Generator] = None):
        if arch != "yolov4":
            raise NotImplementedError(f"arch {arch!r}: the port has yolov4")
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.input_size = input_size
        self.arch = arch
        self.model = yolo.YOLOv4(num_classes, device=self.device).eval()
        self.model.requires_grad_(False)
        self.anchors = yolo.YOLOV4_ANCHORS
        if generator is not None:
            flax_default_(self.model, generator)

    def _forward(self, images: torch.Tensor):
        """images (B,S,S,3) NHWC → (boxes (B,N,4), scores (B,N,C), fm
        (B,h,w,512) NHWC)."""
        preds, fm = self.model(images.permute(0, 3, 1, 2))
        boxes, scores = yolo.decode_predictions(
            preds, self.anchors, self.num_classes, self.input_size)
        return boxes, scores, fm

    def instances_from_predictions(self, boxes, scores, fm) -> Instances:
        """Decoded (boxes, scores, fm) → Instances with (B,K,...) leaves;
        every kept instance is a person (class 0)."""
        outs = []
        for b, s, f in zip(boxes, scores, fm):
            kb, ks, valid = yolo.nms_topk(b, s[:, PERSON_CLASS],
                                          max_dets=MAX_INSTANCES,
                                          score_threshold=SCORE_THRESHOLD)
            feats = roi_align.roi_align(
                f, kb, output_size=5,
                spatial_scale=f.shape[0] / self.input_size)
            gap = feats.mean(dim=(1, 2))                   # (K,C)
            pos = utils.get_bbox_pos_emb(kb, self.input_size,
                                         self.input_size)  # (K,2,5,5)
            tokens = torch.cat([gap, pos.reshape(pos.shape[0], -1)], dim=-1)
            tokens = tokens * valid[:, None]
            classes = torch.zeros_like(valid, dtype=torch.int64)
            outs.append(Instances(kb, ks, classes, valid, tokens, feats))
        return Instances(*[torch.stack(x) for x in zip(*outs)])

    @torch.no_grad()
    def get_instances_with_feats(self, images: torch.Tensor) -> Instances:
        """images (B,S,S,3) in [0,1] → Instances with (B,K,...) leaves."""
        return self.instances_from_predictions(*self._forward(images))
