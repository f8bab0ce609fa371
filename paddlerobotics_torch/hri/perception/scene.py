"""Scene sensor: detector + visual tokenizer (port of the JAX package's
``hri/perception/scene.py``: ``SceneSensor`` with ``arch`` "yolov4" or
"yolov3", and ``DarknetSceneSensor`` on a cfg-built network).

Per image: decode, person-class NMS (score ≥ 0.25 by default) to at most
20 instances, RoIAlign of the feature map (5×5; YOLOv4's and YOLOv3's
stride-32 h5, 512 channels), and per instance a token = the RoI's global
average + the sin bbox position embedding (50), 562-d on a 512-channel
map; absent slots are zero and marked invalid.
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
    """Holds the YOLOv4 or YOLOv3 module (inference mode); runs on the card
    unless ``device`` says otherwise. ``generator`` draws flax-default
    weights; ``convert.scene_from_flax`` carries trained ones across."""

    def __init__(self, num_classes: int = 80, input_size: int = 416,
                 arch: str = "yolov4", device=None,
                 generator: Optional[torch.Generator] = None):
        if arch not in ("yolov4", "yolov3"):
            raise ValueError(f"arch {arch!r}: yolov4 or yolov3")
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.input_size = input_size
        self.arch = arch
        net = yolo.YOLOv4 if arch == "yolov4" else yolo.YOLOv3
        self.model = net(num_classes, device=self.device).eval()
        self.model.requires_grad_(False)
        self.anchors = (yolo.YOLOV4_ANCHORS if arch == "yolov4"
                        else yolo.YOLOV3_ANCHORS)
        if generator is not None:
            flax_default_(self.model, generator)

    def _forward(self, images: torch.Tensor):
        """images (B,S,S,3) NHWC → (boxes (B,N,4), scores (B,N,C), fm
        (B,h,w,512) NHWC)."""
        preds, fm = self.model(images.permute(0, 3, 1, 2))
        boxes, scores = yolo.decode_predictions(
            preds, self.anchors, self.num_classes, self.input_size)
        return boxes, scores, fm

    def instances_from_predictions(self, boxes, scores, fm,
                                   score_threshold: float = SCORE_THRESHOLD
                                   ) -> Instances:
        """Decoded (boxes, scores, fm) → Instances with (B,K,...) leaves;
        every kept instance is a person (class 0)."""
        outs = []
        for b, s, f in zip(boxes, scores, fm):
            kb, ks, valid = yolo.nms_topk(b, s[:, PERSON_CLASS],
                                          max_dets=MAX_INSTANCES,
                                          score_threshold=score_threshold)
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
    def get_instances_with_feats(self, images: torch.Tensor,
                                 score_threshold: float = SCORE_THRESHOLD
                                 ) -> Instances:
        """images (B,S,S,3) in [0,1] → Instances with (B,K,...) leaves."""
        return self.instances_from_predictions(*self._forward(images),
                                               score_threshold)

    @torch.no_grad()
    def get_feature_map(self, images: torch.Tensor) -> torch.Tensor:
        """images (B,S,S,3) in [0,1] → the RoIAlign map (B,h,w,C), NHWC."""
        return self._forward(images)[2]

    def get_instances(self, images: torch.Tensor, **kw):
        """images → (boxes (B,K,4), scores (B,K), valid (B,K))."""
        inst = self.get_instances_with_feats(images, **kw)
        return inst.boxes, inst.scores, inst.valid


class DarknetSceneSensor(SceneSensor):
    """``SceneSensor`` on a cfg-built ``DarknetNet``, so imported
    ``.weights`` drive the same detect → RoIAlign → token path.

    ``fm_layer`` is the section whose output is the RoIAlign map; by
    default the deepest section with 512 output channels (a 562-d token),
    else the last. Each [yolo] head decodes with its own anchors, classes
    and ``scale_x_y``. ``input_size`` defaults to the cfg's [net] width."""

    def __init__(self, sections, input_size: Optional[int] = None,
                 fm_layer: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        from paddlerobotics_torch.hri.perception import darknet

        self.device = resolve_device(device)
        self.sections = sections
        if input_size is None:
            net_opt = dict(sections[0][1]) if sections else {}
            input_size = int(net_opt.get("width", 416))
        self.input_size = input_size
        self.arch = "darknet"
        self.model = darknet.DarknetNet(sections, device=self.device).eval()
        self.model.requires_grad_(False)
        self.metas = darknet.yolo_meta(sections)
        self.num_classes = self.metas[0]["classes"] if self.metas else 80
        if fm_layer is None:
            picks = [i for i, c in enumerate(self.model.channels) if c == 512]
            fm_layer = picks[-1] if picks else len(sections) - 1
        self.fm_layer = fm_layer
        if generator is not None:
            flax_default_(self.model, generator)

    def _forward(self, images: torch.Tensor):
        yolo_outs, outs = self.model(images.permute(0, 3, 1, 2))
        all_b, all_s = [], []
        for p, meta in zip(yolo_outs, self.metas):
            b, s = yolo.decode_predictions(
                [p.permute(0, 2, 3, 1)], [meta["anchors"]], meta["classes"],
                self.input_size, scale_xy=meta["scale_xy"])
            all_b.append(b)
            all_s.append(s)
        return (torch.cat(all_b, dim=1), torch.cat(all_s, dim=1),
                outs[self.fm_layer].permute(0, 2, 3, 1))
