"""Online proactive-greeting service (port of the JAX package's
``hri/serving.py``).

frame → detect + tokenize (``SceneSensor``) → 10-frame sliding window →
attention controller → business rules (trigger threshold, wakeup cooldown,
near field) → top-k action sampling → a JSON-able decision.

The service serves deterministically and never reads attention weights, so
its controller calls take the hand-written attention kernel
(``ops/attention.flash_attention``) whatever ``use_pallas_attention`` says:
on the card that is the CUDA kernel, on the CPU its plain version. The
windows stay on the service's device; the business rules read back one
small tensor per decided frame. Sampling draws from ``generator`` where the
JAX service splits a key.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.attention_ctrl import top_k_sampling
from paddlerobotics_torch.hri.perception.scene import MAX_INSTANCES


@dataclasses.dataclass
class ServiceConfig:
    num_frames: int = 10
    tokens_per_frame: int = MAX_INSTANCES
    trigger_threshold: float = 0.8      # per-variant 0.65–0.9
    temperature: float = 1.0
    top_k: int = 5
    near_field_frac: float = 0.4        # bbox height fraction ⇒ near field
    lag_skip_ms: float = 500.0          # drop frames older than this
    wakeup_cooldown_s: float = 5.0      # suppress re-trigger window


class ProactiveGreetingService:
    """Stateful host-side service around the scene sensor and the
    controller, both already on ``device`` (the card unless the caller
    asks for the CPU)."""

    def __init__(self, cfg: ServiceConfig, scene, ctrl,
                 action_catalog: Optional[List] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scene = scene
        self.ctrl = ctrl
        self.ctrl_cfg = ctrl.cfg
        self.catalog = action_catalog or []
        if generator is None:
            generator = torch.Generator(self.device)
            generator.manual_seed(0)
        self.generator = generator

        self.token_window: deque = deque(maxlen=cfg.num_frames)
        self.valid_window: deque = deque(maxlen=cfg.num_frames)
        self.box_window: deque = deque(maxlen=cfg.num_frames)
        self.frame_counter = 0
        self.last_trigger_time = -1e9
        nf, tpf = cfg.num_frames, cfg.tokens_per_frame
        self._frame_ids = torch.arange(
            1, nf + 1, device=self.device).repeat_interleave(tpf)[None]

    def _detect(self, images: torch.Tensor):
        return self.scene.get_instances_with_feats(images)

    @torch.no_grad()
    def _attend(self, tokens, frame_ids, padding) -> dict:
        return self.ctrl({"visual_tokens": tokens}, frame_ids, padding,
                         use_kernel=True)

    # -- per-frame processing -------------------------------------------------

    def process_frame(self, image, timestamp: Optional[float] = None) -> dict:
        """image (S,S,3) in [0,1], an array or a tensor → decision dict
        (JSON-able)."""
        now = time.time()
        timestamp = timestamp if timestamp is not None else now
        if (now - timestamp) * 1000.0 > self.cfg.lag_skip_ms:
            return {"triggered": False, "reason": "lag_skip"}

        img = torch.as_tensor(image, dtype=torch.float32,
                              device=self.device)[None]
        inst = self._detect(img)
        self.frame_counter += 1
        self.token_window.append(inst.tokens[0])          # (K,562)
        self.valid_window.append(inst.valid[0])
        self.box_window.append(inst.boxes[0])
        if len(self.token_window) < self.cfg.num_frames:
            return {"triggered": False, "reason": "window_filling"}

        nf, tpf = self.cfg.num_frames, self.cfg.tokens_per_frame
        win_tokens = torch.stack(list(self.token_window)).reshape(
            1, nf * tpf, -1)
        win_valid = torch.stack(list(self.valid_window)).reshape(
            1, nf * tpf).to(torch.float32)
        out = self._attend(win_tokens, self._frame_ids, win_valid)
        trigger_t = torch.sigmoid(out["trigger_logits"][0, -1])
        obj_t = torch.sigmoid(out["obj_logits"][0, -tpf:]) * \
            self.valid_window[-1].to(torch.float32)
        # one read-back for the business rules: trigger, obj scores, boxes
        host = torch.cat([trigger_t[None], obj_t,
                          self.box_window[-1].reshape(-1)]).cpu().numpy()
        trigger = float(host[0])
        obj_scores = host[1:1 + tpf]
        boxes = host[1 + tpf:].reshape(tpf, 4)

        decision = {"triggered": False, "trigger_score": trigger}
        if trigger < self.cfg.trigger_threshold:
            return decision
        if now - self.last_trigger_time < self.cfg.wakeup_cooldown_s:
            decision["reason"] = "cooldown"
            return decision

        # near field: the target bbox must be large enough in the frame
        target = int(np.argmax(obj_scores))
        box = boxes[target]
        height_frac = (box[3] - box[1]) / 416.0
        if height_frac < self.cfg.near_field_frac * 0.25:
            decision["reason"] = "far_field"
            return decision

        act_id = int(top_k_sampling(
            out["act_logits"][:, -1:, :], self.cfg.temperature,
            self.cfg.top_k, generator=self.generator)[0, 0])

        self.last_trigger_time = now
        decision.update({
            "triggered": True,
            "target_bbox": [float(v) for v in box],
            "target_obj_score": float(obj_scores[target]),
            "action_id": act_id,
        })
        if self.catalog and act_id < len(self.catalog):
            a = self.catalog[act_id]
            decision.update({"action": a.act, "expression": a.exp,
                             "utterance": a.utterance,
                             "movement": a.movement})
        return decision

    def to_json(self, decision: dict) -> str:
        return json.dumps(decision)
