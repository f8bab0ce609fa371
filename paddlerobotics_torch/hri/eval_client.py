"""Offline evaluation: batch-of-windows scoring and threshold sweeps (port
of the JAX package's ``hri/eval_client.py``). The windows go through the
service's controller as one batch on its device, through the attention
kernel as the service's own calls do."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


class OfflineEvaluator:
    def __init__(self, service):
        """service: ProactiveGreetingService (reuses its controller call)."""
        self.svc = service

    def score_windows(self, token_windows: np.ndarray,
                      valid_windows: np.ndarray) -> np.ndarray:
        """token_windows (N, F, K, 562) → trigger score per window (N,)."""
        N, F, K, D = token_windows.shape
        dev = self.svc.device
        tokens = torch.as_tensor(np.asarray(token_windows, np.float32),
                                 device=dev).reshape(N, F * K, D)
        valid = torch.as_tensor(np.asarray(valid_windows),
                                device=dev).reshape(N, F * K).to(torch.float32)
        frame_ids = torch.arange(1, F + 1, device=dev).repeat_interleave(
            K)[None].expand(N, -1)
        out = self.svc._attend(tokens, frame_ids, valid)
        return torch.sigmoid(out["trigger_logits"][:, -1]).cpu().numpy()

    def sweep_thresholds(self, scores: np.ndarray, labels: np.ndarray,
                         thresholds: Sequence[float] = tuple(
                             np.arange(0.5, 0.96, 0.05))
                         ) -> List[Dict[str, float]]:
        """Precision/recall per threshold."""
        rows = []
        for th in thresholds:
            pred = scores >= th
            tp = float(np.sum(pred & (labels > 0.5)))
            fp = float(np.sum(pred & (labels <= 0.5)))
            fn = float(np.sum(~pred & (labels > 0.5)))
            prec = tp / max(tp + fp, 1e-9)
            rec = tp / max(tp + fn, 1e-9)
            rows.append({"threshold": round(float(th), 3),
                         "precision": prec, "recall": rec,
                         "f1": 2 * prec * rec / max(prec + rec, 1e-9)})
        return rows
