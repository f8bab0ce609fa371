"""Metrics logging: JSONL and optional TensorBoard (an own copy of the JAX
package's ``train/metrics.py``).

A JSONL stream (always) and TensorBoard scalars through
``torch.utils.tensorboard`` when it imports. Scalar names mirror the
reference's (train/episode_reward, train/mean_<channel>, ES/sigma…) and the
JAX trainer's, so dashboards line up.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, outdir: str, use_tensorboard: bool = True):
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(outdir, "tb"))
        self._t0 = time.time()

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({
            "tag": tag, "value": float(value), "step": int(step),
            "t": round(time.time() - self._t0, 3)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_scalars(self, prefix: str, scalars: dict, step: int):
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}/{k}", v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """A logger that writes nothing: every rank but rank 0 of a mesh run."""

    def add_scalar(self, tag: str, value: float, step: int):
        pass

    def add_scalars(self, prefix: str, scalars: dict, step: int):
        pass

    def close(self):
        pass
