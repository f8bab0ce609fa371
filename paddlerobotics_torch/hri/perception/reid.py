"""Re-ID appearance encoder for Deep-SORT (port of ``MarsSmall128`` from
the JAX package's ``hri/perception/reid.py``): conv → 6 residual blocks →
dense 128 → BatchNorm → L2 norm, unit 128-d features of 128×64 person
crops.

``forward`` takes NHWC crops, the JAX layout, and runs NCHW inside. Where
flax differs from PyTorch's habits the port follows flax:

- convolutions are SAME: 3×3 at stride 2 on an even input pads (0, 1)
  (``backbones.same_pad``), and the max pool pads (0, 1) with −inf;
- the flatten before ``Dense_0`` runs in NHWC order (h, w, c), so the NCHW
  activations are permuted first;
- BatchNorm eps 1e-5 (flax's default), the L2 norm divides by
  ``max(‖h‖, 1e-9)``.

Submodules carry the flax scope names for ``convert.reid_from_flax``.
The frozen-graph import (``import_tf_consts``) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.perception.backbones import same_pad
from paddlerobotics_torch.hri.perception.darknet import _same_pool_pad
from paddlerobotics_torch.hri.utils import l2_normalize
from paddlerobotics_torch.utils.init import flax_default_

CROP_HW = (128, 64)


class _SameConv(nn.Conv2d):
    """flax ``nn.Conv`` with ``padding="SAME"`` and a bias."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        return super().forward(same_pad(x, k, s))


class _Residual(nn.Module):
    def __init__(self, cin: int, features: int, down: bool = False,
                 device=None):
        super().__init__()
        s = 2 if down else 1
        self.BatchNorm_0 = nn.BatchNorm2d(cin, eps=1e-5, device=device)
        self.Conv_0 = _SameConv(cin, features, 3, s, device=device)
        self.BatchNorm_1 = nn.BatchNorm2d(features, eps=1e-5, device=device)
        self.Conv_1 = _SameConv(features, features, 3, device=device)
        self.project = cin != features or down
        if self.project:
            self.Conv_2 = _SameConv(cin, features, 1, s, device=device)

    def forward(self, x):
        h = self.Conv_0(F.elu(self.BatchNorm_0(x)))
        h = self.Conv_1(F.elu(self.BatchNorm_1(h)))
        if self.project:
            x = self.Conv_2(x)
        return x + h


class MarsSmall128(nn.Module):
    """(B,128,64,3) crops in [0,1] → (B,128) unit features; on the card
    unless ``device`` says otherwise; ``generator`` draws flax-default
    weights."""

    def __init__(self, feature_dim: int = 128, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv_0 = _SameConv(3, 32, 3, device=device)
        self.BatchNorm_0 = nn.BatchNorm2d(32, eps=1e-5, device=device)
        self.Conv_1 = _SameConv(32, 32, 3, device=device)
        self.BatchNorm_1 = nn.BatchNorm2d(32, eps=1e-5, device=device)
        blocks = ((32, 32, False), (32, 32, False), (32, 64, True),
                  (64, 64, False), (64, 128, True), (128, 128, False))
        for i, (ci, f, down) in enumerate(blocks):
            setattr(self, f"_Residual_{i}", _Residual(ci, f, down, device))
        h, w = CROP_HW[0] // 8, CROP_HW[1] // 8
        self.Dense_0 = nn.Linear(128 * h * w, feature_dim, device=device)
        self.BatchNorm_2 = nn.BatchNorm1d(feature_dim, eps=1e-5,
                                          device=device)
        self.eval()
        self.requires_grad_(False)
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, x):
        h = F.elu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        h = F.elu(self.BatchNorm_1(self.Conv_1(h)))
        h = F.max_pool2d(_same_pool_pad(h, 3, 2), 3, 2)
        for i in range(6):
            h = getattr(self, f"_Residual_{i}")(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return l2_normalize(self.BatchNorm_2(self.Dense_0(h)))
