"""The CSPDarknet53 trunk of YOLOv4 and the Darknet53 trunk of YOLOv3 (port
of the JAX package's ``hri/perception/backbones.py``: ``mish``, ``ConvBN``,
``DarkResBlock``, ``CSPStage``, ``CSPDarknet53``, ``Darknet53``).

Activations are NCHW inside the port's modules. Submodules carry the flax
scope names (``ConvBN_0``, ``Conv_0``, ``BatchNorm_0``, ``CSPStage_2`` …),
so ``convert.load_flax`` carries weights and batch statistics across by
path. Where flax differs from PyTorch's habits the port follows flax:

- ``padding="SAME"``: flax pads (lo, hi) = (total // 2, total − total // 2)
  with total = max((⌈n/s⌉ − 1)·s + k − n, 0), which for k=3, s=2 on an even
  input is (0, 1), not the (1, 1) of ``nn.Conv2d(padding=1)``. ``same_pad``
  computes flax's padding from the input's size;
- BatchNorm eps 1e-3, on running statistics (inference);
- leaky ReLU slope 0.1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def mish(x):
    return x * torch.tanh(F.softplus(x))


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad the last two dims of x as flax's ``padding="SAME"`` does."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvBN(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, act: str = "leaky", device=None):
        super().__init__()
        self.kernel, self.stride, self.act = kernel, stride, act
        # stride 1, odd k: SAME is symmetric and the conv pads itself
        self.pad_in_conv = stride == 1 and kernel % 2 == 1
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride,
                                padding=kernel // 2 if self.pad_in_conv else 0,
                                bias=False, device=device)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-3, momentum=0.03,
                                          device=device)

    def forward(self, x):
        if not self.pad_in_conv:
            x = same_pad(x, self.kernel, self.stride)
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.act == "leaky":
            x = F.leaky_relu(x, 0.1)
        elif self.act == "mish":
            x = mish(x)
        return x


class DarkResBlock(nn.Module):
    def __init__(self, features: int, device=None):
        super().__init__()
        self.ConvBN_0 = ConvBN(features, features, 1, act="mish", device=device)
        self.ConvBN_1 = ConvBN(features, features, 3, act="mish", device=device)

    def forward(self, x):
        return x + self.ConvBN_1(self.ConvBN_0(x))


class CSPStage(nn.Module):
    def __init__(self, cin: int, features: int, blocks: int,
                 first: bool = False, device=None):
        super().__init__()
        split = features if first else features // 2
        self.blocks = blocks
        self.ConvBN_0 = ConvBN(cin, features, 3, 2, "mish", device)
        self.ConvBN_1 = ConvBN(features, split, 1, act="mish", device=device)
        self.ConvBN_2 = ConvBN(features, split, 1, act="mish", device=device)
        for i in range(blocks):
            setattr(self, f"DarkResBlock_{i}", DarkResBlock(split, device))
        self.ConvBN_3 = ConvBN(split, split, 1, act="mish", device=device)
        self.ConvBN_4 = ConvBN(2 * split, features, 1, act="mish",
                               device=device)

    def forward(self, x):
        h = self.ConvBN_0(x)
        route = self.ConvBN_1(h)
        h = self.ConvBN_2(h)
        for i in range(self.blocks):
            h = getattr(self, f"DarkResBlock_{i}")(h)
        h = self.ConvBN_3(h)
        return self.ConvBN_4(torch.cat([h, route], dim=1))


class CSPDarknet53(nn.Module):
    """YOLOv4 trunk; returns (C3 /8, C4 /16, C5 /32)."""

    def __init__(self, device=None):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, 3, act="mish", device=device)
        stages = ((32, 64, 1, True), (64, 128, 2, False), (128, 256, 8, False),
                  (256, 512, 8, False), (512, 1024, 4, False))
        for i, (cin, f, n, first) in enumerate(stages):
            setattr(self, f"CSPStage_{i}", CSPStage(cin, f, n, first, device))

    def forward(self, x):
        h = self.CSPStage_1(self.CSPStage_0(self.ConvBN_0(x)))
        c3 = self.CSPStage_2(h)
        c4 = self.CSPStage_3(c3)
        c5 = self.CSPStage_4(c4)
        return c3, c4, c5


class Darknet53(nn.Module):
    """YOLOv3 trunk (leaky-ReLU residual stages); returns (C3 /8, C4 /16,
    C5 /32). flax builds its stages inline, so the ConvBNs are numbered
    ``ConvBN_0..ConvBN_51`` in the order they run: the stem, then per stage
    the stride-2 conv and a 1×1 / 3×3 pair per residual."""

    STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))

    def __init__(self, device=None):
        super().__init__()
        specs = [(3, 32, 3, 1)]
        cin = 32
        for feats, n in self.STAGES:
            specs.append((cin, feats, 3, 2))
            specs += [(feats, feats // 2, 1, 1), (feats // 2, feats, 3, 1)] * n
            cin = feats
        for i, (ci, f, k, s) in enumerate(specs):
            setattr(self, f"ConvBN_{i}", ConvBN(ci, f, k, s, device=device))

    def forward(self, x):
        cb = lambda i, h: getattr(self, f"ConvBN_{i}")(h)
        h = cb(0, x)
        i, feats = 1, []
        for _, n in self.STAGES:
            h = cb(i, h)
            i += 1
            for _ in range(n):
                h = h + cb(i + 1, cb(i, h))
                i += 2
            feats.append(h)
        return feats[2], feats[3], feats[4]
