"""Backbones of HRI perception (port of the JAX package's
``hri/perception/backbones.py``): the CSPDarknet53 trunk of YOLOv4, the
Darknet53 trunk of YOLOv3, MobileNetV2 (``InvertedResidual``; the crop
features of the ``inst_crop`` controller) and a ResNet-50-style trunk
(``BottleneckBlock``).

Activations are NCHW inside the port's modules. Submodules carry the flax
scope names (``ConvBN_0``, ``Conv_0``, ``BatchNorm_0``, ``CSPStage_2`` …),
so ``convert.load_flax`` carries weights and batch statistics across by
path. Where flax differs from PyTorch's habits the port follows flax:

- ``padding="SAME"``: flax pads (lo, hi) = (total // 2, total − total // 2)
  with total = max((⌈n/s⌉ − 1)·s + k − n, 0), which for k=3, s=2 on an even
  input is (0, 1), not the (1, 1) of ``nn.Conv2d(padding=1)``. ``same_pad``
  computes flax's padding from the input's size;
- BatchNorm eps 1e-3, on running statistics (inference);
- leaky ReLU slope 0.1;
- a SAME max pool pads with −inf (ResNet's stem).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.utils.init import flax_default_


def mish(x):
    return x * torch.tanh(F.softplus(x))


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad the last two dims of x as flax's ``padding="SAME"`` does."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def same_pool_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's SAME padding of a max pool: −inf, (total//2, total − total//2)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=float("-inf"))


class ConvBN(nn.Module):
    """SAME conv without bias, BatchNorm, then ``act``: leaky, mish, relu6
    or none."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, act: str = "leaky", device=None,
                 groups: int = 1):
        super().__init__()
        self.kernel, self.stride, self.act = kernel, stride, act
        # stride 1, odd k: SAME is symmetric and the conv pads itself
        self.pad_in_conv = stride == 1 and kernel % 2 == 1
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride,
                                padding=kernel // 2 if self.pad_in_conv else 0,
                                groups=groups, bias=False, device=device)
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
        elif self.act == "relu6":
            x = torch.clamp(x, 0.0, 6.0)
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


class InvertedResidual(nn.Module):
    """MobileNetV2 block: 1×1 expand (unless ``expand`` is 1), 3×3
    depthwise, 1×1 project, and the residual when shapes allow."""

    def __init__(self, cin: int, features: int, stride: int, expand: int,
                 device=None):
        super().__init__()
        mid = cin * expand
        convs = []
        if expand != 1:
            convs.append(ConvBN(cin, mid, 1, act="relu6", device=device))
        convs.append(ConvBN(mid, mid, 3, stride, "relu6", device, groups=mid))
        convs.append(ConvBN(mid, features, 1, act="none", device=device))
        for i, c in enumerate(convs):
            setattr(self, f"ConvBN_{i}", c)
        self.n = len(convs)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = x
        for i in range(self.n):
            h = getattr(self, f"ConvBN_{i}")(h)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """MobileNetV2 trunk: (B,3,H,W) → global-average-pooled (B, 1280·width).
    On the card unless ``device`` says otherwise; ``generator`` draws
    flax-default weights."""

    CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, width: float = 1.0, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        cin = int(32 * width)
        self.ConvBN_0 = ConvBN(3, cin, 3, 2, "relu6", device)
        i = 0
        for t, c, n, s in self.CFG:
            for j in range(n):
                f = int(c * width)
                setattr(self, f"InvertedResidual_{i}", InvertedResidual(
                    cin, f, s if j == 0 else 1, t, device))
                cin, i = f, i + 1
        self.n_blocks = i
        self.ConvBN_1 = ConvBN(cin, int(1280 * width), 1, act="relu6",
                               device=device)
        self.eval()
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, x):
        h = self.ConvBN_0(x)
        for i in range(self.n_blocks):
            h = getattr(self, f"InvertedResidual_{i}")(h)
        return self.ConvBN_1(h).mean(dim=(2, 3))


class BottleneckBlock(nn.Module):
    """1×1, 3×3 (stride), 1×1 ×4 with relu6 between, projection shortcut
    when shapes differ, ReLU after the sum."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, 1, act="relu6", device=device)
        self.ConvBN_1 = ConvBN(features, features, 3, stride, "relu6",
                               device)
        self.ConvBN_2 = ConvBN(features, 4 * features, 1, act="none",
                               device=device)
        self.project = cin != 4 * features or stride != 1
        if self.project:
            self.ConvBN_3 = ConvBN(cin, 4 * features, 1, stride, "none",
                                   device)

    def forward(self, x):
        h = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        if self.project:
            x = self.ConvBN_3(x)
        return torch.relu(h + x)


class ResNet(nn.Module):
    """ResNet-50-style trunk: (B,3,H,W) → (C3, C4, C5). On the card unless
    ``device`` says otherwise; ``generator`` draws flax-default weights."""

    def __init__(self, depths=(3, 4, 6, 3), device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.ConvBN_0 = ConvBN(3, 64, 7, 2, "relu6", device)
        self.depths = tuple(depths)
        cin, b = 64, 0
        for i, d in enumerate(self.depths):
            for j in range(d):
                f = 64 * 2 ** i
                setattr(self, f"BottleneckBlock_{b}", BottleneckBlock(
                    cin, f, 2 if (j == 0 and i > 0) else 1, device))
                cin, b = 4 * f, b + 1
        self.eval()
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, x):
        h = self.ConvBN_0(x)
        h = F.max_pool2d(same_pool_pad(h, 3, 2), 3, 2)
        feats, b = [], 0
        for d in self.depths:
            for _ in range(d):
                h = getattr(self, f"BottleneckBlock_{b}")(h)
                b += 1
            feats.append(h)
        return feats[1], feats[2], feats[3]
