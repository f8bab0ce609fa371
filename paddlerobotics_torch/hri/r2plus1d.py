"""R(2+1)D video action-recognition baseline (port of the JAX package's
``hri/r2plus1d.py``, the flax rebuild of torchvision's ``r2plus1d_18``).

The modules are laid out as torchvision's ``VideoResNet("r2plus1d_18")``,
so their ``state_dict`` keys are torchvision's (``stem.0.weight``,
``layer{L}.{i}.conv1.0.0.weight``, …, ``fc.bias``) and a torchvision
checkpoint loads with ``strict=True``. Input is (B,3,T,H,W), torchvision's
layout; the JAX model takes (B,T,H,W,3).

Where flax differs from PyTorch's habits the port follows flax:

- padding is explicit and symmetric, (0, k//2, k//2) spatially and 1
  temporally (the JAX module's choice, which is torchvision's);
- BatchNorm (``FlaxBatchNorm3d``): eps 1e-5, statistics ``mean(x)`` and
  ``mean(x²) − mean(x)²`` (biased), running averages with momentum 0.99
  on those biased statistics, and ``(x − μ)·(rsqrt(σ² + eps)·γ) + β``.

Blocks are grouped in twos into ``layer1``, ``layer2``, … whatever the
stage plan, so the CPU-sized plans of the tests keep torchvision's names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.utils.init import flax_default_

R2PLUS1D18_BLOCKS = ((64, (1, 1, 1)), (64, (1, 1, 1)),
                     (128, (2, 2, 2)), (128, (1, 1, 1)),
                     (256, (2, 2, 2)), (256, (1, 1, 1)),
                     (512, (2, 2, 2)), (512, (1, 1, 1)))
BN_EPS = 1e-5
BN_MOMENTUM = 0.99        # flax: running = 0.99·running + 0.01·batch


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d``'s parameters and buffers with flax's arithmetic."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=BN_EPS,
                         momentum=1.0 - BN_MOMENTUM, device=device)

    def forward(self, x):
        if self.training:
            dims = (0, 2, 3, 4)
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + \
            self.bias.reshape(shape)


def _mid_channels(in_ch: int, out_ch: int) -> int:
    return (3 * 3 * 3 * in_ch * out_ch) // (3 * 3 * in_ch + 3 * out_ch)


def Conv2Plus1D(cin: int, features: int, mid: int, stride=(1, 1, 1),
                spatial_kernel: int = 3, device=None) -> nn.Sequential:
    """3D conv factorised into a spatial (1,k,k) and a temporal (3,1,1)
    conv: torchvision's ``Conv2Plus1D`` (conv, BN, ReLU, conv)."""
    st, sh, sw = stride
    k = spatial_kernel
    return nn.Sequential(
        nn.Conv3d(cin, mid, (1, k, k), stride=(1, sh, sw),
                  padding=(0, k // 2, k // 2), bias=False, device=device),
        FlaxBatchNorm3d(mid, device=device),
        nn.ReLU(),
        nn.Conv3d(mid, features, (3, 1, 1), stride=(st, 1, 1),
                  padding=(1, 0, 0), bias=False, device=device))


class R2Plus1DBlock(nn.Module):
    """torchvision's ``BasicBlock`` with ``Conv2Plus1D``."""

    def __init__(self, cin: int, features: int, stride=(1, 1, 1),
                 device=None):
        super().__init__()
        stride = tuple(stride)
        self.conv1 = nn.Sequential(
            Conv2Plus1D(cin, features, _mid_channels(cin, features), stride,
                        device=device),
            FlaxBatchNorm3d(features, device=device), nn.ReLU())
        self.conv2 = nn.Sequential(
            Conv2Plus1D(features, features,
                        _mid_channels(features, features), device=device),
            FlaxBatchNorm3d(features, device=device))
        self.downsample = None
        if cin != features or stride != (1, 1, 1):
            self.downsample = nn.Sequential(
                nn.Conv3d(cin, features, 1, stride=stride, bias=False,
                          device=device),
                FlaxBatchNorm3d(features, device=device))

    def forward(self, x):
        h = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(h + x)


class R2Plus1D18(nn.Module):
    """18-layer R(2+1)D: (B,3,T,H,W) → class logits. ``blocks`` defaults to
    the r2plus1d_18 stage plan; ``stem_kernel`` 7 is torchvision's. On the
    card unless ``device`` says otherwise; ``generator`` draws flax-default
    weights."""

    def __init__(self, num_classes: int = 2, blocks=R2PLUS1D18_BLOCKS,
                 stem_kernel: int = 7, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.blocks = tuple((f, tuple(s)) for f, s in blocks)
        stem = Conv2Plus1D(3, 64, 45, (1, 2, 2), stem_kernel, device)
        self.stem = nn.Sequential(*stem, FlaxBatchNorm3d(64, device=device),
                                  nn.ReLU())
        cin = 64
        layers: list = []
        for i, (feats, stride) in enumerate(self.blocks):
            if i % 2 == 0:
                layers.append([])
            layers[-1].append(R2Plus1DBlock(cin, feats, stride, device))
            cin = feats
        for i, layer in enumerate(layers):
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.n_layers = len(layers)
        self.fc = nn.Linear(cin, num_classes, device=device)
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, x):
        h = self.stem(x)
        for i in range(self.n_layers):
            h = getattr(self, f"layer{i + 1}")(h)
        return self.fc(h.mean(dim=(2, 3, 4)))


def flax_names(blocks=R2PLUS1D18_BLOCKS) -> dict:
    """The port's (torchvision's) module name of each flax scope of the JAX
    ``R2Plus1D18`` with this stage plan, e.g. ``R2Plus1DBlock_2/
    Conv2Plus1D_0/Conv_0`` → ``layer2.0.conv1.0.0``."""
    def c2p1d(flax, torch_):
        return {f"{flax}/Conv_0": f"{torch_}.0",
                f"{flax}/BatchNorm_0": f"{torch_}.1",
                f"{flax}/Conv_1": f"{torch_}.3"}

    names = {**c2p1d("Conv2Plus1D_0", "stem"), "BatchNorm_0": "stem.4",
             "Dense_0": "fc"}
    cin = 64
    for b, (feats, stride) in enumerate(blocks):
        f, t = f"R2Plus1DBlock_{b}", f"layer{b // 2 + 1}.{b % 2}"
        names.update(c2p1d(f"{f}/Conv2Plus1D_0", f"{t}.conv1.0"))
        names.update(c2p1d(f"{f}/Conv2Plus1D_1", f"{t}.conv2.0"))
        names[f"{f}/BatchNorm_0"] = f"{t}.conv1.1"
        names[f"{f}/BatchNorm_1"] = f"{t}.conv2.1"
        if cin != feats or tuple(stride) != (1, 1, 1):
            names[f"{f}/Conv_0"] = f"{t}.downsample.0"
            names[f"{f}/BatchNorm_2"] = f"{t}.downsample.1"
        cin = feats
    return names
