"""Random initialisation from an explicit generator, after flax's defaults.

Dense and Conv kernels are drawn normal with variance 1/fan_in (flax's
lecun-normal, without its truncation), biases are zero; norm layers keep
PyTorch's defaults (scale 1, bias 0, running mean 0 and variance 1), which
are flax's too. A generator on the card draws on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def randn(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def flax_default_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear / Conv2d / Conv3d weight of ``module`` in module
    order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(randn(m.weight.shape, generator)
                               * (1.0 / math.sqrt(fan_in)))
                if m.bias is not None:
                    m.bias.zero_()
