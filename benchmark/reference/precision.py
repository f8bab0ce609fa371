"""The control's precision: TF32, the step below the configurations'
float32 with TF32 off.

``tf32()`` rounds both matrix operands of every matrix product (``mm``,
``addmm``, ``bmm``, ``baddbmm``, forward and backward) to TF32's 10 bits of
mantissa, to nearest with ties away from zero as ``cvt.rna.tf32.f32`` does,
and multiplies them in float32, as the card's TF32 tensor-core path does. It
runs the same on the CPU, so the tests can hold the control too.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
_MATS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
         aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32).view(x.shape)


class tf32(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        idx = _MATS.get(func)
        if idx is not None:
            args = list(args)
            for i in idx:
                args[i] = round_tf32(args[i])
        return func(*args, **(kwargs or {}))
