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
``import_tf_consts`` loads the consts of a frozen TF1 graph
(``tf_graph.parse_graph_consts`` on ``mars-small128.pb``);
``export_tf_consts`` writes the encoder's weights in that graph's order
under TF-slim's names, the fixture of its round trip.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.perception.backbones import (same_pad,
                                                           same_pool_pad)
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
        h = F.max_pool2d(same_pool_pad(h, 3, 2), 3, 2)
        for i in range(6):
            h = getattr(self, f"_Residual_{i}")(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return l2_normalize(self.BatchNorm_2(self.Dense_0(h)))


# (scope of the port's module, its TF-slim scope) in graph order: the stem's
# two convs, then each residual block's two (pre-activation BN first) and
# its projection; ``fc1`` and its BatchNorm last
_RES_SCOPES = ("conv2_1", "conv2_3", "conv3_1", "conv3_3", "conv4_1",
               "conv4_3")


def _layout(reid: "MarsSmall128"):
    """(kind, port module path, TF-slim scope) in graph order; kind is
    conv, bn, fc."""
    out = [("conv", "Conv_0", "conv1_1"), ("bn", "BatchNorm_0", "conv1_1"),
           ("conv", "Conv_1", "conv1_2"), ("bn", "BatchNorm_1", "conv1_2")]
    for i, scope in enumerate(_RES_SCOPES):
        r = f"_Residual_{i}"
        out += [("bn", f"{r}.BatchNorm_0", f"{scope}/1"),
                ("conv", f"{r}.Conv_0", f"{scope}/1"),
                ("bn", f"{r}.BatchNorm_1", f"{scope}/2"),
                ("conv", f"{r}.Conv_1", f"{scope}/2")]
        if getattr(reid, r).project:
            out.append(("conv", f"{r}.Conv_2", f"{scope}/projection"))
    return out + [("fc", "Dense_0", "fc1"), ("bn", "BatchNorm_2", "fc1")]


def export_tf_consts(reid: "MarsSmall128") -> List[Tuple[str, np.ndarray]]:
    """The encoder's weights as a frozen graph's consts, in graph order and
    TF layout: ``<scope>/weights`` kernels (HWIO; the fc (in, out)) and
    ``<scope>/BatchNorm/{gamma,beta,moving_mean,moving_variance}``. The
    graph has no conv or fc biases: nonzero ones raise."""
    out = []
    for kind, path, scope in _layout(reid):
        m = reid.get_submodule(path)
        host = lambda t: t.detach().cpu().numpy().astype(np.float32)
        if kind == "bn":
            out += [(f"{scope}/BatchNorm/gamma", host(m.weight)),
                    (f"{scope}/BatchNorm/beta", host(m.bias)),
                    (f"{scope}/BatchNorm/moving_mean", host(m.running_mean)),
                    (f"{scope}/BatchNorm/moving_variance",
                     host(m.running_var))]
            continue
        if bool(m.bias.detach().abs().max() > 0):
            raise ValueError(f"{path} has a bias; the frozen graph has none")
        w = host(m.weight)
        out.append((f"{scope}/weights", w.T if kind == "fc" else
                    np.ascontiguousarray(w.transpose(2, 3, 1, 0))))
    return out


def import_tf_consts(consts: Mapping[str, np.ndarray],
                     feature_dim: int = 128, device=None) -> "MarsSmall128":
    """Frozen-graph Const tensors → the port's ``MarsSmall128``, on the card
    unless ``device`` says otherwise.

    ``consts``: ordered {name: ndarray} as ``tf_graph.parse_graph_consts``
    returns them. The mapping is the JAX importer's, by graph order and
    shape: a 4-D const is the next conv kernel (TF HWIO → OIHW), the one
    2-D const the fc kernel ((in, out) → ``Linear``'s (out, in)); the 1-D
    consts after it that share one scope (the name before its last '/')
    are a BatchNorm group, assigned by suffix (gamma, beta, mean, var) or
    by position (3: beta, mean, var with gamma 1; 4: gamma, beta, mean,
    var). Conv and fc biases are zero. A shape that does not fit raises."""
    seq = [(name, np.asarray(v, np.float32)) for name, v in consts.items()
           if np.asarray(v).ndim in (1, 2, 4)]
    pos = 0

    def scope(name):
        return name.rsplit("/", 1)[0] if "/" in name else ""

    def take_kernel(shape):
        nonlocal pos
        if pos >= len(seq):
            raise ValueError(f"ran out of consts at kernel {shape}")
        name, k = seq[pos]
        if tuple(k.shape) != tuple(shape):
            raise ValueError(f"const {name!r} at position {pos} has shape "
                             f"{k.shape}, expected kernel {shape}")
        pos += 1
        return k

    def take_bn(width):
        nonlocal pos
        group, group_scope = [], None
        while pos < len(seq) and seq[pos][1].ndim == 1 and len(group) < 4:
            name, arr = seq[pos]
            if arr.shape[0] != width:
                break
            if group_scope is None:
                group_scope = scope(name)
            elif scope(name) != group_scope:
                break                          # the next BN's scope begins
            group.append((name, arr))
            pos += 1
        by_suffix = {}
        for name, arr in group:
            low = name.rsplit("/", 1)[-1].lower()
            for key, tag in (("scale", "gamma"), ("bias", "beta"),
                             ("mean", "mean"), ("var", "var")):
                if tag in low and key not in by_suffix:
                    by_suffix[key] = arr
                    break
        if len(by_suffix) == len(group) and len(group) in (3, 4):
            gamma = by_suffix.get("scale")
            beta, mean, var = (by_suffix.get(k) for k in
                               ("bias", "mean", "var"))
            if beta is None or mean is None or var is None:
                raise ValueError(
                    f"BatchNorm group {group_scope!r} missing "
                    f"beta/mean/var (have {sorted(by_suffix)})")
        elif len(group) == 3:                  # positional fallback
            gamma = None
            (_, beta), (_, mean), (_, var) = group
        elif len(group) == 4:
            (_, gamma), (_, beta), (_, mean), (_, var) = group
        else:
            raise ValueError(
                f"expected a BatchNorm group (3 or 4 1-D consts of len "
                f"{width}) in scope {group_scope!r} at position {pos}, "
                f"got {len(group)}")
        if gamma is None:
            gamma = np.ones(width, np.float32)
        return gamma, beta, mean, var

    reid = MarsSmall128(feature_dim, device=device)
    dev = next(reid.parameters()).device
    put = lambda t, a: t.copy_(torch.as_tensor(np.ascontiguousarray(a),
                                               device=dev))
    with torch.no_grad():
        for kind, path, _ in _layout(reid):
            m = reid.get_submodule(path)
            if kind == "bn":
                for t, a in zip((m.weight, m.bias, m.running_mean,
                                 m.running_var), take_bn(m.num_features)):
                    put(t, a)
                continue
            if kind == "fc":
                put(m.weight, take_kernel(m.weight.shape[::-1]).T)
            else:
                o, i, kh, kw = m.weight.shape
                put(m.weight, take_kernel((kh, kw, i, o)).transpose(
                    3, 2, 0, 1))
            m.bias.zero_()
    if pos != len(seq):
        raise ValueError(f"{len(seq) - pos} unconsumed consts (first: "
                         f"{seq[pos][0]!r} shape {seq[pos][1].shape})")
    return reid
