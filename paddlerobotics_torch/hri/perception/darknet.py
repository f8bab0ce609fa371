"""Darknet cfg interpreter and ``.weights`` importer (port of the JAX
package's ``hri/perception/darknet.py``).

``parse_cfg`` reads a ``.cfg``; ``DarknetNet`` builds the network from its
sections in declaration order ([convolutional], [route], [shortcut],
[maxpool], [upsample], [yolo]); ``load_darknet_weights`` streams a
``.weights`` blob into it in the order darknet writes it (per conv, with
batch_normalize: bias β, scale γ, running mean, running variance, then the
kernel OIHW; without: bias, then the kernel). OIHW is ``nn.Conv2d``'s own
layout, so kernels load without a transpose. Where darknet differs from
flax's and PyTorch's habits the port follows darknet, as the JAX package
does:

- a convolution pads symmetrically, ``size // 2`` with ``pad=1``, also at
  stride 2 (not flax's SAME);
- ``maxpool`` is flax's SAME with −inf padding, which can be (0, 1);
- ``upsample`` repeats each pixel ``stride`` times;
- ``route`` concatenates and then keeps channel group ``group_id`` of
  ``groups``;
- BatchNorm eps 1e-5, leaky ReLU slope 0.1.

Modules are named ``conv{i}`` / ``bn{i}`` by section index, the flax
names, so ``convert.darknet_from_flax`` carries a flax tree across by path.
"""

from __future__ import annotations

import io
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.hri.perception.backbones import mish, same_pool_pad


def parse_cfg(text: str) -> Tuple[Tuple[str, Tuple[Tuple[str, str], ...]],
                                  ...]:
    """Darknet .cfg text → ((section_type, ((key, value), ...)), ...); the
    [net] section is kept (index 0) but produces no layer."""
    sections: List[Tuple[str, Tuple[Tuple[str, str], ...]]] = []
    cur_type, cur_opts = None, []
    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            if cur_type is not None:
                sections.append((cur_type, tuple(cur_opts)))
            cur_type, cur_opts = line.strip("[]").strip(), []
        elif "=" in line and cur_type is not None:
            k, v = line.split("=", 1)
            cur_opts.append((k.strip(), v.strip()))
    if cur_type is not None:
        sections.append((cur_type, tuple(cur_opts)))
    return tuple(sections)


def _get(opts, key, default=None):
    for k, v in opts:
        if k == key:
            return v
    return default


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.replace(" ", "").split(",") if x != ""]


class DarknetNet(nn.Module):
    """The network of parsed cfg sections. ``forward`` takes NCHW and
    returns (yolo_outputs, layer_outputs), both NCHW: the raw head tensors
    in cfg order and every section's output ([net]'s is the input).
    ``channels[i]`` is section i's output channel count."""

    def __init__(self, sections, device=None):
        super().__init__()
        self.sections = sections
        chans: List[int] = []
        c = 3                            # RGB input
        for li, (ltype, opt) in enumerate(sections):
            if ltype == "convolutional":
                bn = _get(opt, "batch_normalize", "0") == "1"
                filters = int(_get(opt, "filters"))
                size = int(_get(opt, "size", "1"))
                stride = int(_get(opt, "stride", "1"))
                pad = size // 2 if _get(opt, "pad", "0") == "1" else \
                    int(_get(opt, "padding", "0"))
                setattr(self, f"conv{li}", nn.Conv2d(
                    c, filters, size, stride, padding=pad, bias=not bn,
                    device=device))
                if bn:
                    setattr(self, f"bn{li}", nn.BatchNorm2d(
                        filters, eps=1e-5, momentum=0.01, device=device))
                c = filters
            elif ltype == "route":
                srcs = [chans[i if i >= 0 else li + i]
                        for i in _ints(_get(opt, "layers"))]
                c = sum(srcs) // int(_get(opt, "groups", "1"))
            elif ltype in ("yolo", "shortcut", "maxpool", "upsample",
                           "net", "network"):
                pass                     # channels unchanged
            else:
                raise ValueError(f"unsupported darknet section [{ltype}]")
            chans.append(c)
        self.channels = chans

    def forward(self, x):
        outs: List[torch.Tensor] = []
        yolo_outs: List[torch.Tensor] = []
        h = x
        for li, (ltype, opt) in enumerate(self.sections):
            if ltype == "convolutional":
                h = getattr(self, f"conv{li}")(h)
                if _get(opt, "batch_normalize", "0") == "1":
                    h = getattr(self, f"bn{li}")(h)
                act = _get(opt, "activation", "linear")
                if act == "leaky":
                    h = F.leaky_relu(h, 0.1)
                elif act == "mish":
                    h = mish(h)
                elif act == "relu":
                    h = F.relu(h)
            elif ltype == "route":
                srcs = [outs[i if i >= 0 else li + i]
                        for i in _ints(_get(opt, "layers"))]
                h = torch.cat(srcs, dim=1) if len(srcs) > 1 else srcs[0]
                groups = int(_get(opt, "groups", "1"))
                if groups > 1:
                    gid = int(_get(opt, "group_id", "0"))
                    c = h.shape[1] // groups
                    h = h[:, gid * c:(gid + 1) * c]
            elif ltype == "shortcut":
                frm = int(_get(opt, "from"))
                h = outs[-1] + outs[frm if frm >= 0 else li + frm]
                if _get(opt, "activation", "linear") == "leaky":
                    h = F.leaky_relu(h, 0.1)
            elif ltype == "maxpool":
                size = int(_get(opt, "size", "2"))
                stride = int(_get(opt, "stride", str(size)))
                h = F.max_pool2d(same_pool_pad(h, size, stride), size,
                                 stride)
            elif ltype == "upsample":
                s = int(_get(opt, "stride", "2"))
                h = F.interpolate(h, scale_factor=s, mode="nearest")
            elif ltype == "yolo":
                yolo_outs.append(outs[-1])
                h = outs[-1]
            outs.append(h)
        return yolo_outs, outs


def yolo_meta(sections) -> List[dict]:
    """Per-[yolo]-head decode metadata: anchors (masked), classes,
    scale_x_y."""
    metas = []
    for ltype, opt in sections:
        if ltype != "yolo":
            continue
        anchors = _ints(_get(opt, "anchors"))
        anchors = [(anchors[2 * i], anchors[2 * i + 1])
                   for i in range(len(anchors) // 2)]
        mask = _ints(_get(opt, "mask"))
        metas.append({
            "anchors": tuple(anchors[m] for m in mask),
            "classes": int(_get(opt, "classes", "80")),
            "scale_xy": float(_get(opt, "scale_x_y", "1.0")),
        })
    return metas


def _conv_layers(sections):
    for li, (ltype, opt) in enumerate(sections):
        if ltype == "convolutional":
            yield li, _get(opt, "batch_normalize", "0") == "1"


def _blob(weights) -> bytes:
    if isinstance(weights, bytes):
        return weights
    if isinstance(weights, str):
        with open(weights, "rb") as f:
            return f.read()
    return weights.read()


def load_darknet_weights(net: DarknetNet, sections, weights) -> DarknetNet:
    """Fill ``net`` in place from darknet ``.weights`` (bytes, a path or a
    file). The header is three int32 (major, minor, revision) and ``seen``:
    int64 where major·10 + minor ≥ 2, else int32. Raises where the blob's
    float count differs from the cfg's."""
    buf = io.BytesIO(_blob(weights))
    major, minor, _rev = np.frombuffer(buf.read(12), np.int32)
    buf.read(8 if major * 10 + minor >= 2 else 4)          # seen
    floats = np.frombuffer(buf.read(), np.float32)
    pos = 0

    def take(t: torch.Tensor):
        nonlocal pos
        n = t.numel()
        out = floats[pos:pos + n]
        if out.size != n:
            raise ValueError("weights file too short")
        pos += n
        with torch.no_grad():
            t.copy_(torch.from_numpy(out.copy()).reshape(t.shape))

    for li, has_bn in _conv_layers(sections):
        conv = getattr(net, f"conv{li}")
        if has_bn:
            bn = getattr(net, f"bn{li}")
            for t in (bn.bias, bn.weight, bn.running_mean, bn.running_var):
                take(t)
        else:
            take(conv.bias)
        take(conv.weight)
    if pos != floats.size:
        raise ValueError(
            f"weights file has {floats.size} floats, consumed {pos} — "
            "cfg/weights mismatch")
    return net


def save_darknet_weights(net: DarknetNet, sections) -> bytes:
    """Inverse of ``load_darknet_weights``: header version 0.2.0 (int64
    ``seen`` = 0), then each conv's floats in darknet's order."""
    out = io.BytesIO()
    out.write(np.asarray([0, 2, 0], np.int32).tobytes())
    out.write(np.asarray([0], np.int64).tobytes())
    np_ = lambda t: t.detach().cpu().numpy().astype(np.float32).tobytes()
    for li, has_bn in _conv_layers(sections):
        conv = getattr(net, f"conv{li}")
        if has_bn:
            bn = getattr(net, f"bn{li}")
            for t in (bn.bias, bn.weight, bn.running_mean, bn.running_var):
                out.write(np_(t))
        else:
            out.write(np_(conv.bias))
        out.write(np_(conv.weight))
    return out.getvalue()

