"""HRI perception utilities (port of ``get_bbox_pos_emb`` from the JAX
package's ``hri/utils.py``)."""

from __future__ import annotations

import math

import torch


def get_bbox_pos_emb(bbox: torch.Tensor, im_h: float, im_w: float,
                     emb_h: int = 5, emb_w: int = 5) -> torch.Tensor:
    """Sin positional embedding of bbox(es) relative to the image center.

    bbox (...,4) xyxy → (...,2,emb_h,emb_w); flattened, 2·h·w = 50 dims."""
    xmin, ymin, xmax, ymax = bbox.unbind(-1)
    sx = lambda v: (v - im_w / 2.0) / (im_w / 2.0) * (math.pi / 2.0)
    sy = lambda v: (v - im_h / 2.0) / (im_h / 2.0) * (math.pi / 2.0)
    xmin, xmax = sx(xmin), sx(xmax)
    ymin, ymax = sy(ymin), sy(ymax)
    tx = torch.linspace(0.0, 1.0, emb_w, device=bbox.device)
    ty = torch.linspace(0.0, 1.0, emb_h, device=bbox.device)
    x_pos = torch.sin(xmin[..., None] + (xmax - xmin)[..., None] * tx)
    y_pos = torch.sin(ymin[..., None] + (ymax - ymin)[..., None] * ty)
    x_emb = x_pos[..., None, :].expand(*x_pos.shape[:-1], emb_h, emb_w)
    y_emb = y_pos[..., :, None].expand(*y_pos.shape[:-1], emb_h, emb_w)
    return torch.stack([x_emb, y_emb], dim=-3)
