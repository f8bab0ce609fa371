"""RoIAlign by bilinear gathers (port of the JAX package's
``hri/perception/roi_align.py``), batched over the RoIs of one image."""

from __future__ import annotations

import torch


def roi_align(fm: torch.Tensor, rois: torch.Tensor, output_size: int = 5,
              spatial_scale: float = 1.0 / 32.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """fm (H,W,C); rois (R,4) xyxy in input-image coords →
    (R, output_size, output_size, C): the mean of sampling_ratio² bilinear
    samples per output bin."""
    R = rois.shape[0]
    C = fm.shape[-1]
    r = rois * spatial_scale
    x0, y0, x1, y1 = r.unbind(-1)
    rw = torch.clamp(x1 - x0, min=1.0)[:, None]
    rh = torch.clamp(y1 - y0, min=1.0)[:, None]
    n = output_size * sampling_ratio
    g = torch.arange(n, device=fm.device) + 0.5
    xs = x0[:, None] + g * rw / n
    ys = y0[:, None] + g * rh / n
    vals = _bilinear(fm, ys, xs)                       # (R, n, n, C)
    vals = vals.reshape(R, output_size, sampling_ratio, output_size,
                        sampling_ratio, C)
    return vals.mean(dim=(2, 4))


def _bilinear(fm: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Sample fm (H,W,C) at each RoI's grid ys × xs, ys and xs (R,n) →
    (R, n, n, C)."""
    H, W, _ = fm.shape
    y = torch.clamp(ys, 0.0, H - 1.0)
    x = torch.clamp(xs, 0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (y - y0)[:, :, None, None]
    wx = (x - x0)[:, None, :, None]

    def at(yi, xi):
        return fm[yi[:, :, None], xi[:, None, :]]

    f00, f01 = at(y0, x0), at(y0, x1)
    f10, f11 = at(y1, x0), at(y1, x1)
    return (f00 * (1 - wy) * (1 - wx) + f01 * (1 - wy) * wx +
            f10 * wy * (1 - wx) + f11 * wy * wx)
