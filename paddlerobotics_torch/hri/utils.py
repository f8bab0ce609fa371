"""HRI perception utilities (port of the JAX package's ``hri/utils.py``):
the sin bbox position embedding, letterbox preprocessing, box helpers and
cosine similarity; plus ``crop_resize``, the tracking preprocessor's person
crops as one batched gather.

Resizing runs on the tensor's device: bilinear with half-pixel centres and
no antialiasing, the sampling of ``F.interpolate(mode="bilinear",
align_corners=False)`` and of ``cv2.resize``'s ``INTER_LINEAR``, as two
separable gather-and-blend passes. The source coordinates and weights are
computed in float64 and the blend in float32: ``F.interpolate`` takes its
coordinates in float32, which at 640 → 416 moves a weight by ~4e-5, where
these agree with ``cv2.resize`` on float32 to ~1e-7. There is no other
branch: the JAX ``letterbox_image`` samples nearest neighbours when ``cv2``
fails to import, the port never.
"""

from __future__ import annotations

import math

import numpy as np
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


def letterbox_params(im_h: int, im_w: int, target: int = 416):
    """Scale and offsets of an aspect-preserving letterbox: (scale, new_h,
    new_w, top, left)."""
    scale = min(target / im_h, target / im_w)
    new_h, new_w = int(im_h * scale), int(im_w * scale)
    top = (target - new_h) // 2
    left = (target - new_w) // 2
    return scale, new_h, new_w, top, left


def _bilinear_axis(n_in: torch.Tensor, n_out: int, start: torch.Tensor):
    """Source taps and weights of ``n_out`` half-pixel-centred samples over
    each of the inputs of length ``n_in`` (K,) starting at ``start`` (K,):
    → (first tap, second tap, first weight, second weight), each (K,n_out);
    coordinates in float64, weights cast to float32."""
    d = torch.arange(n_out, dtype=torch.float64, device=n_in.device)
    scale = n_in.to(torch.float64)[:, None] / n_out
    src = torch.clamp((d + 0.5) * scale - 0.5, min=0.0)
    i0 = torch.minimum(src.floor().to(torch.int64), n_in[:, None] - 1)
    i1 = torch.minimum(i0 + 1, n_in[:, None] - 1)
    lam = src - i0.to(torch.float64)
    return (start[:, None] + i0, start[:, None] + i1,
            (1.0 - lam).to(torch.float32), lam.to(torch.float32))


def _blend(img: torch.Tensor, ya, yb, wya, wyb, xa, xb, wxa, wxb):
    """img (H,W,C); taps and weights (K,out_h) and (K,out_w) →
    (K,out_h,out_w,C): the horizontal pass, then the vertical one."""
    H, W, C = img.shape
    rows = torch.stack([ya, yb], dim=1)                     # (K,2,out_h)
    flat = img.reshape(H * W, C)

    def gather(xx):
        idx = rows[:, :, :, None] * W + xx[:, None, None, :]
        return flat[idx.reshape(-1)].reshape(*idx.shape, C)

    wxa, wxb = wxa[:, None, None, :, None], wxb[:, None, None, :, None]
    h = wxa * gather(xa) + wxb * gather(xb)                 # (K,2,out_h,out_w,C)
    return (wya[:, :, None, None] * h[:, 0] + wyb[:, :, None, None] * h[:, 1])


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H,W,C) float → (out_h,out_w,C), bilinear, half-pixel centres."""
    H, W = img.shape[:2]
    one = lambda n: torch.tensor([n], device=img.device)
    zero = torch.zeros(1, dtype=torch.int64, device=img.device)
    y = _bilinear_axis(one(H), out_h, zero)
    x = _bilinear_axis(one(W), out_w, zero)
    return _blend(img, *y, *x)[0]


def letterbox_image(img: torch.Tensor, target: int = 416,
                    pad_value: float = 0.5) -> torch.Tensor:
    """(H,W,C) float image in [0,1] → (target,target,C) letterboxed, on the
    image's device."""
    im_h, im_w = img.shape[:2]
    _, new_h, new_w, top, left = letterbox_params(im_h, im_w, target)
    out = torch.full((target, target) + tuple(img.shape[2:]), pad_value,
                     dtype=img.dtype, device=img.device)
    out[top:top + new_h, left:left + new_w] = resize_bilinear(img, new_h,
                                                              new_w)
    return out


def unletterbox_boxes(boxes: np.ndarray, im_h: int, im_w: int,
                      target: int = 416) -> np.ndarray:
    """Map xyxy boxes from letterbox space back to original image coords
    (host-side, float64)."""
    scale, _, _, top, left = letterbox_params(im_h, im_w, target)
    out = np.asarray(boxes).copy().astype(np.float64)
    out[..., [0, 2]] = (out[..., [0, 2]] - left) / scale
    out[..., [1, 3]] = (out[..., [1, 3]] - top) / scale
    out[..., [0, 2]] = out[..., [0, 2]].clip(0, im_w - 1)
    out[..., [1, 3]] = out[..., [1, 3]].clip(0, im_h - 1)
    return out


def expand_boxes(boxes: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale boxes about their centers."""
    x_c = (boxes[..., 0] + boxes[..., 2]) * 0.5
    y_c = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w_half = (boxes[..., 2] - boxes[..., 0]) * 0.5 * scale
    h_half = (boxes[..., 3] - boxes[..., 1]) * 0.5 * scale
    return torch.stack([x_c - w_half, y_c - h_half,
                        x_c + w_half, y_c + h_half], dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, a (N,4) × b (M,4) xyxy → (N,M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def cosine_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return l2_normalize(a) @ l2_normalize(b).T


def crop_resize(frame: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                out_h: int, out_w: int) -> torch.Tensor:
    """Person crops of one frame, each resized to (out_h, out_w), batched.

    frame (H,W,C) float; boxes (K,4) xyxy in frame pixels; valid (K,) bool.
    A crop is the patch ``frame[y0:max(y1, y0+1), x0:max(x1, x0+1)]`` with
    each corner truncated after clamping at 0 and the slice cut at the
    frame's edge (the JAX tracking preprocessor's crop), resized as
    ``resize_bilinear`` resizes it; an invalid box or an empty patch gives
    zeros. → (K,out_h,out_w,C), no host synchronisation."""
    H, W, _ = frame.shape
    c = torch.clamp(boxes, min=0).floor().to(torch.int64)
    x0 = torch.clamp(c[:, 0], max=W)
    y0 = torch.clamp(c[:, 1], max=H)
    x1 = torch.clamp(torch.maximum(c[:, 2], c[:, 0] + 1), max=W)
    y1 = torch.clamp(torch.maximum(c[:, 3], c[:, 1] + 1), max=H)
    pw, ph = x1 - x0, y1 - y0
    ok = valid & (pw > 0) & (ph > 0)
    # an empty patch may start at the frame's edge: its taps stay inside
    out = _blend(frame, *_bilinear_axis(torch.clamp(ph, min=1), out_h,
                                        torch.clamp(y0, max=H - 1)),
                 *_bilinear_axis(torch.clamp(pw, min=1), out_w,
                                 torch.clamp(x0, max=W - 1)))
    return out * ok[:, None, None, None].to(out.dtype)
