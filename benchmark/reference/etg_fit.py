"""Least-squares fit of the ETG linear readout onto control points.

Port of the JAX package's ``etg/fit.py`` (rebuild of ``Opt_with_points``,
ETGRL/train.py:59-110): the closed form of the proximal least squares,
solved through its 6×6 dual in float32 with ``torch.linalg.solve``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.config import ETGConfig
from benchmark.reference.device import resolve_device
from benchmark.reference import oscillator


def sample_times(cfg: ETGConfig) -> np.ndarray:
    """The six fit times (train.py:82): one mid-stance + five swing."""
    return np.array([0.5 * cfg.T + 0.1, 0.0, 0.05, 0.1, 0.15, 0.2])


def prior_points(cfg: ETGConfig) -> np.ndarray:
    """Default swing control points (x, z), shape (6, 2) (train.py:84-88)."""
    s, h, p = cfg.steplen, cfg.footheight, cfg.penetration
    return np.array([
        [0.0, -p],
        [-s, -p * 0.5],
        [-1.5 * s, 0.6 * h],
        [0.0, h],
        [1.5 * s, 0.6 * h],
        [s, -p * 0.5],
    ])


def basis_matrix(cfg: ETGConfig, device=None) -> torch.Tensor:
    """A = V(tₛ) stacked over the six sample times, (6, H), on
    ``resolve_device(device)``: the card unless the caller asks for the CPU."""
    t = torch.as_tensor(sample_times(cfg), dtype=torch.float32,
                        device=resolve_device(device))
    return oscillator.update(t, cfg)


def _solve(A: torch.Tensor, b: torch.Tensor, lamb: float,
           w0: torch.Tensor | None) -> torch.Tensor:
    """argmin λ‖x − w₀‖² + ‖Ax − b‖² via the dual (kernel) form:
    x = w₀ + Aᵀ (A Aᵀ + λI)⁻¹ (b − A w₀); with w₀ = None the regularizer
    is 1e-4·tr(K)/n and the result the minimum-norm interpolant."""
    n = A.shape[0]
    K = A @ A.T                                   # (6,6) Gram matrix
    reg = lamb if w0 is not None else 1e-4 * torch.trace(K) / n
    if w0 is None:
        resid = b
        base = torch.zeros(A.shape[1], dtype=A.dtype, device=A.device)
    else:
        resid = b - A @ w0
        base = w0
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    alpha = torch.linalg.solve(K + reg * eye, resid)
    return base + A.T @ alpha


def opt_with_points(cfg: ETGConfig,
                    points: torch.Tensor | None = None,
                    w0: torch.Tensor | None = None,
                    b0: torch.Tensor | None = None,
                    lamb: float = 0.5, device=None):
    """Fit readout (w, b) so that w·V(tₛ)+b passes through the control points.

    Returns (w (3,H) rows [x; 0; z], b (3,)) in float32 — the layout
    train.py:108-109 produces (y row zero) — on the device of ``points``,
    or without them on ``resolve_device(device)``."""
    if points is None:
        points = torch.as_tensor(prior_points(cfg), dtype=torch.float32,
                                 device=resolve_device(device))
    A = basis_matrix(cfg, device=points.device)
    if b0 is None:
        b = torch.mean(points, dim=0)            # (2,)
    else:
        b = torch.stack([b0[0], b0[-1]])
    pt = points - b
    w0x = None if w0 is None else w0[0]
    w0z = None if w0 is None else w0[-1]
    x = _solve(A, pt[:, 0], lamb, w0x)
    z = _solve(A, pt[:, 1], lamb, w0z)
    H = A.shape[-1]
    w = torch.stack([x, torch.zeros(H, device=A.device), z], dim=0)
    b3 = torch.stack([b[0], torch.zeros((), device=A.device), b[1]])
    return w, b3


def batched_opt_with_points(cfg: ETGConfig, points_batch, w0, b0,
                            lamb: float = 0.5, device=None):
    """``opt_with_points`` over a population of control-point sets at once
    (the JAX package vmaps it): one (6,6) system with P right-hand sides
    per coordinate.

    points_batch (P, 6, 2), w0 (3,H), b0 (3,) → (w (P,3,H), b (P,3)) on
    ``resolve_device(device)``: the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    pts, w0, b0 = f32(points_batch), f32(w0), f32(b0)
    A = basis_matrix(cfg, device=device)
    b = torch.stack([b0[0], b0[-1]])
    pt = pts - b                                  # (P,6,2)
    n = A.shape[0]
    M = A @ A.T + lamb * torch.eye(n, dtype=A.dtype, device=device)

    def fit(col, w0r):                            # col (P,6), w0r (H,)
        alpha = torch.linalg.solve(M, (col - A @ w0r).T)     # (6,P)
        return (w0r[:, None] + A.T @ alpha).T                # (P,H)

    x = fit(pt[..., 0], w0[0])
    z = fit(pt[..., 1], w0[-1])
    w = torch.stack([x, torch.zeros_like(x), z], dim=1)
    zero = torch.zeros((), device=device)
    b3 = torch.stack([b[0], zero, b[1]]).expand(pts.shape[0], 3)
    return w, b3
