"""Least-squares fit of the ETG linear readout onto control points.

Port of the JAX package's ``etg/fit.py`` (rebuild of ``Opt_with_points``,
ETGRL/train.py:59-110): the closed form of the proximal least squares,
solved through its 6×6 dual in float32 with ``torch.linalg.solve``.
"""

from __future__ import annotations

import numpy as np
import torch

from paddlerobotics_torch.core.config import ETGConfig
from paddlerobotics_torch.etg import oscillator


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
    """A = V(tₛ) stacked over the six sample times, (6, H)."""
    t = torch.as_tensor(sample_times(cfg), dtype=torch.float32, device=device)
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
    train.py:108-109 produces (y row zero)."""
    if points is None:
        points = torch.as_tensor(prior_points(cfg), dtype=torch.float32,
                                 device=device)
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
