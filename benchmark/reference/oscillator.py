"""ETG oscillator: 2-phase harmonic cycle expanded through RBF basis.

Port of the JAX package's ``etg/oscillator.py``. The oscillator traces
    p(t) = amp · [sin(2π t/T + φ₀), sin(2π t/T₂ + φ₁)]
and the phase is encoded through H Gaussian radial basis functions with
centers sampled uniformly along one period:
    V_i(t) = exp(−‖p(t) − p(t_i)‖² / σ²),  t_i = i·T/H.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.config import ETGConfig


def phase_point(t: torch.Tensor, cfg: ETGConfig) -> torch.Tensor:
    """Oscillator position p(t), shape t.shape + (2,)."""
    w1 = 2.0 * math.pi / cfg.T
    w2 = 2.0 * math.pi / cfg.T2
    p1 = cfg.amp * torch.sin(w1 * t + cfg.phase[0])
    p2 = cfg.amp * torch.sin(w2 * t + cfg.phase[1])
    return torch.stack([p1, p2], dim=-1)


def centers(cfg: ETGConfig) -> np.ndarray:
    """RBF centers along one period, shape (H, 2). Computed host-side."""
    ts = np.arange(cfg.H) * cfg.T / cfg.H
    w1 = 2.0 * np.pi / cfg.T
    w2 = 2.0 * np.pi / cfg.T2
    p1 = cfg.amp * np.sin(w1 * ts + cfg.phase[0])
    p2 = cfg.amp * np.sin(w2 * ts + cfg.phase[1])
    return np.stack([p1, p2], axis=-1)


def update(t: torch.Tensor, cfg: ETGConfig) -> torch.Tensor:
    """RBF feature vector V(t), shape t.shape + (H,)."""
    p = phase_point(t, cfg)                      # (..., 2)
    u = torch.as_tensor(centers(cfg), dtype=torch.float32, device=t.device)
    d2 = torch.sum((p[..., None, :] - u) ** 2, dim=-1)
    return torch.exp(-d2 / cfg.sigma_sq)


def feature_table(cfg: ETGConfig, n_steps: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """V(t_k) at the control-step times t_k = k·dt, (n_steps, H): a whole
    episode's phase features as one constant table."""
    ts = torch.arange(n_steps, device=device) * cfg.dt
    return update(ts, cfg)
