"""Butterworth action filter as a fixed-shape linear recurrence.

Port of the JAX package's ``envs/action_filter.py`` (the reference's
ActionFilterButter, deployment/robots/action_filter.py:111-120: an order-2
low-pass at 0–4 Hz, history initialized to the default pose). The (b, a)
coefficients are computed on the host with scipy; the direct-form-II-
transposed recurrence runs on tensors with a (2, 12, …) carried state.
"""

from __future__ import annotations

import numpy as np
import torch


def butter_lowpass_coeffs(sampling_rate: float, highcut: float = 4.0,
                          order: int = 2):
    """Low-pass Butterworth (b, a) (action_filter.py defaults: 0–4 Hz)."""
    from scipy import signal

    b, a = signal.butter(order, highcut / (0.5 * sampling_rate),
                         btype="low")
    return np.asarray(b, np.float32), np.asarray(a, np.float32)


def init_filter_state(b: np.ndarray, a: np.ndarray,
                      x0: torch.Tensor) -> torch.Tensor:
    """DF2T carried state (2, …) such that a constant input x0 yields x0."""
    z0 = float(1.0 - b[0]) * x0
    z1 = float(b[2] - a[2]) * x0
    return torch.stack([z0, z1])


def filter_step(b: np.ndarray, a: np.ndarray,
                z: torch.Tensor, x: torch.Tensor):
    """One DF2T step. Returns (y, new_state)."""
    y = float(b[0]) * x + z[0]
    z0 = float(b[1]) * x - float(a[1]) * y + z[1]
    z1 = float(b[2]) * x - float(a[2]) * y
    return y, torch.stack([z0, z1])
