"""On-robot state estimation: velocity Kalman filter + moving-window mean
(PyTorch port of the JAX package's ``deploy/estimator.py``).

Rebuild of deployment/robots/a1_robot_velocity_estimator.py (scalar-gain
KF fusing accelerometer integration with contact-leg FK velocity, plus a
120-sample moving window) and moving_window_filter.py (Neumaier
compensated-sum windowed mean). The states are NamedTuples of tensors and
the updates return new ones, as in the JAX package; ``window_init`` and
``estimator_init`` put them on ``resolve_device(device)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.sim import a1_model as a1


class MovingWindowState(NamedTuple):
    """Fixed-size window mean with a Neumaier-compensated running sum."""

    window: torch.Tensor   # (W, d)
    idx: int               # pushes so far
    total: torch.Tensor    # (d,) running sum
    comp: torch.Tensor     # (d,) compensation term


def window_init(size: int, dim: int, device=None) -> MovingWindowState:
    dev = resolve_device(device)
    return MovingWindowState(window=torch.zeros((size, dim), device=dev),
                             idx=0, total=torch.zeros(dim, device=dev),
                             comp=torch.zeros(dim, device=dev))


def window_update(s: MovingWindowState, value: torch.Tensor):
    """Push a value; returns (mean, new_state)."""
    W = s.window.shape[0]
    slot = s.idx % W
    old = s.window[slot]
    # Neumaier update of total += value − old
    delta = value - old
    t = s.total + delta
    comp = s.comp + torch.where(torch.abs(s.total) >= torch.abs(delta),
                                (s.total - t) + delta,
                                (delta - t) + s.total)
    window = s.window.clone()
    window[slot] = value
    mean = (t + comp) / float(min(s.idx + 1, W))
    return mean, MovingWindowState(window, s.idx + 1, t, comp)


class VelocityEstimatorState(NamedTuple):
    estimate: torch.Tensor         # (3,) filtered base velocity (world)
    variance: torch.Tensor         # () scalar covariance
    window: MovingWindowState


def estimator_init(window_size: int = 120,
                   device=None) -> VelocityEstimatorState:
    dev = resolve_device(device)
    return VelocityEstimatorState(
        estimate=torch.zeros(3, device=dev),
        variance=torch.tensor(0.1, device=dev),
        window=window_init(window_size, 3, device=dev))


def estimator_update(s: VelocityEstimatorState, accel_world: torch.Tensor,
                     motor_q: torch.Tensor, motor_qd: torch.Tensor,
                     foot_contacts: torch.Tensor, dt: float,
                     accel_var: float = 0.1, obs_var: float = 0.1):
    """One KF step (a1_robot_velocity_estimator.py:13-60 semantics).

    Predict by integrating the (gravity-compensated) world acceleration;
    observe the negated stance-foot velocity from leg kinematics; fuse
    with a scalar Kalman gain; smooth with the moving window. Returns
    (mean, new_state)."""
    pred = s.estimate + accel_world * dt
    var = s.variance + accel_var * dt

    # observe: v_base ≈ −J(q)·q̇ for legs in contact (base frame ≈ world
    # for small tilt; the reference rotates by base orientation)
    q = motor_q.reshape(4, 3)
    qd = motor_qd.reshape(4, 3)
    J = a1.analytical_leg_jacobian(q, a1.HIP_SIGNS)
    foot_vel = (J @ qd[..., None])[..., 0]            # (4,3)
    contact_f = foot_contacts.to(torch.float32)
    n_contact = torch.sum(contact_f)
    obs = -torch.sum(foot_vel * contact_f[:, None], dim=0) / \
        torch.clamp(n_contact, min=1.0)
    have_obs = n_contact > 0

    gain = var / (var + obs_var)
    fused = torch.where(have_obs, pred + gain * (obs - pred), pred)
    var = torch.where(have_obs, (1.0 - gain) * var, var)

    mean, win = window_update(s.window, fused)
    return mean, VelocityEstimatorState(fused, var, win)
