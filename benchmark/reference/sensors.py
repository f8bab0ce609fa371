"""Observation assembly (port of the JAX package's ``envs/sensors.py``):
the normalization constants (EnvWrapper.py:50-55), the sensor noise stds,
and ``assemble_obs``, the per-env path's flat observation. The batched env
assembles its observation itself.

Sensors are assembled in the reference's alphabetical key order
(EnvWrapper.py:98): dis[0:3], contact[3:7], rpy[7:10], drpy[10:13],
q[13:25], q̇[25:37], ETG[37:49], then the optional channels.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.config import SensorConfig
from benchmark.reference import a1_model as a1

# EnvWrapper.py:50-55 — normalization stats of the ETG joint-space signal.
ETG_MEAN = np.array([
    2.1505982e-02, 3.6674485e-02, -6.0444288e-02,
    2.4625482e-02, 1.5869144e-02, -3.2513142e-02,
    2.1506395e-02, 3.1869926e-02, -6.0140789e-02,
    2.4625063e-02, 1.1628972e-02, -3.2163858e-02])
ETG_STD = np.array([
    4.5967497e-02, 2.0340437e-01, 3.7410179e-01,
    4.6187632e-02, 1.9441207e-01, 3.9488649e-01,
    4.5966785e-02, 2.0323379e-01, 3.7382501e-01,
    4.6188373e-02, 1.9457331e-01, 3.9302582e-01])

# Gaussian sensor-noise stds per channel type (minitaur._AddSensorNoise
# semantics; magnitudes follow motion_imitation's defaults).
NOISE_STD = {
    "dis": 0.05,
    "contact": 0.0,
    "rpy": 0.01,
    "drpy": 0.05,
    "q": 0.01,
    "qd": 0.1,
}

# Layout of the pre-drawn standard normals of one observation's noise:
# (channel, width), in the JAX package's key order.
NOISE_LAYOUT = (("dis", 3), ("rpy", 3), ("drpy", 3), ("q", 12), ("qd", 12))
NOISE_DIM = sum(w for _, w in NOISE_LAYOUT)


def assemble_obs(cfg: SensorConfig,
                 base_vel_w: torch.Tensor,
                 foot_contacts: torch.Tensor,
                 rpy: torch.Tensor,
                 drpy: torch.Tensor,
                 q_obs: torch.Tensor,
                 qd_obs: torch.Tensor,
                 etg_act: torch.Tensor,
                 etg_features: torch.Tensor | None = None,
                 foot_pose: torch.Tensor | None = None,
                 dynamic_vec: torch.Tensor | None = None,
                 ext_force: torch.Tensor | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """Flat observation for one env (vmap for batches). ``noise``: the
    (NOISE_DIM,) standard normals of this observation's sensor noise, drawn
    by the caller (``cfg.noise``); the JAX function draws them from a key."""
    parts = []
    if cfg.noise and noise is not None:
        o = 0
        draws = {}
        for name, w in NOISE_LAYOUT:
            draws[name] = noise[o:o + w] * NOISE_STD[name]
            o += w
        base_vel_w = base_vel_w + draws["dis"]
        rpy = rpy + draws["rpy"]
        drpy = drpy + draws["drpy"]
        q_obs = q_obs + draws["q"]
        qd_obs = qd_obs + draws["qd"]

    q0 = a1._c(a1.INIT_MOTOR_ANGLES, q_obs)
    if cfg.dis:
        parts.append(base_vel_w)
    if cfg.contact:
        parts.append(foot_contacts.to(torch.float32))
    if cfg.imu == 1:
        if cfg.normal:
            parts.append(torch.cat([rpy / 0.1, drpy / 0.5]))
        else:
            parts.append(torch.cat([rpy, drpy]))
    elif cfg.imu == 2:
        parts.append(drpy / 0.5 if cfg.normal else drpy)
    if cfg.motor == 1:
        q_n = (q_obs - q0) / 0.1 if cfg.normal else q_obs
        parts.append(torch.cat([q_n, qd_obs / 1.0]))
    elif cfg.motor == 2:
        parts.append((q_obs - q0) / 0.1 if cfg.normal else q_obs)
    if cfg.etg:
        e = ((etg_act - a1._c(ETG_MEAN, etg_act)) / a1._c(ETG_STD, etg_act)
             if cfg.normal else etg_act)
        parts.append(e)
    if cfg.etg_obs and etg_features is not None:
        parts.append(etg_features)
    if cfg.footpose and foot_pose is not None:
        parts.append(foot_pose.reshape(-1))
    if cfg.dynamic_vec and dynamic_vec is not None:
        # normalized [-1,1]⁴⁸ dynamics echo, appended raw
        parts.append(dynamic_vec)
    if cfg.force_vec and ext_force is not None:
        parts.append(ext_force)
    return torch.cat(parts)
