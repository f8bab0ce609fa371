"""Observation normalization constants (EnvWrapper.py:50-55) and sensor
noise stds, an own copy of the JAX package's ``envs/sensors.py`` constants.
The batched env assembles the observation itself."""

from __future__ import annotations

import numpy as np

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
