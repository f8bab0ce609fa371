"""Constant link data of the A1 tree (numpy).

Only the constant block of the JAX package's ``sim/dynamics.py`` is ported:
the per-leg link COMs, inertias and joint offsets that the batched physics
(``sim/sbatch.py`` and the CUDA kernel) read. The per-env ABA of that module
is not ported; the batched SoA path replaces it.
"""

from __future__ import annotations

import numpy as np

from paddlerobotics_torch.sim import a1_model as a1


def _mirror_y(inertia: np.ndarray) -> np.ndarray:
    m = np.diag([1.0, -1.0, 1.0])
    return m @ inertia @ m


_CALF_MASS, _CALF_COM, _CALF_INERTIA = a1.combined_calf_inertia()

# Per-leg link constants; legs ordered FR, FL, RR, RL. Right legs (FR, RR)
# use the URDF right-side values; left legs mirror the y components.
_LEG_IS_LEFT = np.array([False, True, False, True])

HIP_COM = np.stack([
    a1.HIP_COM_R * np.array([1.0, -1.0, 1.0]) if left else a1.HIP_COM_R
    for left in _LEG_IS_LEFT])
HIP_INERTIA_L = np.stack([
    _mirror_y(a1.HIP_INERTIA) if left else a1.HIP_INERTIA for left in _LEG_IS_LEFT])
THIGH_COM = np.stack([
    a1.THIGH_COM_R * np.array([1.0, -1.0, 1.0]) if left else a1.THIGH_COM_R
    for left in _LEG_IS_LEFT])
THIGH_INERTIA_L = np.stack([
    _mirror_y(a1.THIGH_INERTIA) if left else a1.THIGH_INERTIA
    for left in _LEG_IS_LEFT])
CALF_COM = np.broadcast_to(_CALF_COM, (4, 3)).copy()
CALF_INERTIA_L = np.broadcast_to(_CALF_INERTIA, (4, 3, 3)).copy()

LINK_MASSES = np.array([a1.HIP_MASS, a1.THIGH_MASS, _CALF_MASS])

# Joint attachment translations.
HIP_POS_IN_TRUNK = a1.HIP_JOINT_IN_TRUNK.copy()           # (4,3)
THIGH_POS_IN_HIP = np.stack([
    np.array([0.0, a1.THIGH_JOINT_IN_HIP_Y if left else -a1.THIGH_JOINT_IN_HIP_Y, 0.0])
    for left in _LEG_IS_LEFT])                            # (4,3)
CALF_POS_IN_THIGH = np.broadcast_to(a1.CALF_JOINT_IN_THIGH, (4, 3)).copy()
FOOT_POS_IN_CALF = np.broadcast_to(a1.FOOT_OFFSET_IN_CALF, (4, 3)).copy()

TRUNK_HALF_HEIGHT = 0.057  # trunk collision box half height (a1.urdf: 0.114/2)
