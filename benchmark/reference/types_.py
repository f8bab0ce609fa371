"""State containers of the per-env path (port of the JAX package's
``core/types.py``): ``NamedTuple``s of tensors, so that
``torch.func.vmap`` and ``torch.utils._pytree`` take them as they are.
``replace`` mirrors flax's ``struct.dataclass`` method."""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuadState(NamedTuple):
    """Dynamic state of one A1 robot (18 DoF): base-frame spatial velocity
    of the trunk (angular first) plus joint rates."""

    base_pos: torch.Tensor      # (3,) world position of trunk frame origin
    base_quat: torch.Tensor     # (4,) wxyz, trunk→world rotation
    base_ang_vel: torch.Tensor  # (3,) trunk angular velocity, trunk frame
    base_lin_vel: torch.Tensor  # (3,) trunk-origin linear velocity, trunk frame
    q: torch.Tensor             # (12,) joint angles
    qd: torch.Tensor            # (12,) joint velocities

    def replace(self, **kw) -> "QuadState":
        return self._replace(**kw)


class ContactState(NamedTuple):
    """Per-foot contact info from the soft-contact solver."""

    foot_pos: torch.Tensor      # (4,3) world foot-sphere centers
    foot_vel: torch.Tensor      # (4,3) world foot-center velocities
    forces: torch.Tensor        # (4,3) world contact forces on each foot
    penetration: torch.Tensor   # (4,) signed penetration depth (>0 in contact)
    in_contact: torch.Tensor    # (4,) bool
    knee_penetration: torch.Tensor  # (4,) knee/calf illegal-contact depth
    base_penetration: torch.Tensor  # () trunk-ground penetration depth

    def replace(self, **kw) -> "ContactState":
        return self._replace(**kw)


class RobotState(NamedTuple):
    """QuadState plus the latency ring buffers (newest at index 0, shapes
    (L,12), (L,12), (L,4), (L,3)), the last position target, the torques
    of the last substep and the contacts."""

    state: QuadState
    q_hist: torch.Tensor
    qd_hist: torch.Tensor
    quat_hist: torch.Tensor
    w_hist: torch.Tensor
    last_action: torch.Tensor       # (12,) last motor command
    applied_torque: torch.Tensor    # (12,) torques applied at last substep
    contact: ContactState

    def replace(self, **kw) -> "RobotState":
        return self._replace(**kw)
