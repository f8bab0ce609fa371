"""Featherstone articulated-body dynamics (ABA) of the A1 for one env
(port of the JAX package's ``sim/dynamics.py``).

The constant block (per-leg link COMs, inertias and joint offsets, numpy)
is also what the batched physics (``sim/sbatch.py`` and the CUDA kernel)
reads. The per-env functions work on one env's tensors, the three-link leg
chains batched over the leg axis, and run under ``torch.func.vmap`` over
envs as the JAX ones run under ``jax.vmap``.

Spatial-vector conventions follow Featherstone's RBDA: motion vectors are
[ω; v] (angular first), force vectors [n; f]; a coordinate transform from
frame A to frame B located at r (A coords) with rotation E = B_R_A maps
motion as [Eω; E(v − r×ω)]. Randomizable physical parameters enter through
``DynamicsParams``, the per-env counterpart of ``sbatch.BDynParams`` (the
same fields without the trailing batch axis).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import math3d
from benchmark.reference.types_ import QuadState
from benchmark.reference import a1_model as a1
from benchmark.reference.a1_model import _c


class DynamicsParams(NamedTuple):
    """Per-env physical parameters (the reference's dynamic_param dict,
    train.py:112-126)."""

    base_mass_scale: torch.Tensor      # () scale on trunk mass
    base_inertia_scale: torch.Tensor   # (3,) scale on trunk inertia diagonal
    leg_mass_scale: torch.Tensor       # (3,) per link type [hip,thigh,calf]
    leg_inertia_scale: torch.Tensor    # (4,3) per leg × link type
    motor_kp: torch.Tensor             # (12,)
    motor_kd: torch.Tensor             # (12,)
    foot_friction: torch.Tensor        # () friction coefficient multiplier
    control_latency: torch.Tensor      # () seconds of observation latency
    gravity: torch.Tensor              # (3,) world gravity vector
    external_force: torch.Tensor       # (3,) world push force on the trunk

    @staticmethod
    def default(device=None) -> "DynamicsParams":
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device)
        return DynamicsParams(
            base_mass_scale=f(1.0), base_inertia_scale=f(np.ones(3)),
            leg_mass_scale=f(np.ones(3)), leg_inertia_scale=f(np.ones((4, 3))),
            motor_kp=f(a1.MOTOR_KP), motor_kd=f(a1.MOTOR_KD),
            foot_friction=f(1.0), control_latency=f(0.002),
            gravity=f([0.0, 0.0, -9.8]), external_force=f(np.zeros(3)))

    def replace(self, **kw) -> "DynamicsParams":
        return self._replace(**kw)

    def batched(self):
        """The ``sbatch.BDynParams`` of one env (trailing batch axis of 1)."""
        from benchmark.reference.sbatch import BDynParams

        return BDynParams(*[f[..., None] for f in self])

    @staticmethod
    def from_batched(p) -> "DynamicsParams":
        """One env's parameters from a ``BDynParams`` with a batch of 1."""
        return DynamicsParams(*[f[..., 0] for f in p])


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

# Joint motion subspaces: hip abduction about x, thigh/knee about y.
S_HIP = np.array([1.0, 0, 0, 0, 0, 0])
S_PITCH = np.array([0, 1.0, 0, 0, 0, 0])


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix (..., m, n) times vector (..., n)."""
    return (M @ v[..., None])[..., 0]


# --- spatial algebra helpers --------------------------------------------------

def spatial_inertia(mass, com, inertia_com):
    """6×6 spatial inertia about the body-frame origin,
    I = [[I_c + m ĉĉᵀ, m ĉ], [m ĉᵀ, m·1]] with ĉ = skew(com)."""
    c = math3d.skew(com)
    m = mass[..., None, None]
    mcct = m * (c @ c.transpose(-1, -2))
    top = torch.cat([inertia_com + mcct, m * c], dim=-1)
    eye = torch.eye(3, device=c.device).expand(c.shape)
    bot = torch.cat([m * c.transpose(-1, -2), m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def xmat(E, r):
    """Motion-vector transform: frame A → frame B at position r (A coords)
    with rotation E = B_R_A. X = [[E, 0], [−E·skew(r), E]]."""
    z = torch.zeros_like(E)
    top = torch.cat([E, z], dim=-1)
    bot = torch.cat([-E @ math3d.skew(r), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def crm(v):
    """Spatial cross product (motion): crm(v) = [[ω̂,0],[v̂,ω̂]]."""
    w = math3d.skew(v[..., :3])
    vx = math3d.skew(v[..., 3:])
    z = torch.zeros_like(w)
    return torch.cat([torch.cat([w, z], dim=-1),
                      torch.cat([vx, w], dim=-1)], dim=-2)


def crf(v):
    """Spatial cross product (force): crf(v) = −crm(v)ᵀ = [[ω̂,v̂],[0,ω̂]]."""
    w = math3d.skew(v[..., :3])
    vx = math3d.skew(v[..., 3:])
    z = torch.zeros_like(w)
    return torch.cat([torch.cat([w, vx], dim=-1),
                      torch.cat([z, w], dim=-1)], dim=-2)


def ext_spatial_force(R_body, origin, point_w, force_w):
    """World force at a world point → body-frame spatial force [n; f]."""
    Rt = R_body.transpose(-1, -2)
    f_local = _mv(Rt, force_w)
    n_w = math3d.cross(point_w - origin, force_w)
    return torch.cat([_mv(Rt, n_w), f_local], dim=-1)


# --- forward kinematics for the whole tree -----------------------------------

def world_poses(state: QuadState) -> dict:
    """World rotations and origins of all bodies and the foot centers:
    R_base (3,3), per leg R_hip/R_thigh/R_calf (4,3,3), o_hip/o_thigh/
    o_calf/o_foot (4,3)."""
    R_b = math3d.quat_to_mat(state.base_quat)
    q = state.q.reshape(4, 3)
    R_h = R_b @ math3d.rot_x(q[:, 0])
    o_h = state.base_pos + _mv(R_b, _c(HIP_POS_IN_TRUNK, q))
    R_t = R_h @ math3d.rot_y(q[:, 1])
    o_t = o_h + _mv(R_h, _c(THIGH_POS_IN_HIP, q))
    R_c = R_t @ math3d.rot_y(q[:, 2])
    o_c = o_t + _mv(R_t, _c(CALF_POS_IN_THIGH, q))
    o_f = o_c + _mv(R_c, _c(FOOT_POS_IN_CALF, q))
    return {
        "R_base": R_b,
        "R_hip": R_h, "o_hip": o_h,
        "R_thigh": R_t, "o_thigh": o_t,
        "R_calf": R_c, "o_calf": o_c,
        "o_foot": o_f,
    }


def foot_world_velocities(state: QuadState, poses) -> torch.Tensor:
    """World-frame velocities of the 4 foot centers, (4,3): the trunk's
    motion at the foot plus the leg Jacobian's joint part, rotated by
    R_base (the hip frames are trunk-aligned)."""
    R_b = poses["R_base"]
    w_w = _mv(R_b, state.base_ang_vel)
    v_w = _mv(R_b, state.base_lin_vel)
    rel = poses["o_foot"] - state.base_pos
    v_base_part = v_w + math3d.cross(w_w, rel)
    q = state.q.reshape(4, 3)
    qd = state.qd.reshape(4, 3)
    J = a1.analytical_leg_jacobian(q, _c(a1.HIP_SIGNS, q))      # (4,3,3)
    v_joint_world = _mv(R_b, _mv(J, qd))
    return v_base_part + v_joint_world


# --- articulated-body algorithm ----------------------------------------------

def _build_leg_inertias(params: DynamicsParams, like: torch.Tensor):
    """Per-leg spatial inertias with the randomization scales, (4,6,6)×3,
    and the link masses, (4,)×3."""
    ms = params.leg_mass_scale
    s = params.leg_inertia_scale
    ones = torch.ones(4, device=like.device)
    m_hip = ones * (float(LINK_MASSES[0]) * ms[0])
    m_thigh = ones * (float(LINK_MASSES[1]) * ms[1])
    m_calf = ones * (float(LINK_MASSES[2]) * ms[2])
    I_hip = spatial_inertia(m_hip, _c(HIP_COM, like),
                            _c(HIP_INERTIA_L, like) * s[:, 0][:, None, None])
    I_thigh = spatial_inertia(m_thigh, _c(THIGH_COM, like),
                              _c(THIGH_INERTIA_L, like)
                              * s[:, 1][:, None, None])
    I_calf = spatial_inertia(m_calf, _c(CALF_COM, like),
                             _c(CALF_INERTIA_L, like) * s[:, 2][:, None, None])
    return (I_hip, I_thigh, I_calf), (m_hip, m_thigh, m_calf)


def forward_dynamics(state: QuadState,
                     torques: torch.Tensor,
                     foot_forces_w: torch.Tensor,
                     knee_forces_w: torch.Tensor,
                     base_force_w: torch.Tensor,
                     params: DynamicsParams,
                     poses=None):
    """ABA forward dynamics for one env.

    torques (12,); foot/knee contact forces (4,3) world, at the foot
    centers and the calf origins; base_force_w (3,) world, at the trunk
    origin. Returns (a0, qdd): the base spatial acceleration (6,) in base
    coordinates and the joint accelerations (12,)."""
    if poses is None:
        poses = world_poses(state)
    tau = torques.reshape(4, 3)
    g = params.gravity
    q = state.q.reshape(4, 3)
    qd = state.qd.reshape(4, 3)

    # Trunk spatial inertia (scaled).
    m_trunk = float(a1.TRUNK_MASS) * params.base_mass_scale
    I_trunk_c = _c(a1.TRUNK_INERTIA, q) * params.base_inertia_scale[:, None]
    I0 = spatial_inertia(m_trunk, _c(a1.TRUNK_COM, q), I_trunk_c)

    (I_hip, I_thigh, I_calf), (m_hip, m_thigh, m_calf) = \
        _build_leg_inertias(params, q)

    # Joint transforms (parent→child motion transforms).
    E1 = math3d.rot_x(q[:, 0]).transpose(-1, -2)     # trunk→hip
    E2 = math3d.rot_y(q[:, 1]).transpose(-1, -2)     # hip→thigh
    E3 = math3d.rot_y(q[:, 2]).transpose(-1, -2)     # thigh→calf
    X1 = xmat(E1, _c(HIP_POS_IN_TRUNK, q))
    X2 = xmat(E2, _c(THIGH_POS_IN_HIP, q))
    X3 = xmat(E3, _c(CALF_POS_IN_THIGH, q))
    S1 = _c(S_HIP, q)
    S2 = _c(S_PITCH, q)

    # Pass 1: velocities and velocity-product biases (legs on axis 0).
    v0 = torch.cat([state.base_ang_vel, state.base_lin_vel])
    v1 = _mv(X1, v0[None, :]) + S1 * qd[:, 0:1]
    c1 = _mv(crm(v1), S1 * qd[:, 0:1])
    v2 = _mv(X2, v1) + S2 * qd[:, 1:2]
    c2 = _mv(crm(v2), S2 * qd[:, 1:2])
    v3 = _mv(X3, v2) + S2 * qd[:, 2:3]
    c3 = _mv(crm(v3), S2 * qd[:, 2:3])

    # External forces per body (gravity + contacts), in body coords.
    def grav_force(R, origin, mass, com):
        f_w = mass[..., None] * g
        com_w = origin + _mv(R, com)
        return ext_spatial_force(R, origin, com_w, f_w)

    f1 = grav_force(poses["R_hip"], poses["o_hip"], m_hip, _c(HIP_COM, q))
    f2 = grav_force(poses["R_thigh"], poses["o_thigh"], m_thigh,
                    _c(THIGH_COM, q))
    f3 = grav_force(poses["R_calf"], poses["o_calf"], m_calf,
                    _c(CALF_COM, q))
    # contact on the foot (attached to the calf) and the knee (calf origin)
    f3 = f3 + ext_spatial_force(poses["R_calf"], poses["o_calf"],
                                poses["o_foot"], foot_forces_w)
    f3 = f3 + ext_spatial_force(poses["R_calf"], poses["o_calf"],
                                poses["o_calf"], knee_forces_w)

    R_b = poses["R_base"]
    f0 = grav_force(R_b, state.base_pos, m_trunk, _c(a1.TRUNK_COM, q))
    f0 = f0 + ext_spatial_force(R_b, state.base_pos, state.base_pos,
                                base_force_w + params.external_force)

    # Pass 2: articulated inertias, inward (calf → hip → trunk).
    def eliminate(IA, pA, S, tau_j, c_bias):
        U = _mv(IA, S)                   # (...,6)
        d = torch.sum(U * S, dim=-1)     # Sᵀ IA S
        u = tau_j - torch.sum(pA * S, dim=-1)
        Ia = IA - U[..., :, None] * U[..., None, :] / d[..., None, None]
        pa = pA + _mv(Ia, c_bias) + U * (u / d)[..., None]
        return Ia, pa, U, d, u

    pA3 = _mv(crf(v3), _mv(I_calf, v3)) - f3
    Ia3, pa3, U3, d3, u3 = eliminate(I_calf, pA3, S2, tau[:, 2], c3)
    X3T = X3.transpose(-1, -2)
    IA2 = I_thigh + X3T @ Ia3 @ X3
    pA2 = _mv(crf(v2), _mv(I_thigh, v2)) - f2 + _mv(X3T, pa3)
    Ia2, pa2, U2, d2, u2 = eliminate(IA2, pA2, S2, tau[:, 1], c2)
    X2T = X2.transpose(-1, -2)
    IA1 = I_hip + X2T @ Ia2 @ X2
    pA1 = _mv(crf(v1), _mv(I_hip, v1)) - f1 + _mv(X2T, pa2)
    Ia1, pa1, U1, d1, u1 = eliminate(IA1, pA1, S1, tau[:, 0], c1)
    X1T = X1.transpose(-1, -2)
    IA0 = I0 + torch.sum(X1T @ Ia1 @ X1, dim=0)
    pA0 = _mv(crf(v0), _mv(I0, v0))
    pA0 = pA0 - f0 + torch.sum(_mv(X1T, pa1), dim=0)

    # Base: a0 = −IA0⁻¹ pA0 (6×6 solve).
    a0 = torch.linalg.solve(IA0, -pA0)

    # Pass 3: outward accelerations.
    a1_ = _mv(X1, a0[None, :]) + c1
    qdd1 = (u1 - (U1 * a1_).sum(-1)) / d1
    a1_ = a1_ + S1 * qdd1[..., None]
    a2_ = _mv(X2, a1_) + c2
    qdd2 = (u2 - (U2 * a2_).sum(-1)) / d2
    a2_ = a2_ + S2 * qdd2[..., None]
    a3_ = _mv(X3, a2_) + c3
    qdd3 = (u3 - (U3 * a3_).sum(-1)) / d3

    qdd = torch.stack([qdd1, qdd2, qdd3], dim=-1).reshape(12)
    return a0, qdd


def integrate(state: QuadState, a0: torch.Tensor, qdd: torch.Tensor,
              dt: float, max_joint_vel: float = 100.0,
              max_base_vel: float = 50.0) -> QuadState:
    """Semi-implicit Euler: velocities first, then positions."""
    w_new = torch.clamp(state.base_ang_vel + dt * a0[:3], -max_base_vel,
                        max_base_vel)
    v_new = torch.clamp(state.base_lin_vel + dt * a0[3:], -max_base_vel,
                        max_base_vel)
    qd_new = torch.clamp(state.qd + dt * qdd, -max_joint_vel, max_joint_vel)
    R_b = math3d.quat_to_mat(state.base_quat)
    pos_new = state.base_pos + dt * _mv(R_b, v_new)
    quat_new = math3d.quat_integrate(state.base_quat, _mv(R_b, w_new), dt)
    q_new = state.q + dt * qd_new
    return QuadState(base_pos=pos_new, base_quat=quat_new,
                     base_ang_vel=w_new, base_lin_vel=v_new,
                     q=q_new, qd=qd_new)


def default_state(height=0.32, motor_angles=None,
                  device=None) -> QuadState:
    """Initial standing state (a1.py INIT_POSITION / INIT_MOTOR_ANGLES);
    ``height`` may be a tensor (its device is then the state's)."""
    if isinstance(height, torch.Tensor):
        device = height.device
    z = torch.zeros(3, device=device)
    q0 = torch.as_tensor(
        np.asarray(a1.INIT_MOTOR_ANGLES if motor_angles is None
                   else motor_angles, np.float32), device=device)
    pos = torch.stack([z[0], z[0], torch.as_tensor(
        height, dtype=torch.float32, device=device)])
    return QuadState(
        base_pos=pos,
        base_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
        base_ang_vel=z, base_lin_vel=z.clone(), q=q0,
        qd=torch.zeros(12, device=device))
