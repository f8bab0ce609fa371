"""Structure-of-arrays batched A1 physics: the plain PyTorch version.

Port of the JAX package's ``sim/sbatch.py``: the same math (Featherstone
ABA + penalty contact) in batch-minor layout, every scalar quantity a (B,)
or (4,B) tensor and all small-matrix algebra unrolled through
``ops/smallalg``. This module is the plain version of the CUDA kernel in
``ops/csrc/physics_step.cu``: the CPU path runs it, and the kernel is held
against it on the card. ``ops/physics_step.control_step`` picks between the
two by the device of the tensors it is given.

Spatial quantities are carried as 3×3 blocks: an articulated inertia is
(A, H, M) for [[A, H],[Hᵀ, M]]; a spatial vector is a pair of 3-vectors
(angular, linear). Transform child→parent of IA = Xᵀ IA X with
X = [[E,0],[−Er̂,E]] expands blockwise to
  A' = EᵀAE;  H' = EᵀHE;  M' = EᵀME
  TL = A' − H'r̂ + r̂H'ᵀ − r̂M'r̂,  TR = H' + r̂M',  BR = M'.

Latency semantics follow the reference (minitaur.ReceiveObservation:
1151-1170, _GetDelayedObservation:1172-1193, _GetPDObservation:1195-1199):
``obs_hist`` is a substep-resolution ring of [q, q̇, quat, ω] rows, read by
``delayed_obs`` for the policy observation and, when ``cfg.pd_latency > 0``,
through static taps for the PD input.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.config import SimConfig
from benchmark.reference import smallalg as sa
from benchmark.reference import a1_model as a1
from benchmark.reference import dynamics as dyn

F32 = torch.float32
# Substep-snapshot row layout: [q(0:12) | qd(12:24) | quat(24:28) | w(28:31)]
OBS_ROW = 31
# Default ring length: 40 × 2.6 ms = 104 ms ≥ the 80 ms DR latency range.
SUB_HIST_LEN = 40


# --- state -------------------------------------------------------------------

class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class BQuadState(_Replace):
    """Batched quad state; every tensor has batch as the LAST axis."""

    pos: torch.Tensor    # (3,B)
    quat: torch.Tensor   # (4,B) wxyz
    w: torch.Tensor      # (3,B) base angular vel (base frame)
    v: torch.Tensor      # (3,B) base linear vel (base frame)
    q: torch.Tensor      # (12,B)
    qd: torch.Tensor     # (12,B)


@dataclasses.dataclass
class BContact(_Replace):
    foot_pos: torch.Tensor      # (3,4,B) world foot centers
    foot_contact: torch.Tensor  # (4,B) bool
    knee_contact: torch.Tensor  # (4,B) bool
    base_contact: torch.Tensor  # (B,) bool


@dataclasses.dataclass
class BRobot(_Replace):
    s: BQuadState
    last_action: torch.Tensor  # (12,B)
    tau: torch.Tensor          # (12,B) applied torques (last substep)
    contact: BContact
    # Substep-resolution observation ring, rows [q | qd | quat | w].
    # CIRCULAR: `hist_head` is the physical index of the NEWEST row;
    # logical age k lives at physical (hist_head - k) mod L.
    obs_hist: torch.Tensor     # (L, OBS_ROW, B)
    # A host int shared by all envs: it advances by a data-independent
    # amount every control step, and a device scalar would force a sync
    # for ring_push's slice offset.
    hist_head: int


class BDynParams(NamedTuple):
    """Batched physical params, batch-last (ranges: ETGRL/train.py:112-126)."""

    base_mass_scale: torch.Tensor     # (B,)
    base_inertia_scale: torch.Tensor  # (3,B)
    leg_mass_scale: torch.Tensor      # (3,B)
    leg_inertia_scale: torch.Tensor   # (4,3,B) per leg × link
    motor_kp: torch.Tensor            # (12,B)
    motor_kd: torch.Tensor            # (12,B)
    foot_friction: torch.Tensor       # (B,)
    control_latency: torch.Tensor     # (B,)
    gravity: torch.Tensor             # (3,B)
    external_force: torch.Tensor      # (3,B)

    @staticmethod
    def default(B: int, device: torch.device | str = "cpu") -> "BDynParams":
        def col(vals):
            t = torch.as_tensor(np.asarray(vals, np.float32), device=device)
            return t[:, None].repeat(1, B)

        one = torch.ones((B,), dtype=F32, device=device)
        return BDynParams(
            base_mass_scale=one,
            base_inertia_scale=torch.ones((3, B), dtype=F32, device=device),
            leg_mass_scale=torch.ones((3, B), dtype=F32, device=device),
            leg_inertia_scale=torch.ones((4, 3, B), dtype=F32, device=device),
            motor_kp=col(a1.MOTOR_KP),
            motor_kd=col(a1.MOTOR_KD),
            foot_friction=one.clone(),
            control_latency=torch.full((B,), 0.002, dtype=F32, device=device),
            gravity=col([0.0, 0.0, -9.8]),
            external_force=torch.zeros((3, B), dtype=F32, device=device),
        )

    @staticmethod
    def from_leading(p) -> "BDynParams":
        """Batch-leading per-env parameters (``sim.dynamics.DynamicsParams``
        of a ``torch.func.vmap``, leaves (B, ...)) → batch-last."""
        return BDynParams(*[torch.movedim(torch.as_tensor(x, dtype=F32), 0,
                                          -1).contiguous() for x in p])


# --- constants ---------------------------------------------------------------

_CALF_R = [float(dyn.CALF_POS_IN_THIGH[0, i]) for i in range(3)]
_FOOT_R = [float(dyn.FOOT_POS_IN_CALF[0, i]) for i in range(3)]
_CALF_COM = [float(dyn.CALF_COM[0, i]) for i in range(3)]
_CALF_I = [[float(dyn.CALF_INERTIA_L[0, i, j]) for j in range(3)]
           for i in range(3)]
_TRUNK_COM = [float(a1.TRUNK_COM[i]) for i in range(3)]
_TRUNK_I = [[float(a1.TRUNK_INERTIA[i, j]) for j in range(3)] for i in range(3)]
_M_HIP, _M_THIGH, _M_CALF = [float(m) for m in dyn.LINK_MASSES]
_TORQUE_LIMIT = float(a1.TORQUE_LIMIT[0])

# Per-leg constants, (3,4) vectors and (3,3,4) matrices in float32 — the
# layout of the JAX package's sbatch.CONST_INPUTS.
CONST_INPUTS = {
    "HIP_R": dyn.HIP_POS_IN_TRUNK.T, "THIGH_R": dyn.THIGH_POS_IN_HIP.T,
    "HIP_COM": dyn.HIP_COM.T, "THIGH_COM": dyn.THIGH_COM.T,
    "HIP_I": np.transpose(dyn.HIP_INERTIA_L, (1, 2, 0)),
    "THIGH_I": np.transpose(dyn.THIGH_INERTIA_L, (1, 2, 0)),
}
CONST_INPUTS = {k: np.ascontiguousarray(v, np.float32)
                for k, v in CONST_INPUTS.items()}


@functools.lru_cache(maxsize=None)
def leg_consts(device: torch.device) -> dict:
    """The per-leg constants as smallalg lists of (4,1) tensors on `device`."""
    def t(a):
        return torch.as_tensor(a, device=device).reshape(4, 1)

    vec = lambda a: [t(a[i]) for i in range(3)]
    mat = lambda a: [[t(a[i, j]) for j in range(3)] for i in range(3)]
    c = CONST_INPUTS
    return {"HIP_R": vec(c["HIP_R"]), "THIGH_R": vec(c["THIGH_R"]),
            "HIP_COM": vec(c["HIP_COM"]), "THIGH_COM": vec(c["THIGH_COM"]),
            "HIP_I": mat(c["HIP_I"]), "THIGH_I": mat(c["THIGH_I"])}


def _consts_for(x: torch.Tensor) -> dict:
    return leg_consts(x.device)


def _sum4(x):
    """Sum over the leg axis in a fixed order (the CUDA kernel's order)."""
    if isinstance(x, float):
        return x * 4.0
    return ((x[0] + x[1]) + x[2]) + x[3]


# --- blockwise spatial algebra -----------------------------------------------

def spatial_inertia_blocks(m, com, I_com):
    """Rigid-body spatial inertia blocks (A, H, M3) about the frame origin:
    [[I_c + m ĉĉᵀ, m ĉ], [m ĉᵀ, m·1]]. M3 is the full 3×3 lower block."""
    c = sa.skew(com)
    A = sa.madd(I_com, sa.mscale(m, sa.mm(c, sa.mT(c))))
    H = sa.mscale(m, c)
    M3 = sa.mscale(m, sa.eye(3))
    return A, H, M3


def iv_product(A, H, M3, w, u):
    """[[A,H],[Hᵀ,M3]] @ [w;u] → (n, f)."""
    n = sa.vadd(sa.mv(A, w), sa.mv(H, u))
    f = sa.vadd(sa.mv(sa.mT(H), w), sa.mv(M3, u))
    return n, f


def crf_apply(w, u, n, f):
    """crf([w;u]) @ [n;f] = [w×n + u×f; w×f]."""
    return sa.vadd(sa.cross(w, n), sa.cross(u, f)), sa.cross(w, f)


def xform_motion(E, r, w, u):
    """child←parent motion: [Ew, E(u − r×w)]."""
    return sa.mv(E, w), sa.mv(E, sa.vsub(u, sa.cross(r, w)))


def xform_force_to_parent(E, r, n, f):
    """n_P = Eᵀn + r×(Eᵀf); f_P = Eᵀf."""
    Et = sa.mT(E)
    fp = sa.mv(Et, f)
    return sa.vadd(sa.mv(Et, n), sa.cross(r, fp)), fp


def xform_inertia_to_parent(E, r, A, H, M3):
    """Blocks of Xᵀ [[A,H],[Hᵀ,M3]] X for X = [[E,0],[−Er̂,E]]."""
    Et = sa.mT(E)
    rx = sa.skew(r)
    Ap = sa.mm(Et, sa.mm(A, E))
    Hp = sa.mm(Et, sa.mm(H, E))
    Mp = sa.mm(Et, sa.mm(M3, E))
    HpRx = sa.mm(Hp, rx)
    RxMp = sa.mm(rx, Mp)
    # TL = A' − H'r̂ − (H'r̂)ᵀ − r̂M'r̂   (since r̂H'ᵀ = −(H'r̂)ᵀ)
    TL = sa.msub(sa.msub(sa.msub(Ap, HpRx), sa.mT(HpRx)),
                 sa.mm(RxMp, rx))
    TR = sa.madd(Hp, RxMp)
    return TL, TR, Mp


# --- kinematic chain ---------------------------------------------------------

def quat_to_mat_cols(q):
    """Quaternion components (4,B) → rotation matrix as smallalg Mat."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return [
        [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
    ]


def _chain_poses(s: BQuadState, C=None):
    """World rotations/origins for base + per-leg hip/thigh/calf + foot pos.

    Returns dict of smallalg Mats/Vecs; leg entries are (4,B) scalars.
    """
    C = C or _consts_for(s.q)
    Rb = quat_to_mat_cols(s.quat)
    pos = [s.pos[0], s.pos[1], s.pos[2]]
    q = s.q.reshape(4, 3, -1)
    c1, s1 = torch.cos(q[:, 0]), torch.sin(q[:, 0])
    c2, s2 = torch.cos(q[:, 1]), torch.sin(q[:, 1])
    c3, s3 = torch.cos(q[:, 2]), torch.sin(q[:, 2])
    Rx1 = sa.rot_x(c1, s1)
    Ry2 = sa.rot_y(c2, s2)
    Ry3 = sa.rot_y(c3, s3)

    Rh = sa.mm(Rb, Rx1)
    oh = sa.vadd(pos, sa.mv(Rb, C["HIP_R"]))
    Rt = sa.mm(Rh, Ry2)
    ot = sa.vadd(oh, sa.mv(Rh, C["THIGH_R"]))
    Rc = sa.mm(Rt, Ry3)
    oc = sa.vadd(ot, sa.mv(Rt, _CALF_R))
    of = sa.vadd(oc, sa.mv(Rc, _FOOT_R))
    return dict(Rb=Rb, pos=pos, Rx1=Rx1, Ry2=Ry2, Ry3=Ry3,
                Rh=Rh, oh=oh, Rt=Rt, ot=ot, Rc=Rc, oc=oc, of=of,
                trig=(c1, s1, c2, s2, c3, s3))


def _ext_force_local(R, origin, point_w, force_w):
    """World force at world point → body-frame spatial force (n, f)."""
    Rt = sa.mT(R)
    f = sa.mv(Rt, force_w)
    arm = sa.vsub(point_w, origin)
    n = sa.mv(Rt, sa.cross(arm, force_w))
    return n, f


# --- forward dynamics (ABA) --------------------------------------------------

def chain_velocities(s: BQuadState, poses, C=None):
    """Pass-1 spatial velocities (body coords) + velocity-product biases."""
    C = C or _consts_for(s.q)
    c1, s1, c2, s2, c3, s3 = poses["trig"]
    E1 = sa.mT(sa.rot_x(c1, s1))
    E2 = sa.mT(sa.rot_y(c2, s2))
    E3 = sa.mT(sa.rot_y(c3, s3))
    qd = s.qd.reshape(4, 3, -1)
    qd1, qd2, qd3 = qd[:, 0], qd[:, 1], qd[:, 2]
    v0w = [s.w[0], s.w[1], s.w[2]]
    v0u = [s.v[0], s.v[1], s.v[2]]
    w1, u1 = xform_motion(E1, C["HIP_R"], v0w, v0u)
    w1 = sa.vadd(w1, [qd1, 0.0, 0.0])
    cw1, cu1 = sa.cross(w1, [qd1, 0.0, 0.0]), sa.cross(u1, [qd1, 0.0, 0.0])
    w2, u2 = xform_motion(E2, C["THIGH_R"], w1, u1)
    w2 = sa.vadd(w2, [0.0, qd2, 0.0])
    cw2, cu2 = sa.cross(w2, [0.0, qd2, 0.0]), sa.cross(u2, [0.0, qd2, 0.0])
    w3, u3 = xform_motion(E3, _CALF_R, w2, u2)
    w3 = sa.vadd(w3, [0.0, qd3, 0.0])
    cw3, cu3 = sa.cross(w3, [0.0, qd3, 0.0]), sa.cross(u3, [0.0, qd3, 0.0])
    return dict(E1=E1, E2=E2, E3=E3, v0w=v0w, v0u=v0u,
                w1=w1, u1=u1, cw1=cw1, cu1=cu1,
                w2=w2, u2=u2, cw2=cw2, cu2=cu2,
                w3=w3, u3=u3, cw3=cw3, cu3=cu3)


def build_inertias(p: BDynParams, C=None):
    """Spatial-inertia blocks for trunk + legs with randomization scales.

    A pure function of the physics params, loop-invariant across substeps.
    """
    C = C or _consts_for(p.motor_kp)
    m0 = p.base_mass_scale * a1.TRUNK_MASS
    I0c = [[sa.smul(_TRUNK_I[i][j], p.base_inertia_scale[i])
            for j in range(3)] for i in range(3)]
    A0, H0, M0 = spatial_inertia_blocks(m0, _TRUNK_COM, I0c)

    m_h = p.leg_mass_scale[0] * _M_HIP          # (B,) broadcast to (4,B)
    m_t = p.leg_mass_scale[1] * _M_THIGH
    m_c = p.leg_mass_scale[2] * _M_CALF
    sc_h = p.leg_inertia_scale[:, 0]            # (4,B)
    sc_t = p.leg_inertia_scale[:, 1]
    sc_c = p.leg_inertia_scale[:, 2]
    I1c = [[sa.smul(C["HIP_I"][i][j], sc_h) for j in range(3)] for i in range(3)]
    I2c = [[sa.smul(C["THIGH_I"][i][j], sc_t) for j in range(3)] for i in range(3)]
    I3c = [[sa.smul(_CALF_I[i][j], sc_c) for j in range(3)] for i in range(3)]
    A1_, H1_, M1_ = spatial_inertia_blocks(m_h, C["HIP_COM"], I1c)
    A2_, H2_, M2_ = spatial_inertia_blocks(m_t, C["THIGH_COM"], I2c)
    A3_, H3_, M3_ = spatial_inertia_blocks(m_c, _CALF_COM, I3c)
    return {"A0": A0, "H0": H0, "M0": M0,
            "A1": A1_, "H1": H1_, "M1": M1_,
            "A2": A2_, "H2": H2_, "M2": M2_,
            "A3": A3_, "H3": H3_, "M3": M3_,
            "m0": m0, "m_h": m_h, "m_t": m_t, "m_c": m_c}


def forward_dynamics(s: BQuadState, tau: torch.Tensor,
                     foot_f, knee_f, base_f,
                     p: BDynParams, poses=None, vels=None, C=None,
                     inertias=None):
    """Batched ABA. tau (12,B); forces are smallalg Vec3s with (4,B) or
    (B,) components in WORLD frame. Returns (a0 (6,B list), qdd (12,B))."""
    C = C or _consts_for(s.q)
    if poses is None:
        poses = _chain_poses(s, C)
    if vels is None:
        vels = chain_velocities(s, poses, C)
    if inertias is None:
        inertias = build_inertias(p, C)
    Rb, pos = poses["Rb"], poses["pos"]
    E1, E2, E3 = vels["E1"], vels["E2"], vels["E3"]
    v0w, v0u = vels["v0w"], vels["v0u"]
    w1, u1, cw1, cu1 = vels["w1"], vels["u1"], vels["cw1"], vels["cu1"]
    w2, u2, cw2, cu2 = vels["w2"], vels["u2"], vels["cw2"], vels["cu2"]
    w3, u3, cw3, cu3 = vels["w3"], vels["u3"], vels["cw3"], vels["cu3"]
    g = [p.gravity[0], p.gravity[1], p.gravity[2]]

    ine = inertias
    A0, H0, M0 = ine["A0"], ine["H0"], ine["M0"]
    A1_, H1_, M1_ = ine["A1"], ine["H1"], ine["M1"]
    A2_, H2_, M2_ = ine["A2"], ine["H2"], ine["M2"]
    A3_, H3_, M3_ = ine["A3"], ine["H3"], ine["M3"]
    m0, m_h, m_t, m_c = ine["m0"], ine["m_h"], ine["m_t"], ine["m_c"]

    # external forces per body: gravity at COM (+ contacts on calf/trunk)
    def grav(R, origin, m, com):
        fw = sa.vscale(m, g)
        com_w = sa.vadd(origin, sa.mv(R, com))
        return _ext_force_local(R, origin, com_w, fw)

    n1f, f1f = grav(poses["Rh"], poses["oh"], m_h, C["HIP_COM"])
    n2f, f2f = grav(poses["Rt"], poses["ot"], m_t, C["THIGH_COM"])
    n3f, f3f = grav(poses["Rc"], poses["oc"], m_c, _CALF_COM)
    nc, fc = _ext_force_local(poses["Rc"], poses["oc"], poses["of"], foot_f)
    n3f, f3f = sa.vadd(n3f, nc), sa.vadd(f3f, fc)
    nk, fk = _ext_force_local(poses["Rc"], poses["oc"], poses["oc"], knee_f)
    n3f, f3f = sa.vadd(n3f, nk), sa.vadd(f3f, fk)

    n0f, f0f = grav(Rb, pos, m0, _TRUNK_COM)
    base_tot = sa.vadd(base_f, [p.external_force[0], p.external_force[1],
                                p.external_force[2]])
    nb, fb = _ext_force_local(Rb, pos, pos, base_tot)
    n0f, f0f = sa.vadd(n0f, nb), sa.vadd(f0f, fb)

    # pass 2: articulated inertia, inward
    def bias_force(A, H, M3, w, u, nf, ff):
        n_iv, f_iv = iv_product(A, H, M3, w, u)
        pn, pf = crf_apply(w, u, n_iv, f_iv)
        return sa.vsub(pn, nf), sa.vsub(pf, ff)

    def eliminate(A, H, M3, pn, pf, ax, tau_j, cw, cu):
        # U = IA[:, ax] (angular part A col, linear part Hᵀ col = H row)
        Ua = [A[0][ax], A[1][ax], A[2][ax]]
        Ul = [H[ax][0], H[ax][1], H[ax][2]]
        d = A[ax][ax]
        u_ = tau_j - pn[ax]
        inv_d = 1.0 / d
        An = sa.msub(A, sa.mscale(inv_d, sa.outer(Ua, Ua)))
        Hn = sa.msub(H, sa.mscale(inv_d, sa.outer(Ua, Ul)))
        Mn = sa.msub(M3, sa.mscale(inv_d, sa.outer(Ul, Ul)))
        # pa = pA + Ia c + U u/d
        ia_n, ia_f = iv_product(An, Hn, Mn, cw, cu)
        k = u_ * inv_d
        pan = sa.vadd(sa.vadd(pn, ia_n), sa.vscale(k, Ua))
        paf = sa.vadd(sa.vadd(pf, ia_f), sa.vscale(k, Ul))
        return An, Hn, Mn, pan, paf, Ua, Ul, d, u_

    tau_l = tau.reshape(4, 3, -1)

    pn3, pf3 = bias_force(A3_, H3_, M3_, w3, u3, n3f, f3f)
    A3e, H3e, M3e, pan3, paf3, U3a, U3l, d3, uu3 = eliminate(
        A3_, H3_, M3_, pn3, pf3, 1, tau_l[:, 2], cw3, cu3)
    tA, tH, tM = xform_inertia_to_parent(E3, _CALF_R, A3e, H3e, M3e)
    pn, pf = xform_force_to_parent(E3, _CALF_R, pan3, paf3)
    A2t, H2t, M2t = sa.madd(A2_, tA), sa.madd(H2_, tH), sa.madd(M2_, tM)
    bn2, bf2 = bias_force(A2_, H2_, M2_, w2, u2, n2f, f2f)
    pn2, pf2 = sa.vadd(bn2, pn), sa.vadd(bf2, pf)
    A2e, H2e, M2e, pan2, paf2, U2a, U2l, d2, uu2 = eliminate(
        A2t, H2t, M2t, pn2, pf2, 1, tau_l[:, 1], cw2, cu2)
    tA, tH, tM = xform_inertia_to_parent(E2, C["THIGH_R"], A2e, H2e, M2e)
    pn, pf = xform_force_to_parent(E2, C["THIGH_R"], pan2, paf2)
    A1t, H1t, M1t = sa.madd(A1_, tA), sa.madd(H1_, tH), sa.madd(M1_, tM)
    bn1, bf1 = bias_force(A1_, H1_, M1_, w1, u1, n1f, f1f)
    pn1, pf1 = sa.vadd(bn1, pn), sa.vadd(bf1, pf)
    A1e, H1e, M1e, pan1, paf1, U1a, U1l, d1, uu1 = eliminate(
        A1t, H1t, M1t, pn1, pf1, 0, tau_l[:, 0], cw1, cu1)
    tA, tH, tM = xform_inertia_to_parent(E1, C["HIP_R"], A1e, H1e, M1e)
    pn, pf = xform_force_to_parent(E1, C["HIP_R"], pan1, paf1)

    # accumulate legs into base: sum (4,B) → (B,)
    A0t = sa.madd(A0, [[_sum4(tA[i][j]) for j in range(3)] for i in range(3)])
    H0t = sa.madd(H0, [[_sum4(tH[i][j]) for j in range(3)] for i in range(3)])
    M0t = sa.madd(M0, [[_sum4(tM[i][j]) for j in range(3)] for i in range(3)])
    bn0, bf0 = bias_force(A0, H0, M0, v0w, v0u, n0f, f0f)
    pn0 = sa.vadd(bn0, [_sum4(pn[i]) for i in range(3)])
    pf0 = sa.vadd(bf0, [_sum4(pf[i]) for i in range(3)])

    # base 6×6 SPD solve: IA0 a0 = −pA0
    IA6 = [[A0t[0][0], A0t[0][1], A0t[0][2], H0t[0][0], H0t[0][1], H0t[0][2]],
           [A0t[1][0], A0t[1][1], A0t[1][2], H0t[1][0], H0t[1][1], H0t[1][2]],
           [A0t[2][0], A0t[2][1], A0t[2][2], H0t[2][0], H0t[2][1], H0t[2][2]],
           [H0t[0][0], H0t[1][0], H0t[2][0], M0t[0][0], M0t[0][1], M0t[0][2]],
           [H0t[0][1], H0t[1][1], H0t[2][1], M0t[1][0], M0t[1][1], M0t[1][2]],
           [H0t[0][2], H0t[1][2], H0t[2][2], M0t[2][0], M0t[2][1], M0t[2][2]]]
    rhs = [sa.sneg(pn0[0]), sa.sneg(pn0[1]), sa.sneg(pn0[2]),
           sa.sneg(pf0[0]), sa.sneg(pf0[1]), sa.sneg(pf0[2])]
    a0 = sa.cholesky_solve(IA6, rhs)
    a0w, a0u = a0[:3], a0[3:]

    # pass 3: outward accelerations
    def accel(E, r, aw, au, cw, cu, Ua, Ul, d, uu, ax):
        aw_c, au_c = xform_motion(E, r, aw, au)
        aw_c, au_c = sa.vadd(aw_c, cw), sa.vadd(au_c, cu)
        qdd = (uu - sa.sdot(Ua, aw_c) - sa.sdot(Ul, au_c)) / d
        add = [0.0, 0.0, 0.0]
        add[ax] = qdd
        return sa.vadd(aw_c, add), au_c, qdd

    aw1, au1, qdd1 = accel(E1, C["HIP_R"], a0w, a0u, cw1, cu1,
                           U1a, U1l, d1, uu1, 0)
    aw2, au2, qdd2 = accel(E2, C["THIGH_R"], aw1, au1, cw2, cu2,
                           U2a, U2l, d2, uu2, 1)
    aw3, au3, qdd3 = accel(E3, _CALF_R, aw2, au2, cw3, cu3,
                           U3a, U3l, d3, uu3, 1)

    qdd = torch.stack([qdd1, qdd2, qdd3], dim=1).reshape(12, -1)
    return (a0w, a0u), qdd


# --- contact -----------------------------------------------------------------

def _point_contact(px, py, pz, vx, vy, vz, h_fn, radius, k, d, mu, vs,
                   cap=None):
    """Penalty normal + regularized Coulomb friction at sphere-tip points.

    Flat-normal approximation with finite-difference terrain normal;
    all inputs/outputs are (…,B) scalars; returns force components and
    penetration.
    """
    eps = 0.01
    h = h_fn(px, py)
    dhdx = (h_fn(px + eps, py) - h_fn(px - eps, py)) * (0.5 / eps)
    dhdy = (h_fn(px, py + eps) - h_fn(px, py - eps)) * (0.5 / eps)
    inv_n = torch.rsqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    nx, ny, nz = -dhdx * inv_n, -dhdy * inv_n, inv_n

    phi = h - (pz - radius)
    in_contact = phi > 0.0
    # Stair-edge regularization: cap the geometric penetration phi·nz so
    # an edge graze gives a bounded impulse.
    phi_c = torch.clamp(torch.clamp(phi, min=0.0) * nz, max=0.04)
    vn = vx * nx + vy * ny + vz * nz
    fn_mag = torch.clamp(k * phi_c - d * vn * in_contact, min=0.0)

    vtx, vty, vtz = vx - vn * nx, vy - vn * ny, vz - vn * nz
    inv_vt = torch.rsqrt(vtx * vtx + vty * vty + vtz * vtz + vs * vs)
    coef = mu * fn_mag * inv_vt          # N per (m/s) of slip
    if cap is not None:
        # Tangential impulse cap: friction may at most arrest the point
        # within one substep (coef ≤ m_eff/dt).
        coef = torch.clamp(coef, max=cap)
    ft = -coef
    fx = fn_mag * nx + ft * vtx
    fy = fn_mag * ny + ft * vty
    fz = fn_mag * nz + ft * vtz
    return fx, fy, fz, phi, in_contact


def compute_contacts(s: BQuadState, poses, vels, h_fn, p: BDynParams,
                     cfg: SimConfig):
    """Foot + knee + trunk contacts. Returns (BContact, foot_f, knee_f,
    base_f) with forces as smallalg world-frame Vec3s."""
    k, d = cfg.contact_stiffness, cfg.contact_damping
    mu = cfg.friction_coef * p.foot_friction
    vs = cfg.friction_vel_scale
    Rb = poses["Rb"]

    # world velocity of base origin / angular velocity
    wW = sa.mv(Rb, [s.w[0], s.w[1], s.w[2]])
    vW = sa.mv(Rb, [s.v[0], s.v[1], s.v[2]])

    # foot velocity from calf spatial velocity: v_f = R_c (u_c + w_c × r_f)
    def point_vel_from_spatial(R, w_loc, u_loc, r_loc):
        return sa.mv(R, sa.vadd(u_loc, sa.cross(w_loc, r_loc)))

    of, oc = poses["of"], poses["oc"]
    vf = point_vel_from_spatial(poses["Rc"], vels["w3"], vels["u3"], _FOOT_R)

    idt = 1.0 / cfg.substep_dt
    ffx, ffy, ffz, fphi, fcon = _point_contact(
        of[0], of[1], of[2], vf[0], vf[1], vf[2], h_fn,
        a1.FOOT_RADIUS, k, d, mu, vs,
        cap=cfg.friction_cap_mass_foot * idt)

    relk = sa.vsub(oc, poses["pos"])
    vk = sa.vadd(vW, sa.cross(wW, relk))
    kfx, kfy, kfz, kphi, _ = _point_contact(
        oc[0], oc[1], oc[2], vk[0], vk[1], vk[2], h_fn,
        0.02, 0.5 * k, 0.5 * d, mu, vs,
        cap=cfg.friction_cap_mass_knee * idt)

    bx, by = poses["pos"][0], poses["pos"][1]
    bz = poses["pos"][2] - dyn.TRUNK_HALF_HEIGHT
    bfx, bfy, bfz, bphi, _ = _point_contact(
        bx, by, bz, vW[0], vW[1], vW[2], h_fn, 0.0, k, d, mu, vs,
        cap=cfg.friction_cap_mass_base * idt)

    contact = BContact(
        foot_pos=torch.stack([of[i].expand_as(of[2]) for i in range(3)]),
        foot_contact=fcon,
        knee_contact=kphi > 0.0,
        base_contact=bphi > 0.0)
    return contact, [ffx, ffy, ffz], [kfx, kfy, kfz], [bfx, bfy, bfz]


# --- integration -------------------------------------------------------------

def integrate(s: BQuadState, a0, qdd, dt: float, cfg: SimConfig) -> BQuadState:
    """Semi-implicit Euler, batch-last; quaternion via exponential map."""
    a0w, a0u = a0
    mbv = cfg.max_base_velocity
    w_new = torch.stack([
        torch.clamp(s.w[i] + dt * a0w[i], -mbv, mbv) for i in range(3)])
    v_new = torch.stack([
        torch.clamp(s.v[i] + dt * a0u[i], -mbv, mbv) for i in range(3)])
    qd_new = torch.clamp(s.qd + dt * qdd, -cfg.max_joint_velocity,
                         cfg.max_joint_velocity)
    q_new = s.q + dt * qd_new

    Rb = quat_to_mat_cols(s.quat)
    v_w = sa.mv(Rb, [v_new[0], v_new[1], v_new[2]])
    pos_new = torch.stack([s.pos[i] + dt * v_w[i] for i in range(3)])

    # world angular velocity → exponential-map quaternion increment
    w_w = sa.mv(Rb, [w_new[0], w_new[1], w_new[2]])
    wx, wy, wz = w_w
    ang = torch.sqrt(wx * wx + wy * wy + wz * wz + 1e-16)
    half = 0.5 * ang * dt
    sc = torch.sin(half) / ang
    dqw, dqx, dqy, dqz = torch.cos(half), sc * wx, sc * wy, sc * wz
    qw, qx, qy, qz = s.quat[0], s.quat[1], s.quat[2], s.quat[3]
    nw = dqw * qw - dqx * qx - dqy * qy - dqz * qz
    nx = dqw * qx + dqx * qw + dqy * qz - dqz * qy
    ny = dqw * qy - dqx * qz + dqy * qw + dqz * qx
    nz = dqw * qz + dqx * qy - dqy * qx + dqz * qw
    inv_norm = torch.rsqrt(nw * nw + nx * nx + ny * ny + nz * nz)
    quat_new = torch.stack([nw * inv_norm, nx * inv_norm, ny * inv_norm,
                            nz * inv_norm])
    return BQuadState(pos=pos_new, quat=quat_new, w=w_new, v=v_new,
                      q=q_new, qd=qd_new)


# --- substep / control step --------------------------------------------------

def substep(rb: BRobot, cmd: torch.Tensor, p: BDynParams, cfg: SimConfig,
            h_fn, torque_mode: bool = False, inertias=None,
            qd_ref: torch.Tensor | None = None,
            tau_ff: torch.Tensor | None = None,
            q_pd: torch.Tensor | None = None,
            qd_pd: torch.Tensor | None = None) -> BRobot:
    """One physics substep: PD → contacts → ABA → integrate.

    `qd_ref`/`tau_ff` extend the PD law to the full HYBRID motor command
    τ = −kp(q−q*) − kd(q̇−q̇*) + τ_ff (laikago_motor.py:152-166); None ≡
    zero. `q_pd`/`qd_pd` override the PD input state (the pd_latency-
    delayed view); None ≡ the current state (pd_latency = 0)."""
    s = rb.s
    if torque_mode:
        tau = torch.clamp(cmd, -_TORQUE_LIMIT, _TORQUE_LIMIT)
    else:
        q_in = s.q if q_pd is None else q_pd
        qd_in = s.qd if qd_pd is None else qd_pd
        qd_err = qd_in if qd_ref is None else qd_in - qd_ref
        tau = -p.motor_kp * (q_in - cmd) - p.motor_kd * qd_err
        if tau_ff is not None:
            tau = tau + tau_ff
        tau = torch.clamp(tau, -_TORQUE_LIMIT, _TORQUE_LIMIT)

    poses = _chain_poses(s)
    vels = chain_velocities(s, poses)
    contact, foot_f, knee_f, base_f = compute_contacts(
        s, poses, vels, h_fn, p, cfg)
    a0, qdd = forward_dynamics(
        s, tau, foot_f, knee_f, base_f, p, poses, vels,
        inertias=inertias)
    s_new = integrate(s, a0, qdd, cfg.substep_dt, cfg)
    if cfg.on_rack:
        # on-rack debug mode (minitaur.py:106, 418): base welded in place
        s_new = s_new.replace(pos=s.pos, quat=s.quat,
                              w=torch.zeros_like(s.w), v=torch.zeros_like(s.v))
    return BRobot(
        s=s_new, last_action=rb.last_action, tau=tau, contact=contact,
        obs_hist=rb.obs_hist, hist_head=rb.hist_head)


def pd_delay_taps(cfg: SimConfig, hist_len: int):
    """Static interpolation taps for the pd_latency-delayed PD input.

    Returns None when pd_latency == 0 (PD acts on the current state), else
    (P, i0, i1, alpha): blend slots i0/i1 of a newest-first substep ring of
    ≥ P entries with weight alpha (_GetDelayedObservation:1182-1192)."""
    lat = float(cfg.pd_latency)
    if lat <= 0.0:
        return None
    f = lat / cfg.substep_dt
    i0 = int(np.floor(f))
    alpha = f - i0
    P = min(i0 + 2, hist_len)
    i0 = min(i0, P - 1)
    i1 = min(i0 + 1, P - 1)
    return P, i0, i1, float(alpha)


def _obs_row(s: BQuadState) -> torch.Tensor:
    """Substep snapshot row (OBS_ROW, B): [q | qd | quat | w]."""
    return torch.cat([s.q, s.qd, s.quat, s.w], dim=0)


def interp_weight(i: int, n: int) -> float:
    """Lerp weight t = (i+1)/n of substep i, divided in float32."""
    return float(np.float32(i + 1.0) / np.float32(n))


def control_step(rb: BRobot, action: torch.Tensor, p: BDynParams,
                 cfg: SimConfig, h_fn, torque_mode: bool = False,
                 qd_ref: torch.Tensor | None = None,
                 tau_ff: torch.Tensor | None = None) -> BRobot:
    """One control step (= action_repeat substeps with lerp interpolation;
    minitaur.Step:248-258 + ProcessAction:1384-1401), batched.

    `qd_ref`/`tau_ff` (12,B) enable the HYBRID motor law (held constant
    across the repeat window; only the position target is interpolated)."""
    prev = rb.last_action
    n = cfg.action_repeat
    inertias = build_inertias(p)
    L = rb.obs_hist.shape[0]
    # two ring regimes: L <= n (single-step ring, full overwrite of the
    # newest L rows) or L % n == 0 (long ring, contiguous block writes
    # never wrap)
    if not (L <= n or L % n == 0):
        raise ValueError(f"ring length {L} must be <= or a multiple of "
                         f"action_repeat {n}")
    taps = pd_delay_taps(cfg, L)
    # PD ring: newest-first (q, qd) substep snapshots carried over from
    # the previous control step (ring head == the current state).
    ph = pd_ring_seed(rb, taps) if taps else None
    rows = []
    for i in range(n):
        if cfg.enable_action_interpolation and not torque_mode:
            cmd = prev + interp_weight(i, n) * (action - prev)
        else:
            cmd = action
        q_pd = qd_pd = None
        if taps:
            _, i0, i1, alpha = taps
            row = (1.0 - alpha) * ph[i0] + alpha * ph[i1]    # (24,B)
            q_pd, qd_pd = row[:12], row[12:24]
        rb = substep(rb, cmd, p, cfg, h_fn, torque_mode, inertias,
                     qd_ref=qd_ref, tau_ff=tau_ff, q_pd=q_pd, qd_pd=qd_pd)
        row_new = _obs_row(rb.s)
        if taps:
            ph = torch.cat([row_new[None, :24], ph[:-1]], dim=0)
        rows.append(row_new)
    hist, head = ring_push(rb.obs_hist, rb.hist_head, torch.stack(rows))
    return rb.replace(last_action=action, obs_hist=hist, hist_head=head)


def ring_push(obs_hist: torch.Tensor, head: int, rows: torch.Tensor):
    """Write `rows` (S, OBS_ROW, B) after `head`; newest = last row.

    Returns a new ring tensor (the input is not modified) and the new
    head."""
    L, n = obs_hist.shape[0], rows.shape[0]
    if L <= n:
        # single-control-step ring: full overwrite with the newest L rows;
        # the snapshot stack IS the ring, head pinned at newest.
        return rows[n - L:], L - 1
    o = (head + 1) % L
    if o + n > L:
        raise ValueError(f"ring block write at {o} of {n} rows wraps L={L}")
    hist = obs_hist.clone()
    hist[o:o + n] = rows
    return hist, o + n - 1


def pd_ring_seed(rb: BRobot, taps) -> torch.Tensor:
    """Newest-first (P, 24, B) (q, qd) rows from the circular ring."""
    L = rb.obs_hist.shape[0]
    idx = [(rb.hist_head - k) % L for k in range(taps[0])]
    return rb.obs_hist[idx, :24]


def delayed_obs(rb: BRobot, latency: torch.Tensor, substep_dt: float,
                taps: int | None = None):
    """Per-env latency-interpolated (q, qd, quat, w) from the substep ring.

    The _GetDelayedObservation:1172-1193 linear blend, vectorized: hat-
    function weights at f = latency/substep_dt, one einsum. `taps` bounds
    how many newest ring slots the blend can reach (latency is clipped to
    (taps-1)·substep_dt)."""
    L = rb.obs_hist.shape[0]
    dev = rb.obs_hist.device
    if taps is None or taps >= L:
        f = torch.clamp(latency / substep_dt, 0.0, L - 1.001)      # (B,)
        # logical age of each PHYSICAL slot under the rolling head
        ages = torch.tensor([float((rb.hist_head - k) % L) for k in range(L)],
                            dtype=F32, device=dev)[:, None]
        wgt = torch.clamp(1.0 - torch.abs(ages - f[None, :]), min=0.0)
        ob = torch.einsum("lb,ljb->jb", wgt, rb.obs_hist)          # (OBS_ROW,B)
        return ob[:12], ob[12:24], ob[24:28], ob[28:31]
    T = taps
    f = torch.clamp(latency / substep_dt, 0.0, T - 1.001)           # (B,)
    idx = [(rb.hist_head - k) % L for k in range(T)]                # newest-first
    sub = rb.obs_hist[idx]                                          # (T,OBS_ROW,B)
    ages = torch.arange(T, dtype=F32, device=dev)[:, None]
    wgt = torch.clamp(1.0 - torch.abs(ages - f[None, :]), min=0.0)  # (T,B)
    ob = torch.einsum("tb,tjb->jb", wgt, sub)
    return ob[:12], ob[12:24], ob[24:28], ob[28:31]


def init_robot(B: int, height, q0=None, hist_len: int = SUB_HIST_LEN,
               device: torch.device | str = "cpu") -> BRobot:
    """Standing-start batched robot. `height` is scalar or (B,)."""
    q_init = torch.as_tensor(
        np.asarray(a1.INIT_MOTOR_ANGLES if q0 is None else q0, np.float32),
        device=device)
    q = q_init[:, None].repeat(1, B)
    h = torch.as_tensor(height, dtype=F32, device=device).expand(B)
    z = torch.zeros((B,), dtype=F32, device=device)
    pos = torch.stack([z, z, h])
    quat = torch.cat([torch.ones((1, B), dtype=F32, device=device),
                      torch.zeros((3, B), dtype=F32, device=device)])
    s = BQuadState(pos=pos, quat=quat,
                   w=torch.zeros((3, B), dtype=F32, device=device),
                   v=torch.zeros((3, B), dtype=F32, device=device), q=q,
                   qd=torch.zeros((12, B), dtype=F32, device=device))
    contact = BContact(
        foot_pos=torch.zeros((3, 4, B), dtype=F32, device=device),
        foot_contact=torch.zeros((4, B), dtype=torch.bool, device=device),
        knee_contact=torch.zeros((4, B), dtype=torch.bool, device=device),
        base_contact=torch.zeros((B,), dtype=torch.bool, device=device))
    hist = _obs_row(s)[None].repeat(hist_len, 1, 1)
    return BRobot(s=s, last_action=q.clone(),
                  tau=torch.zeros((12, B), dtype=F32, device=device),
                  contact=contact, obs_hist=hist, hist_head=hist_len - 1)
