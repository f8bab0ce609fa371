"""Soft (penalty / regularized-Coulomb) contact model of the per-env path
(port of the JAX package's ``sim/contact.py``): spring-damper normal forces
and smooth Coulomb friction at the 4 foot spheres, the 4 knee points and
the trunk underside, branch-free so that it runs under
``torch.func.vmap``."""

from __future__ import annotations

import torch

from paddlerobotics_torch.core import math3d
from paddlerobotics_torch.core.config import SimConfig
from paddlerobotics_torch.core.types import ContactState, QuadState
from paddlerobotics_torch.sim import a1_model as a1
from paddlerobotics_torch.sim import dynamics, terrain
from paddlerobotics_torch.sim.dynamics import DynamicsParams


def _point_forces(pos, vel, h_fn, radius, k, d, mu, vs, cap=None):
    """Penalty contact force for sphere-tip points: pos, vel (...,3) world;
    the sphere's lowest point is z − radius. Returns (force (...,3),
    penetration (...,), in contact (...,))."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    h, n = terrain.height_and_normal(h_fn, x, y)
    phi = h - (z - radius)                      # >0 ⇒ penetrating
    in_contact = phi > 0.0
    # stair-edge regularization (see sbatch._point_contact): project the
    # vertical gap onto the surface normal and cap it
    phi_c = torch.clamp(torch.clamp(phi, min=0.0) * n[..., 2], max=0.04)

    vn = torch.sum(vel * n, dim=-1)
    f_n_mag = torch.clamp(k * phi_c - d * vn * (phi_c > 0), min=0.0)
    f_n = f_n_mag[..., None] * n

    vt = vel - vn[..., None] * n
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + vs * vs)
    coef = mu * f_n_mag / vt_norm
    if cap is not None:
        # tangential impulse cap (see sbatch._point_contact)
        coef = torch.clamp(coef, max=cap)
    f_t = -coef[..., None] * vt
    return f_n + f_t, phi, in_contact


def compute_contacts(state: QuadState, poses, h_fn,
                     params: DynamicsParams, cfg: SimConfig):
    """All contact forces and the ContactState of one env.

    Returns (contact_state, foot_forces_w (4,3), knee_forces_w (4,3),
    base_force_w (3,))."""
    k = cfg.contact_stiffness
    d = cfg.contact_damping
    mu = cfg.friction_coef * params.foot_friction
    vs = cfg.friction_vel_scale

    idt = 1.0 / cfg.substep_dt
    foot_pos = poses["o_foot"]
    foot_vel = dynamics.foot_world_velocities(state, poses)
    foot_f, foot_phi, foot_contact = _point_forces(
        foot_pos, foot_vel, h_fn, a1.FOOT_RADIUS, k, d, mu, vs,
        cap=cfg.friction_cap_mass_foot * idt)

    # Knee (calf origin) contact: normal penalty only, lower stiffness
    # (the reference's "bad foot" contacts).
    knee_pos = poses["o_calf"]
    R_b = poses["R_base"]
    w_w = dynamics._mv(R_b, state.base_ang_vel)
    v_w = dynamics._mv(R_b, state.base_lin_vel)
    knee_vel = v_w + math3d.cross(w_w, knee_pos - state.base_pos)
    knee_f, knee_phi, _ = _point_forces(
        knee_pos, knee_vel, h_fn, 0.02, 0.5 * k, 0.5 * d, mu, vs,
        cap=cfg.friction_cap_mass_knee * idt)

    # Trunk underside contact (one point under the base origin).
    base_low = state.base_pos - a1._c(
        [0.0, 0.0, dynamics.TRUNK_HALF_HEIGHT], state.base_pos)
    base_f, base_phi, _ = _point_forces(
        base_low[None, :], v_w[None, :], h_fn, 0.0, k, d, mu, vs,
        cap=cfg.friction_cap_mass_base * idt)

    contact_state = ContactState(
        foot_pos=foot_pos, foot_vel=foot_vel, forces=foot_f,
        penetration=foot_phi, in_contact=foot_contact,
        knee_penetration=knee_phi, base_penetration=base_phi[0])
    return contact_state, foot_f, knee_f, base_f[0]
