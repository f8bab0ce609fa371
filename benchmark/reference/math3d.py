"""3D rotation and rigid-transform math on tensors (port of the JAX
package's ``core/math3d.py``).

Quaternions are ``wxyz`` (scalar first). Every function broadcasts over
leading batch dimensions and runs under ``torch.func.vmap``; ``cross`` is
written out by components because ``torch.linalg.cross`` refuses operands
of different ranks under vmap.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis (3), broadcasting the rest."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_identity(device=None) -> torch.Tensor:
    """Identity rotation quaternion (w, x, y, z)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (both wxyz)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q: R(q) @ v (two cross products)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q: R(q)^T @ v."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → 3×3 rotation matrix (acts on column vectors)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3×3 rotation matrix → quaternion (wxyz), branch-free (Shepperd): all
    four candidates, the one with the largest pivot selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _stack(w, x, y, z):
        return torch.stack([w, x, y, z], dim=-1)

    qw = _stack(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    qx = _stack(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy = _stack(m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21)
    qz = _stack(m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22)

    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                         dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def quat_from_euler(rpy: torch.Tensor) -> torch.Tensor:
    """XYZ-intrinsic (roll, pitch, yaw) → quaternion (PyBullet's
    ``getQuaternionFromEuler`` convention)."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → (roll, pitch, yaw), PyBullet's Euler convention."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """Integrate orientation by a world-frame angular velocity over dt with
    the exponential map (exact for constant ω)."""
    angle = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * angle * dt
    # sinc-safe axis scaling: sin(half)/angle * omega
    small = angle < 1e-8
    k = torch.where(small, torch.full_like(angle, 0.5 * dt),
                    torch.sin(half) / torch.where(small,
                                                  torch.ones_like(angle),
                                                  angle))
    dq = torch.cat([torch.cos(half), k * omega_world], dim=-1)
    return quat_normalize(quat_mul(dq, q))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Vector → skew-symmetric cross-product matrix [v]×."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    m = torch.stack([zeros, -z, y,
                     z, zeros, -x,
                     -y, x, zeros], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _rot(theta: torch.Tensor, rows) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    vals = {"c": c, "s": s, "-s": -s, "o": o, "z": z}
    m = torch.stack([vals[k] for k in rows], dim=-1)
    return m.reshape(theta.shape + (3, 3))


def rot_x(theta: torch.Tensor) -> torch.Tensor:
    return _rot(theta, ("o", "z", "z", "z", "c", "-s", "z", "s", "c"))


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    return _rot(theta, ("c", "z", "s", "z", "o", "z", "-s", "z", "c"))


def rot_z(theta: torch.Tensor) -> torch.Tensor:
    return _rot(theta, ("c", "-s", "z", "s", "c", "z", "z", "z", "o"))
