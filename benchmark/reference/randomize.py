"""Domain randomization: normalized params → batched physical params.

Port of the JAX package's ``envs/randomize.py``. ``param2dynamic``
reproduces the reference's mapping (ETGRL/train.py:112-126): a [-1,1]⁴⁸
vector becomes control latency 0–80 ms, foot friction 0–20, base mass
0.5–3×, base/leg inertia scales 0.1–3×, motor kp 20–200 / kd 0–5 and a
gravity perturbation. These work on the whole batch at once and produce
batch-minor ``BDynParams`` directly; ``sample_dynamics_env`` and
``dynamics_to_normalized_env`` are the per-env path's forms (one env's
``DynamicsParams``, under ``torch.func.vmap`` for a batch).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.dynamics import DynamicsParams
from benchmark.reference.sbatch import BDynParams, F32

NUM_DYNAMIC_PARAMS = 48


def _col(vals, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vals, np.float32), device=device)[:, None]


def param2dynamic(params: torch.Tensor) -> BDynParams:
    """(48,B) or (45,B) normalized [-1,1] vectors → BDynParams."""
    dev = params.device
    B = params.shape[-1]
    p = torch.clamp(params, -1.0, 1.0)
    latency_ms = torch.clamp(40.0 + 10.0 * p[0], 0.0, 80.0)
    friction = torch.clamp(0.2 + 10.0 * p[1], 0.0, 20.0)
    basemass = torch.clamp(1.5 + 1.0 * p[2], 0.5, 3.0)
    baseinertia = torch.clamp(1.0 + p[3:6], 0.1, 3.0)
    legmass = torch.clamp(1.0 + p[6:9], 0.1, 3.0)
    leginertia = torch.clamp(1.0 + p[9:21], 0.1, 3.0).reshape(4, 3, B)
    kp = torch.clamp(80.0 + 40.0 * p[21:33], 20.0, 200.0)
    kd_base = _col([1.0, 2.0, 2.0] * 4, dev)
    kd = torch.clamp(kd_base + p[33:45] * kd_base, 0.0, 5.0)
    if params.shape[0] > 45:
        gravity = torch.minimum(torch.maximum(
            _col([0.0, 0.0, -10.0], dev) + p[45:48] * _col([2.0, 2.0, 10.0], dev),
            _col([-5.0, -5.0, -20.0], dev)), _col([5.0, 5.0, -4.0], dev))
    else:
        gravity = _col([0.0, 0.0, -9.8], dev).repeat(1, B)
    # "basemass" acts as a scale on chassis mass; friction multiplies the
    # reference's default lateral friction coefficient (0.6).
    return BDynParams(
        base_mass_scale=basemass / 1.5,
        base_inertia_scale=baseinertia,
        leg_mass_scale=legmass,
        leg_inertia_scale=leginertia,
        motor_kp=kp,
        motor_kd=kd,
        foot_friction=friction / 0.6,
        control_latency=latency_ms / 1000.0,
        gravity=gravity,
        external_force=torch.zeros((3, B), dtype=F32, device=dev),
    )


def sample_dynamics(B: int, generator: torch.Generator | None = None,
                    scale: float | torch.Tensor = 1.0, jitter: bool = False,
                    u: torch.Tensor | None = None,
                    jitter_u: torch.Tensor | None = None,
                    device: torch.device | str = "cpu") -> BDynParams:
    """Sample randomized dynamics for B envs (Random_Param_Dict
    ['random_dynamics']): the physical interpolation between the nominal
    dynamics at scale 0 and a full reference draw at scale 1.

    `u` is an optional pre-drawn (B, 48) uniform [-1, 1) array and
    `jitter_u` an optional (B,) uniform [0, 1) array, so a caller can
    inject another generator's draws; otherwise both come from
    `generator`. With `jitter`, each env's scale is scale·U(0, 1)."""
    if u is None:
        u = torch.rand((B, NUM_DYNAMIC_PARAMS), generator=generator,
                       device=device) * 2.0 - 1.0
    u = torch.as_tensor(u, dtype=F32, device=device)
    scale = torch.as_tensor(scale, dtype=F32, device=device)
    if jitter:
        if jitter_u is None:
            jitter_u = torch.rand((B,), generator=generator, device=device)
        scale = scale * torch.as_tensor(jitter_u, dtype=F32, device=device)
    drawn = param2dynamic(u.T)
    nominal = BDynParams.default(B, device=device)
    return BDynParams(*[d + scale * (r - d) for d, r in zip(nominal, drawn)])


def sample_push_force(generator: torch.Generator | None, max_force: float,
                      normal: torch.Tensor | None = None,
                      uniform: torch.Tensor | None = None,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """A random horizontal push on the trunk (Random_Param_Dict
    ['random_force']), (3,): a unit direction from a (2,) standard normal
    draw and a magnitude ``uniform · max_force`` from a () uniform one; the
    draws come from ``generator`` unless given."""
    if normal is None:
        normal = torch.randn((2,), generator=generator, device=device)
    if uniform is None:
        uniform = torch.rand((), generator=generator, device=device)
    d = torch.as_tensor(normal, dtype=F32, device=device)
    d = d / (torch.linalg.norm(d) + 1e-6)
    mag = torch.as_tensor(uniform, dtype=F32, device=device) * max_force
    return torch.cat([mag * d, torch.zeros(1, device=device)])


def dynamics_to_normalized(dyn: BDynParams) -> torch.Tensor:
    """Invert `param2dynamic`: batch-minor physical params → the normalized
    [-1,1]⁴⁸ echo (the SENSOR_MODE["dynamic_vec"] observation), (48, B).
    Exact wherever the forward map didn't clip; clipped coordinates
    saturate at ±1."""
    dev = dyn.motor_kp.device
    B = dyn.motor_kp.shape[-1]
    kd_base = _col([1.0, 2.0, 2.0] * 4, dev)
    rows = [
        ((dyn.control_latency * 1000.0 - 40.0) / 10.0)[None],
        ((dyn.foot_friction * 0.6 - 0.2) / 10.0)[None],
        (dyn.base_mass_scale * 1.5 - 1.5)[None],
        dyn.base_inertia_scale - 1.0,
        dyn.leg_mass_scale - 1.0,
        dyn.leg_inertia_scale.reshape(12, B) - 1.0,
        (dyn.motor_kp - 80.0) / 40.0,
        (dyn.motor_kd - kd_base) / kd_base,
        (dyn.gravity - _col([0.0, 0.0, -10.0], dev)) / _col([2.0, 2.0, 10.0], dev),
    ]
    return torch.clamp(torch.cat(rows, dim=0), -1.0, 1.0)


def sample_dynamics_env(u: torch.Tensor, jitter_u: torch.Tensor,
                        scale: float = 1.0,
                        jitter: bool = False) -> DynamicsParams:
    """One env's randomized dynamics from its pre-drawn uniforms: ``u``
    (48,) in [-1, 1) and ``jitter_u`` () in [0, 1) (used with ``jitter``),
    the physical interpolation between the nominal dynamics at scale 0 and
    the reference draw at scale 1, as ``sample_dynamics``."""
    s = scale * jitter_u if jitter else torch.as_tensor(
        scale, dtype=F32, device=u.device)
    drawn = DynamicsParams.from_batched(param2dynamic(u[:, None]))
    nominal = DynamicsParams.default(device=u.device)
    return DynamicsParams(*[d + s * (r - d) for d, r in zip(nominal, drawn)])


def dynamics_to_normalized_env(dyn: DynamicsParams) -> torch.Tensor:
    """``dynamics_to_normalized`` of one env's ``DynamicsParams``, (48,)."""
    return dynamics_to_normalized(dyn.batched())[:, 0]
