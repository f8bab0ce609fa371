"""Open-loop Bezier gait generator (PyTorch port of the JAX package's
``deploy/bezier.py``).

Rebuild of deployment/utilities/Bezier.py (BezierGait: 12-control-point
Bernstein swing + sinusoidal stance from the MIT Cheetah gait work,
per-leg phase lags with a touchdown-reset stride clock, yaw-circle
correction) and SpotOL.py (BezierStepper: ramping state machine for
StepLength / StepVelocity / YawRate). The clock state is a ``BezierState``
NamedTuple of tensors, as in the JAX package.

Leg order here follows the gait generator's convention FL, FR, BL, BR
with default phase lags (0, 0.5, 0.5, 0) — a trot.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from paddlerobotics_torch.core.device import resolve_device

NUM_CTRL = 11  # Bezier degree (12 points)

# Swing control-point templates (scaled by step length L and clearance):
# forward component ×L, vertical ×clearance (Bezier.py:224-266 constants,
# which themselves come from the published MIT Cheetah trajectory).
_STEP_X = np.array([-1.0, -1.4, -1.5, -1.5, -1.5, 0.0, 0.0, 0.0,
                    1.5, 1.5, 1.4, 1.0])
_STEP_Z = np.array([0.0, 0.0, 0.9, 0.9, 0.9, 0.9, 0.9, 1.1, 1.1, 1.1,
                    0.0, 0.0])
_BINOM = np.array([math.comb(NUM_CTRL, k) for k in range(NUM_CTRL + 1)])

DEFAULT_PHASE_LAGS = np.array([0.0, 0.5, 0.5, 0.0])  # FL, FR, BL, BR trot


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


class BezierState(NamedTuple):
    time: torch.Tensor               # ()
    td_time: torch.Tensor            # () last reference-leg touchdown
    sw_ref: torch.Tensor             # () reference-leg swing phase
    prev_foot: torch.Tensor          # (4,3) previous foot targets


def init_state(device=None) -> BezierState:
    dev = resolve_device(device)
    z = torch.zeros((), device=dev)
    return BezierState(time=z, td_time=z, sw_ref=z,
                       prev_foot=torch.zeros((4, 3), device=dev))


def bernstein_sum(phase: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Σ_k points[k]·C(n,k)·φᵏ(1−φ)ⁿ⁻ᵏ, batched over trailing dims."""
    k = torch.arange(NUM_CTRL + 1, device=phase.device)
    basis = _f32(_BINOM, phase) * phase[..., None] ** k * \
        (1.0 - phase[..., None]) ** (NUM_CTRL - k)
    return torch.sum(basis * points, dim=-1)


def bezier_swing(phase, L, lateral_fraction, clearance_height):
    """Swing-foot delta (x,y,z) (Bezier.py:211-279). L/lateral_fraction
    may be scalars or per-leg tensors broadcasting against ``phase``."""
    lateral_fraction = _f32(lateral_fraction, phase)
    xp, yp = torch.cos(lateral_fraction), torch.sin(lateral_fraction)
    pts = _f32(L, phase)[..., None] * _f32(_STEP_X, phase)
    step = bernstein_sum(phase, pts)
    zpts = _f32(clearance_height, phase)[..., None] * _f32(_STEP_Z, phase)
    z = bernstein_sum(phase, zpts)
    return step * xp, step * yp, z


def sine_stance(phase, L, lateral_fraction, penetration_depth):
    """Stance-foot delta: linear drag-back + cosine penetration
    (Bezier.py:281-305)."""
    L = _f32(L, phase)
    lateral_fraction = _f32(lateral_fraction, phase)
    xp, yp = torch.cos(lateral_fraction), torch.sin(lateral_fraction)
    step = L * (1.0 - 2.0 * phase)
    sx, sy = step * xp, step * yp
    z = torch.where(torch.abs(L) > 1e-8,
                    -penetration_depth * torch.cos(
                        (math.pi * (sx + sy)) / (2.0 * L + 1e-12)),
                    0.0)
    return sx, sy, z


def leg_phase(t_since_td, lag, t_stance, t_swing):
    """Per-leg (phase, is_swing) from the shared stride clock
    (Bezier.py:77-134 logic, branch-free)."""
    t_stride = t_stance + t_swing
    ti = t_since_td - lag * t_stride
    ti = torch.where(ti < -t_swing, ti + t_stride, ti)
    in_stance = (ti >= 0.0) & (ti <= t_stance)
    stance_phase = torch.where(t_stance > 0,
                               ti / torch.clamp(t_stance, min=1e-8), 0.0)
    swing_phase = torch.where(ti < 0.0, (ti + t_swing) / t_swing,
                              (ti - t_stance) / t_swing)
    swing_phase = torch.clamp(swing_phase, 0.0, 1.0)
    phase = torch.where(in_stance, torch.clamp(stance_phase, 0.0, 1.0),
                        swing_phase)
    return phase, ~in_stance


def generate_trajectory(state: BezierState, default_feet: torch.Tensor,
                        step_length, lateral_fraction, yaw_rate,
                        step_velocity, clearance_height=0.05,
                        penetration_depth=0.01, dt: float = 0.01,
                        t_swing: float = 0.2,
                        phase_lags=DEFAULT_PHASE_LAGS
                        ) -> Tuple[torch.Tensor, BezierState]:
    """One gait tick → foot targets (4,3) in the base frame + next state.

    BezierGait.GenerateTrajectoryX (Bezier.py:530-612): per-leg linear
    swing/stance deltas plus the yaw-circle rotational component, applied
    about each default foot."""
    like = state.time
    step_length, lateral_fraction, yaw_rate, step_velocity = (
        _f32(x, like) for x in (step_length, lateral_fraction, yaw_rate,
                                step_velocity))
    default_feet = _f32(default_feet, like)
    L = step_length / 2.0
    t_stance = torch.where(torch.abs(step_velocity) > 1e-3,
                           2.0 * torch.abs(L) / torch.clamp(
                               torch.abs(step_velocity), min=1e-3),
                           0.0)
    t_stance = torch.clamp(t_stance, 0.0, 1.25 * t_swing)
    t_stride = t_stance + t_swing

    # stride clock with touchdown reset on the reference leg
    t_since = torch.minimum(torch.clamp(state.time - state.td_time, min=0.0),
                            t_stride)
    phases, is_swing = leg_phase(t_since, _f32(phase_lags, like),
                                 t_stance, t_swing)       # (4,), (4,)

    # linear component
    lx_sw, ly_sw, lz_sw = bezier_swing(phases, L, lateral_fraction,
                                       clearance_height)
    lx_st, ly_st, lz_st = sine_stance(phases, L, lateral_fraction,
                                      penetration_depth)
    lx = torch.where(is_swing, lx_sw, lx_st)
    ly = torch.where(is_swing, ly_sw, ly_st)
    lz = torch.where(is_swing, lz_sw, lz_st)

    # yaw-circle rotational component (Bezier.py:306-395): each foot
    # traces a tangent to the circle about the body center.
    fx, fy = default_feet[:, 0], default_feet[:, 1]
    mag = torch.sqrt(fx ** 2 + fy ** 2)
    direction = torch.atan2(fy, fx)
    g = state.prev_foot - default_feet
    g_mag = torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2)
    th_mod = torch.atan2(g_mag, mag)
    # FR(1)/BL(2) get +direction, FL(0)/BR(3) −direction
    sign = _f32([-1.0, 1.0, 1.0, -1.0], like)
    phi_arc = math.pi / 2.0 + sign * direction + th_mod
    yaw_L = yaw_rate * mag / 2.0
    rx_sw, ry_sw, rz_sw = bezier_swing(phases, yaw_L, phi_arc,
                                       clearance_height)
    rx_st, ry_st, rz_st = sine_stance(phases, yaw_L, phi_arc,
                                      penetration_depth)
    rx = torch.where(is_swing, rx_sw, rx_st)
    ry = torch.where(is_swing, ry_sw, ry_st)
    rz = torch.where(is_swing, rz_sw, rz_st)

    feet = default_feet + torch.stack([lx + rx, ly + ry, lz + rz], dim=-1)

    # clock update: reference leg (0) touchdown resets the stride clock
    ref_phase = phases[0]
    ref_swing = is_swing[0]
    td = ref_swing & (ref_phase >= 0.999)
    new_state = BezierState(
        time=state.time + dt,
        td_time=torch.where(td, state.time, state.td_time),
        sw_ref=torch.where(ref_swing, ref_phase, state.sw_ref),
        prev_foot=feet)
    return feet, new_state


class StepperState(NamedTuple):
    """Ramping command state (SpotOL.py BezierStepper:23-258)."""

    step_length: torch.Tensor
    step_velocity: torch.Tensor
    yaw_rate: torch.Tensor
    lateral_fraction: torch.Tensor


STEP_LENGTH_LIMITS = (-0.05, 0.05)
STEP_VELOCITY_LIMITS = (0.001, 3.0)
YAW_RATE_LIMITS = (-2.0, 2.0)
LATERAL_FRACTION_LIMITS = (-np.pi / 2.0, np.pi / 2.0)


def stepper_init(device=None) -> StepperState:
    dev = resolve_device(device)
    z = torch.zeros((), device=dev)
    return StepperState(z, torch.tensor(0.001, device=dev), z, z)


def stepper_ramp(state: StepperState, target_length, target_velocity,
                 target_yaw=0.0, target_lateral=0.0,
                 ramp: float = 0.05) -> StepperState:
    """Ramp commands toward targets with rate limits (the FSM's
    move-toward behavior, SpotOL.py:150-258), then clip to limits."""
    def toward(cur, tgt):
        return cur + torch.clamp(_f32(tgt, cur) - cur, -ramp, ramp)

    return StepperState(
        step_length=torch.clamp(toward(state.step_length, target_length),
                                *STEP_LENGTH_LIMITS),
        step_velocity=torch.clamp(toward(state.step_velocity,
                                         target_velocity),
                                  *STEP_VELOCITY_LIMITS),
        yaw_rate=torch.clamp(toward(state.yaw_rate, target_yaw),
                             *YAW_RATE_LIMITS),
        lateral_fraction=torch.clamp(toward(state.lateral_fraction,
                                            target_lateral),
                                     *LATERAL_FRACTION_LIMITS))
