"""The batched env's ETG joint residual: hand-written CUDA kernel, wrapper and
plain version.

``etg_residual(etg_w, etg_b, step_idx, k)`` computes, for the ETG readout
``etg_w`` (3, H, B), ``etg_b`` (3, B) and the step index ``step_idx`` (B,)
int32, under an env's constants ``k`` (``Consts``): the phase features
V(t) and V(t + T/2) (H, B), the readout's foot offsets of each leg's phase
group, the leg IK of the feet, and returns ``(etg_act (12, B), swing (4, B),
stance (4, B), v_a (H, B))``, the joint residual from the standing pose, the
swing and stance masks of each foot and V(t). It dispatches on the device
of ``etg_w``:

- CPU tensors run ``plain``, the PyTorch composition itself (so the CPU
  path is what it was, bit for bit, gradients included);
- CUDA tensors launch the kernel in ``ops/csrc/etg_residual.cu`` (one
  launch a call: the composition's operations on the card rounded as they
  are, the readout summed in the order cuBLAS's batched GEMV takes at the
  env's shapes, so bit-equal to the composition where cuBLAS splits the
  sum as there) or raise. There is no fallback: the kernel has no
  backward, so a call under grad mode with an input that requires grad
  raises.

The kernel takes contiguous float32 inputs (``step_idx`` int32) and H up to
``MAX_H``; the wrapper raises on anything else. It is built at first use
through ``ops/build.py``. ``etg_residual.launches`` counts kernel launches
(the plain version's calls do not count), and each launch adds 1 to the
profiler's ``etg_launches`` counter while spans are on and no capture is
under way (``envs/step_graph`` adds a replay's launches). Under
``utils/profiler``'s NaN checks the wrapper checks the kernel's floating
outputs and raises ``FloatingPointError`` naming ``etg_residual``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import pathlib

import numpy as np
import torch

from paddlerobotics_torch.core.config import ETGConfig
from paddlerobotics_torch.sim import a1_model as a1
from paddlerobotics_torch.utils import profiler

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "etg_residual.cu"
MAX_H = 64
SWING_Z = 0.02          # a foot above this offset swings
STANCE_Z = 0.005        # at or below this one it stands
# the kernel's Scalars, in order, and a leg's floats in its constant buffer
SCALARS = ("dt", "w1", "ph1", "w2", "ph2", "amp", "half_t", "inv_sigma_sq",
           "l_low_sq", "l_up_sq", "inv_2_l_low_up", "l_sq_sum",
           "two_l_up_low", "sq_min", "swing_z", "stance_z")
LEG_FIELDS = ("sel_a", "stx", "lat", "fx0", "fy0", "fz0", "l_hip",
              "q0_ab", "q0_hip", "q0_knee")

_lib = None
_launch = None                      # prt_etg_residual, argtypes bound once
build_info: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Consts:
    """An env's ETG constants, as the kernel reads them (``pack``): the
    RBF centers, each leg's floats (a row of ``legs``, its columns
    ``LEG_FIELDS``) and the composition's Python floats (``scalars``)."""

    etg: ETGConfig
    centers: torch.Tensor            # (H, 2) RBF centers
    legs: torch.Tensor               # (4, len(LEG_FIELDS)) float32
    scalars: np.ndarray              # (len(SCALARS),) float32, host

    @classmethod
    def pack(cls, etg: ETGConfig, centers, sel_a, stx, lat, feet, hips,
             l_hip, q0) -> "Consts":
        """The constants from the oscillator's (4, 1) columns (``sel_a``
        bool: the leg is in group a; ``feet`` and ``hips`` three columns
        each) and ``q0`` (12, 1): each leg's floats, its foot-minus-hip
        position by the composition's own subtraction, and each Python
        float of the composition rounded to float32 as PyTorch rounds a
        scalar operand (a division by one as a product by its float32
        reciprocal, as PyTorch's CUDA division by a CPU scalar)."""
        f = np.float32
        legs = torch.cat([sel_a.to(torch.float32), stx, lat,
                          *(feet[i] - hips[i] for i in range(3)), l_hip,
                          q0.reshape(4, 3)], dim=1).contiguous()
        l_up = l_low = a1.L_UP
        vals = {"dt": etg.dt, "w1": 2 * math.pi / etg.T, "ph1": etg.phase[0],
                "w2": 2 * math.pi / etg.T2, "ph2": etg.phase[1],
                "amp": etg.amp, "half_t": etg.T / 2,
                "inv_sigma_sq": f(1.0) / f(etg.sigma_sq),
                "l_low_sq": l_low ** 2, "l_up_sq": l_up ** 2,
                "inv_2_l_low_up": f(1.0) / f(2 * l_low * l_up),
                "l_sq_sum": l_up ** 2 + l_low ** 2,
                "two_l_up_low": 2 * l_up * l_low, "sq_min": 1e-12,
                "swing_z": SWING_Z, "stance_z": STANCE_Z}
        scalars = np.array([f(vals[k]) for k in SCALARS], np.float32)
        return cls(etg=etg, centers=centers, legs=legs, scalars=scalars)

    def col(self, name: str) -> torch.Tensor:
        """Leg field ``name`` (``LEG_FIELDS``) as a (4, 1) column."""
        i = LEG_FIELDS.index(name)
        return self.legs[:, i:i + 1]

    @property
    def sel_a(self) -> torch.Tensor:
        """(4, 1) bool: the leg is in phase group a."""
        return self.col("sel_a") != 0


# --- the plain version -------------------------------------------------------

def soa_ik(fx, fy, fz, l_hip):
    """SoA leg IK: foot position in hip frame (4,B) comps → angles (4,B)×3.

    Same closed form as a1.py:97-110, componentwise; `l_hip` is the
    signed (4,1) hip offset."""
    l_up = l_low = a1.L_UP
    d2 = fx * fx + fy * fy + fz * fz
    cos_knee = (d2 - l_hip * l_hip - l_low ** 2 - l_up ** 2) / (2 * l_low * l_up)
    theta_knee = -torch.acos(torch.clamp(cos_knee, -1.0, 1.0))
    l = torch.sqrt(torch.clamp(
        l_up ** 2 + l_low ** 2 + 2 * l_up * l_low * torch.cos(theta_knee),
        min=1e-12))
    theta_hip = torch.asin(torch.clamp(-fx / l, -1.0, 1.0)) - theta_knee * 0.5
    c_eff = torch.cos(theta_hip + theta_knee * 0.5)
    c1 = l_hip * fy - l * c_eff * fz
    s1 = l * c_eff * fy + l_hip * fz
    theta_ab = torch.atan2(s1, c1)
    return theta_ab, theta_hip, theta_knee


def phase_features(k: Consts, t: torch.Tensor) -> torch.Tensor:
    """V(t) for per-env times t (B,) → (H,B)."""
    cfg = k.etg
    p1 = cfg.amp * torch.sin(2 * math.pi / cfg.T * t + cfg.phase[0])
    p2 = cfg.amp * torch.sin(2 * math.pi / cfg.T2 * t + cfg.phase[1])
    u = k.centers  # (H,2)
    d2 = (p1[None, :] - u[:, 0:1]) ** 2 + (p2[None, :] - u[:, 1:2]) ** 2
    return torch.exp(-d2 / cfg.sigma_sq)


def plain(etg_w, etg_b, step_idx, k: Consts):
    """The kernel's function in PyTorch operations: ETG joint residual
    (12,B), swing/stance masks (4,B), V(t)."""
    t = step_idx.to(torch.float32) * k.etg.dt
    v_a = phase_features(k, t)                          # (H,B)
    v_b = phase_features(k, t + k.etg.T / 2)
    # readout: delta[x] = Σ_h w[x,h]·V[h] + b[x]
    d_a = torch.einsum("xhb,hb->xb", etg_w, v_a) + etg_b   # (3,B)
    d_b = torch.einsum("xhb,hb->xb", etg_w, v_b) + etg_b
    sel = k.sel_a
    dx = torch.where(sel, d_a[0][None, :], d_b[0][None, :]) + k.col("stx")
    dy = torch.where(sel, d_a[1][None, :], d_b[1][None, :]) + k.col("lat")
    dz = torch.where(sel, d_a[2][None, :], d_b[2][None, :])
    fx = k.col("fx0") + dx              # foot minus hip, packed as such
    fy = k.col("fy0") + dy
    fz = k.col("fz0") + dz
    t_ab, t_hip, t_knee = soa_ik(fx, fy, fz, k.col("l_hip"))
    q = torch.stack([t_ab, t_hip, t_knee], dim=1).reshape(12, -1)
    etg_act = q - k.legs[:, 7:].reshape(12, 1)          # q0_ab..q0_knee
    swing = dz > SWING_Z
    stance = dz <= STANCE_Z
    return etg_act, swing, stance, v_a


# --- the kernel ----------------------------------------------------------------

def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _launch
    if _lib is not None:
        return _lib
    from paddlerobotics_torch.ops import build as kbuild

    lib, info = kbuild.build_library("etg_residual", SOURCE)
    fn = lib.prt_etg_residual
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    lib.prt_etg_residual_error_string.argtypes = [ctypes.c_int]
    lib.prt_etg_residual_error_string.restype = ctypes.c_char_p
    lib.prt_etg_residual_plan.argtypes = [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    lib.prt_etg_residual_plan.restype = ctypes.c_int
    build_info.update(info)
    _lib, _launch = lib, fn
    return lib


def launch_plan(B: int, H: int) -> dict:
    """The launch the kernel makes for such a call (needs the card)."""
    lib = build()
    out = (ctypes.c_longlong * 4)()
    err = lib.prt_etg_residual_plan(B, H, out)
    if err != 0:
        raise RuntimeError("etg_residual launch plan: "
                           + lib.prt_etg_residual_error_string(err).decode())
    return dict(zip(("blocks", "threads", "envs_per_block",
                     "rows_per_chunk"), out))


def check_args(etg_w, etg_b, step_idx, k: Consts) -> None:
    """Raise on what the kernel does not take."""
    if not isinstance(etg_w, torch.Tensor) or etg_w.dim() != 3:
        raise ValueError(f"etg_w: expected a (3, H, B) tensor, got "
                         f"{getattr(etg_w, 'shape', type(etg_w))}")
    _, H, B = etg_w.shape
    want = {"etg_w": (etg_w, (3, H, B), torch.float32),
            "etg_b": (etg_b, (3, B), torch.float32),
            "step_idx": (step_idx, (B,), torch.int32),
            "centers": (k.centers, (H, 2), torch.float32),
            "legs": (k.legs, (4, len(LEG_FIELDS)), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: not a tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != etg_w.device:
            raise ValueError(f"{name}: on {t.device}, expected "
                             f"{etg_w.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if not 1 <= H <= MAX_H:
        raise ValueError(f"etg_residual: {H} phase features; the kernel "
                         f"takes 1 to {MAX_H}")
    if B < 1:
        raise ValueError("etg_residual: an empty batch")


def etg_residual(etg_w: torch.Tensor, etg_b: torch.Tensor,
                 step_idx: torch.Tensor, k: Consts):
    """``plain``'s function: the kernel for CUDA tensors, ``plain`` for CPU
    tensors.

    The kernel has no backward, so on the card a call under grad mode with
    an input that requires grad raises."""
    dev = etg_w.device
    if dev.type == "cpu":
        return plain(etg_w, etg_b, step_idx, k)
    if dev.type != "cuda":
        raise ValueError(f"etg_residual: unsupported device {dev}")
    if torch.is_grad_enabled() and (etg_w.requires_grad
                                    or etg_b.requires_grad):
        raise RuntimeError(
            "etg_residual has no backward: call it under torch.no_grad()")
    etg_w, etg_b = etg_w.contiguous(), etg_b.contiguous()
    step_idx = step_idx.contiguous()
    check_args(etg_w, etg_b, step_idx, k)
    if _launch is None:
        build()
    _, H, B = etg_w.shape
    act = torch.empty((12, B), dtype=torch.float32, device=dev)
    swing = torch.empty((4, B), dtype=torch.bool, device=dev)
    stance = torch.empty((4, B), dtype=torch.bool, device=dev)
    v_a = torch.empty((H, B), dtype=torch.float32, device=dev)
    err = _launch(etg_w.data_ptr(), etg_b.data_ptr(), step_idx.data_ptr(),
                  k.legs.data_ptr(), k.centers.data_ptr(),
                  k.scalars.ctypes.data, B, H, act.data_ptr(),
                  swing.data_ptr(), stance.data_ptr(), v_a.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("etg_residual kernel launch failed: "
                           + _lib.prt_etg_residual_error_string(err).decode())
    etg_residual.launches += 1
    if profiler.spans_on and not torch.cuda.is_current_stream_capturing():
        profiler.count("etg_launches")
    if profiler.nan_checks_on:
        profiler.check_outputs("etg_residual (ops/csrc/etg_residual.cu)",
                               (act, v_a))
    return act, swing, stance, v_a


etg_residual.launches = 0
