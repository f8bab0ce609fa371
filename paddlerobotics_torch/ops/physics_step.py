"""The physics control step: hand-written CUDA kernel and its wrapper.

``control_step`` has the contract of the JAX package's
``ops/pallas/physics_step.control_step_pallas``: one control step
(``action_repeat`` substeps) for every env, returning the new ``BRobot``.
It dispatches on the device of the state it is given:

- CPU tensors run the plain PyTorch version, ``sim/sbatch.control_step``;
- CUDA tensors launch the kernel in ``ops/csrc/physics_step.cu`` or raise.
  There is no fallback.

The kernel is compiled at first use through ``ops/build.py`` (``nvcc`` for
``sm_90a``, a plain C interface loaded with ``ctypes``, into
``build/torch_kernels/`` keyed by a hash of the source, the generated
constants header and the flags). The constants header is generated here
from the port's own constants, with every value that the plain version
folds in double precision folded the same way, so both versions round at
the same places. ``launch_plan`` reports a launch's geometry (a warp per
leg, a lane per env) from the library's ``prt_launch_plan``. The same source also builds with a host compiler,
whose ``prt_control_step_host`` runs the kernel's stages env by env on
host pointers from ``launch_args`` (the CPU tests' check of the kernel).

``control_step.launches`` counts kernel launches (plain-version calls do
not count); a caller may reset it to 0. The CUDA path opens two
``utils/profiler`` spans: ``physics.args`` (the inputs checked, the outputs
allocated, the ctypes launch) and ``physics.ring`` (the new ``BRobot``, the
ring push included); the first ``build`` of a process is ``setup.kernel``
(a load, or an ``nvcc`` build where the checkout has none). Under
``utils/profiler``'s NaN checks the wrapper checks the kernel's outputs and
raises ``FloatingPointError`` naming ``control_step``.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from paddlerobotics_torch.core.config import SimConfig
from paddlerobotics_torch.ops import build as kbuild
from paddlerobotics_torch.ops import smallalg as sa
from paddlerobotics_torch.sim import a1_model as a1
from paddlerobotics_torch.sim import dynamics as dyn
from paddlerobotics_torch.sim import sbatch
from paddlerobotics_torch.sim.sbatch import (BContact, BDynParams, BQuadState,
                                             BRobot, F32, OBS_ROW)
from paddlerobotics_torch.utils import profiler

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "physics_step.cu"
# after ops/build.BASE_FLAGS; no FMA contraction: the plain version rounds
# every product
NVCC_FLAGS = ("--fmad=false",)

# Layout of the C entry point's pointer / float / int arrays
# (physics_step.cu, prt_control_step).
N_PTRS = 33
FLOAT_NAMES = ("dt", "k", "d", "friction_coef", "vs2", "cap_foot",
               "cap_knee", "cap_base", "k_knee", "d_knee", "max_base_v",
               "max_joint_v", "pd_w0", "pd_w1", "x0", "step_height",
               "step_width", "slope", "x0_plus_run", "x1_stairstair",
               "beam_half_width", "x0_plus_beam_length")
INT_NAMES = ("B", "n", "S", "torque", "interp", "on_rack", "P", "i0", "i1",
             "mode")
# the four ints of prt_launch_plan, in order
PLAN_NAMES = ("threads_per_env", "threads", "blocks", "smem_bytes")

_lib = None
build_info: dict = {}


# --- build -------------------------------------------------------------------

def _f(x) -> str:
    return "%.9ef" % np.float32(x)


def consts_header() -> str:
    """C++ constants for the kernel, computed with the port's own code.

    Per-leg (4,) vectors and (3,3,4) matrices are the float32 arrays of
    ``sbatch.CONST_INPUTS``; every product the plain version takes of two
    constants (ĉĉᵀ of the link COMs) is evaluated here by the same
    smallalg calls, in double where the plain version folds Python floats
    and in float32 where it multiplies tensors."""
    C = sbatch.leg_consts(torch.device("cpu"))

    def legvals(x):
        if isinstance(x, float):
            return [np.float32(x)] * 4
        return [np.float32(v) for v in x.reshape(4).tolist()]

    def arr(name, dims, getter):
        idx = np.ndindex(*dims)
        vals = [getter(*ix) for ix in idx]
        body = ", ".join(_f(v) for v in vals)
        shape = "".join(f"[{d}]" for d in dims)
        return f"PRT_CONST float {name}{shape} = {{{body}}};"

    def leg_vec(name, v):
        return arr(name, (3, 4), lambda i, l: legvals(v[i])[l])

    def leg_mat(name, m):
        return arr(name, (3, 3, 4), lambda i, j, l: legvals(m[i][j])[l])

    def cct(com):
        c = sa.skew(com)
        return sa.mm(c, sa.mT(c))

    def lit_mat(name, m):
        return arr(name, (3, 3), lambda i, j: float(m[i][j]))

    def lit_vec(name, v):
        return arr(name, (3,), lambda i: float(v[i]))

    lines = [
        "// Generated by paddlerobotics_torch/ops/physics_step.py",
        "// (consts_header) from the port's constants. Do not edit.",
        leg_vec("HIP_R", C["HIP_R"]), leg_vec("THIGH_R", C["THIGH_R"]),
        leg_vec("HIP_COM", C["HIP_COM"]),
        leg_vec("THIGH_COM", C["THIGH_COM"]),
        leg_mat("HIP_I", C["HIP_I"]), leg_mat("THIGH_I", C["THIGH_I"]),
        leg_mat("HIP_CCT", cct(C["HIP_COM"])),
        leg_mat("THIGH_CCT", cct(C["THIGH_COM"])),
        lit_mat("TRUNK_I", sbatch._TRUNK_I),
        lit_mat("TRUNK_CCT", cct(sbatch._TRUNK_COM)),
        lit_mat("TRUNK_SKEW", sa.skew(sbatch._TRUNK_COM)),
        lit_vec("TRUNK_COM", sbatch._TRUNK_COM),
        lit_mat("CALF_I", sbatch._CALF_I),
        lit_mat("CALF_CCT", cct(sbatch._CALF_COM)),
        lit_mat("CALF_SKEW", sa.skew(sbatch._CALF_COM)),
        lit_vec("CALF_COM", sbatch._CALF_COM),
        f"constexpr float TRUNK_MASS = {_f(a1.TRUNK_MASS)};",
        f"constexpr float M_HIP = {_f(sbatch._M_HIP)};",
        f"constexpr float M_THIGH = {_f(sbatch._M_THIGH)};",
        f"constexpr float M_CALF = {_f(sbatch._M_CALF)};",
        # calf joint and foot offsets lie on the link's z axis; the kernel
        # folds their zero x/y components (checked at generation)
        f"constexpr float CALF_RZ = {_f(sbatch._CALF_R[2])};",
        f"constexpr float FOOT_RZ = {_f(sbatch._FOOT_R[2])};",
        f"constexpr float TORQUE_LIMIT = {_f(a1.TORQUE_LIMIT[0])};",
        f"constexpr float FOOT_RADIUS = {_f(a1.FOOT_RADIUS)};",
        f"constexpr float TRUNK_HALF_HEIGHT = {_f(dyn.TRUNK_HALF_HEIGHT)};",
    ]
    if sbatch._CALF_R[:2] != [0.0, 0.0] or sbatch._FOOT_R[:2] != [0.0, 0.0]:
        raise ValueError("physics_step.cu assumes on-axis calf/foot offsets")
    return "\n".join(lines) + "\n"


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    with profiler.annotate("setup.kernel"):
        lib, info = kbuild.build_library(
            "physics_step", SOURCE, NVCC_FLAGS,
            {"physics_consts.h": consts_header()})
        fn = lib.prt_control_step
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.prt_error_string.argtypes = [ctypes.c_int]
        lib.prt_error_string.restype = ctypes.c_char_p
        lib.prt_launch_plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.prt_launch_plan.restype = None
    build_info.update(info)
    _lib = lib
    return lib


# --- wrapper -----------------------------------------------------------------

def _check(t: torch.Tensor, name: str, shape, device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != F32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def kernel_scalars(cfg: SimConfig, h_fn, taps):
    """The float arguments of one launch, in FLOAT_NAMES order, each
    computed in double as the plain version folds it."""
    k, d = cfg.contact_stiffness, cfg.contact_damping
    idt = 1.0 / cfg.substep_dt
    vs = cfg.friction_vel_scale
    if taps:
        _, i0, i1, alpha = taps
        pd_w = (1.0 - alpha, alpha)
    else:
        pd_w = (0.0, 0.0)
    floats = [cfg.substep_dt, k, d, cfg.friction_coef, vs * vs,
              cfg.friction_cap_mass_foot * idt,
              cfg.friction_cap_mass_knee * idt,
              cfg.friction_cap_mass_base * idt, 0.5 * k, 0.5 * d,
              cfg.max_base_velocity, cfg.max_joint_velocity, *pd_w,
              *h_fn.params]
    return floats


def control_step(rb: BRobot, action: torch.Tensor, p: BDynParams,
                 cfg: SimConfig, h_fn, torque_mode: bool = False,
                 qd_ref: torch.Tensor | None = None,
                 tau_ff: torch.Tensor | None = None) -> BRobot:
    """One control step; the kernel for CUDA tensors, the plain version
    (``sim/sbatch.control_step``) for CPU tensors."""
    dev = rb.s.q.device
    if dev.type == "cpu":
        return sbatch.control_step(rb, action, p, cfg, h_fn, torque_mode,
                                   qd_ref=qd_ref, tau_ff=tau_ff)
    if dev.type != "cuda":
        raise ValueError(f"control_step: unsupported device {dev}")
    return _control_step_cuda(rb, action, p, cfg, h_fn, torque_mode,
                              qd_ref, tau_ff)


control_step.launches = 0


def launch_args(rb, action, p, cfg, h_fn, torque_mode, qd_ref, tau_ff):
    """Check every input and allocate the outputs of one launch.

    Returns (ptrs, floats, ints, outs, keep): the C entry point's three
    argument arrays, the output tensors and the tensors the pointers refer
    to (kept alive until the launch has been queued)."""
    s = rb.s
    dev = s.q.device
    B = s.q.shape[-1]
    n = cfg.action_repeat
    L = rb.obs_hist.shape[0]
    if not (L <= n or L % n == 0):
        raise ValueError(f"ring length {L} must be <= or a multiple of "
                         f"action_repeat {n}")
    S = min(L, n)               # snapshot rows the ring can consume
    taps = sbatch.pd_delay_taps(cfg, L)
    ins = [_check(s.pos, "pos", (3, B), dev),
           _check(s.quat, "quat", (4, B), dev),
           _check(s.w, "w", (3, B), dev), _check(s.v, "v", (3, B), dev),
           _check(s.q, "q", (12, B), dev), _check(s.qd, "qd", (12, B), dev),
           _check(rb.last_action, "last_action", (12, B), dev),
           _check(action, "action", (12, B), dev),
           None if qd_ref is None else _check(qd_ref, "qd_ref", (12, B), dev),
           None if tau_ff is None else _check(tau_ff, "tau_ff", (12, B), dev)]
    # the PD-latency ring is a scratch copy the kernel rotates in place
    ph = sbatch.pd_ring_seed(rb, taps).contiguous() if taps else None
    pshapes = ((B,), (3, B), (3, B), (4, 3, B), (12, B), (12, B), (B,),
               (B,), (3, B), (3, B))
    params = [_check(x, f"dyn.{f}", sh, dev)
              for x, f, sh in zip(p, BDynParams._fields, pshapes)]
    empty = lambda *sh: torch.empty(sh, dtype=F32, device=dev)
    outs = [empty(3, B), empty(4, B), empty(3, B), empty(3, B),
            empty(12, B), empty(12, B), empty(12, B), empty(3, 4, B),
            empty(4, B), empty(4, B), empty(B), empty(S, OBS_ROW, B)]
    keep = ins + [ph] + params + outs
    ptrs = [0 if t is None else t.data_ptr() for t in keep]
    floats = kernel_scalars(cfg, h_fn, taps)
    P, i0, i1 = (taps[0], taps[1], taps[2]) if taps else (0, 0, 0)
    ints = [B, n, S, int(torque_mode),
            int(cfg.enable_action_interpolation and not torque_mode),
            int(cfg.on_rack), P, i0, i1, h_fn.mode_id]
    if len(ptrs) != N_PTRS or len(floats) != len(FLOAT_NAMES) or \
            len(ints) != len(INT_NAMES):
        raise AssertionError("launch argument layout out of date")
    return ptrs, floats, ints, outs, keep


def launch_plan(B: int, lib: ctypes.CDLL | None = None) -> dict:
    """Threads per env, threads per block, blocks and static shared memory
    of one launch over B envs, as the source's ``prt_launch_plan`` computes
    them: in the built kernel library, or in ``lib`` (a host build)."""
    out = (ctypes.c_int * len(PLAN_NAMES))()
    (lib or build()).prt_launch_plan(B, out)
    return dict(zip(PLAN_NAMES, out))


def robot_from_outputs(rb, action, outs) -> BRobot:
    """The new BRobot from a launch's output tensors (ring update in
    PyTorch, contact flags rebuilt as > 0.5)."""
    (pos, quat, w, v, q, qd, tau, foot_pos, fcon, kcon, bcon, rows) = outs
    ns = BQuadState(pos=pos, quat=quat, w=w, v=v, q=q, qd=qd)
    contact = BContact(foot_pos=foot_pos, foot_contact=fcon > 0.5,
                       knee_contact=kcon > 0.5, base_contact=bcon > 0.5)
    hist, head = sbatch.ring_push(rb.obs_hist, rb.hist_head, rows)
    return BRobot(s=ns, last_action=action, tau=tau, contact=contact,
                  obs_hist=hist, hist_head=head)


def c_arrays(ptrs, floats, ints):
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_float * len(floats))(*floats),
            (ctypes.c_int * len(ints))(*ints))


def _control_step_cuda(rb, action, p, cfg, h_fn, torque_mode, qd_ref,
                       tau_ff) -> BRobot:
    lib = build()
    with profiler.annotate("physics.args"):
        ptrs, floats, ints, outs, keep = launch_args(
            rb, action, p, cfg, h_fn, torque_mode, qd_ref, tau_ff)
        c_p, c_f, c_i = c_arrays(ptrs, floats, ints)
        stream = torch.cuda.current_stream(rb.s.q.device).cuda_stream
        err = lib.prt_control_step(c_p, len(ptrs), c_f, len(floats), c_i,
                                   len(ints), stream)
    if err != 0:
        raise RuntimeError("physics_step kernel launch failed: "
                           + lib.prt_error_string(err).decode())
    control_step.launches += 1
    del keep
    if profiler.nan_checks_on:
        profiler.check_outputs("control_step (ops/csrc/physics_step.cu)",
                               outs)
    with profiler.annotate("physics.ring"):
        return robot_from_outputs(rb, action, outs)
