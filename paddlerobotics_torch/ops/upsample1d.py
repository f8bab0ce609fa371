"""Diffusion Policy's ``Upsample1d``: hand-written CUDA kernel, wrapper and
plain version.

``upsample1d(x, weight, bias)`` computes ``conv_transpose1d(x, weight,
bias, stride=2, padding=1)`` for x (B, C, L), weight (C, C, 4) in
``nn.ConvTranspose1d``'s layout (in, out, tap) and bias (C). The kernel
computes it as two polyphase 2-tap products: the even outputs y[..., 2t]
take taps 1 and 3 on x at t and t−1, the odd ones y[..., 2t+1] taps 2 and
0 on x at t and t+1 (x outside [0, L) reads 0). The wrapper dispatches on
the device of ``x``:

- CPU tensors run the plain version, ``F.conv_transpose1d`` itself (what
  ``nn.ConvTranspose1d`` runs, so CPU results and gradients are as
  before);
- CUDA tensors launch the kernel in ``ops/csrc/upsample1d.cu`` (float32
  FMAs only) or raise. There is no fallback.

The kernel takes contiguous float32 tensors with L = 4 or 8 (the U-Net's
two levels at a horizon of 16) and 16-byte aligned pointers (it copies with
``cp.async``). It is built at first use through ``ops/build.py``.
``upsample1d.launches`` counts kernel launches (plain-version calls do not
count), and each launch adds 1 to the profiler's ``upsample_launches``
counter while spans are on. On the card it refuses autograd, as
``flash_attention`` does: the kernel has no backward. Under
``utils/profiler``'s NaN checks the wrapper checks the kernel's output and
raises ``FloatingPointError`` naming ``upsample1d``.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from paddlerobotics_torch.utils import profiler

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "upsample1d.cu"
LENGTHS = (4, 8)

_lib = None
_launch = None                      # prt_upsample1d, argtypes bound once
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _launch
    if _lib is not None:
        return _lib
    from paddlerobotics_torch.ops import build as kbuild

    lib, info = kbuild.build_library("upsample1d", SOURCE)
    fn = lib.prt_upsample1d
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.prt_upsample1d_error_string.argtypes = [ctypes.c_int]
    lib.prt_upsample1d_error_string.restype = ctypes.c_char_p
    lib.prt_upsample1d_plan.argtypes = [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    lib.prt_upsample1d_plan.restype = ctypes.c_int
    build_info.update(info)
    _lib, _launch = lib, fn
    return lib


def launch_plan(B: int, C: int, L: int) -> dict:
    """The launch the kernel makes for such a call (needs the card)."""
    lib = build()
    out = (ctypes.c_longlong * 6)()
    err = lib.prt_upsample1d_plan(B, C, L, out)
    if err != 0:
        raise RuntimeError("upsample1d launch plan: "
                           + lib.prt_upsample1d_error_string(err).decode())
    return dict(zip(("blocks_m", "blocks_n", "threads", "smem_bytes",
                     "channels_per_block", "sequences_per_block"), out))


def check_args(x, weight, bias) -> None:
    """Raise on what the kernel does not take."""
    names = ("x", "weight", "bias")
    tensors = (x, weight, bias)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("upsample1d: x, weight and bias must be tensors")
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (B, C, L)")
    B, C, L = x.shape
    want = {"x": (B, C, L), "weight": (C, C, 4), "bias": (C,)}
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected {x.device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: pointer not 16-byte aligned")
    if L not in LENGTHS:
        raise ValueError(f"upsample1d: length {L}; the kernel takes "
                         f"{LENGTHS}")


def upsample1d(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """``conv_transpose1d(x, weight, bias, stride=2, padding=1)``; the
    kernel for CUDA tensors, the plain version for CPU tensors.

    The kernel has no backward, so on the card a call under grad mode with
    an input that requires grad raises."""
    dev = x.device
    if dev.type == "cpu":
        return F.conv_transpose1d(x, weight, bias, stride=2, padding=1)
    if dev.type != "cuda":
        raise ValueError(f"upsample1d: unsupported device {dev}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError(
            "upsample1d has no backward: call it under torch.no_grad()")
    check_args(x, weight, bias)
    if _launch is None:
        build()
    B, C, L = x.shape
    y = torch.empty((B, C, 2 * L), dtype=torch.float32, device=dev)
    err = _launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  y.data_ptr(), B, C, L,
                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("upsample1d kernel launch failed: "
                           + _lib.prt_upsample1d_error_string(err).decode())
    upsample1d.launches += 1
    profiler.count("upsample_launches")
    if profiler.nan_checks_on:
        profiler.check_outputs("upsample1d (ops/csrc/upsample1d.cu)", (y,))
    return y


upsample1d.launches = 0
