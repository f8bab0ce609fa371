"""Diffusion Policy's ``Conv1dBlock`` tail: hand-written CUDA kernel, wrapper
and plain version.

``conv_groupnorm_mish(x, weight, bias, gamma, beta, groups, eps, padding,
film=, res=, res_weight=, res_bias=)`` computes ``Mish(GroupNorm(conv1d(x,
weight, bias, padding=padding)))`` and then the block's epilogue:

- ``film`` (B, 2C), a ``cond_encoder``'s output: ``film[:, :C, None] · h +
  film[:, C:, None]`` (FiLM, after ``blocks[0]`` of a residual block);
- ``res`` (B, C, L): ``h + res``; with ``res_weight`` (C, C_in, 1) and
  ``res_bias``, ``h + conv1d(res, res_weight, res_bias)`` (after
  ``blocks[1]``);
- neither: ``h`` (the head's block).

It dispatches on the device of ``x``:

- CPU tensors run the published composition itself: ``F.conv1d`` with its
  bias, ``F.group_norm``, ``F.mish``, then FiLM or the add, what
  ``nn.Conv1d``, ``nn.GroupNorm`` and ``nn.Mish`` run, so CPU results and
  gradients are as before;
- CUDA tensors run the convolutions without their bias (cuDNN; the input
  made contiguous, so that the output is (B, C, L) in order) and then
  ``groupnorm_mish``, whose kernel adds the biases. There is no fallback.

``groupnorm_mish(h, bias, gamma, beta, groups, eps, film=, res=,
res_bias=)`` is the part after a bias-less convolution: the kernel in
``ops/csrc/groupnorm_mish.cu`` (float32 only, precise ``expf``, ``log1pf``,
``tanhf``) for CUDA tensors, ``plain`` for CPU ones. The kernel takes
contiguous float32 tensors (h and res 16-byte aligned: it reads them as
float4s), L a multiple of 4 and at most ``MAX_GROUP_FLOATS`` floats a
group; the wrapper raises on anything else. It is built at first use
through ``ops/build.py``. ``groupnorm_mish.launches`` counts kernel
launches (the plain version's calls do not count), and each launch adds 1
to the profiler's ``norm_launches`` counter while spans are on. On the
card it refuses autograd: the kernel has no backward. Under
``utils/profiler``'s NaN checks the wrapper checks the kernel's output and
raises ``FloatingPointError`` naming ``groupnorm_mish``.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from paddlerobotics_torch.utils import profiler

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "groupnorm_mish.cu"
MAX_GROUP_FLOATS = 512

_lib = None
_launch = None                      # prt_groupnorm_mish, argtypes bound once
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _launch
    if _lib is not None:
        return _lib
    from paddlerobotics_torch.ops import build as kbuild

    lib, info = kbuild.build_library("groupnorm_mish", SOURCE)
    fn = lib.prt_groupnorm_mish
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4 + [
        ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.prt_groupnorm_mish_error_string.argtypes = [ctypes.c_int]
    lib.prt_groupnorm_mish_error_string.restype = ctypes.c_char_p
    lib.prt_groupnorm_mish_plan.argtypes = [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p]
    lib.prt_groupnorm_mish_plan.restype = ctypes.c_int
    build_info.update(info)
    _lib, _launch = lib, fn
    return lib


def launch_plan(B: int, C: int, L: int, groups: int) -> dict:
    """The launch the kernel makes for such a call (needs the card)."""
    lib = build()
    out = (ctypes.c_longlong * 4)()
    err = lib.prt_groupnorm_mish_plan(B, C, L, groups, out)
    if err != 0:
        raise RuntimeError("groupnorm_mish launch plan: "
                           + lib.prt_groupnorm_mish_error_string(err).decode())
    return dict(zip(("blocks", "threads", "groups_per_block",
                     "floats_per_lane"), out))


def _epilogue(h, film, res):
    if film is not None:
        embed = film.reshape(film.shape[0], 2, -1, 1)
        return embed[:, 0] * h + embed[:, 1]
    if res is not None:
        return h + res
    return h


def plain(h, bias, gamma, beta, groups: int, eps: float, film=None,
          res=None, res_bias=None) -> torch.Tensor:
    """The kernel's function in PyTorch operations: the convolution's bias,
    GroupNorm, Mish, then FiLM or the residual (with its bias) added."""
    y = F.mish(F.group_norm(h + bias[:, None], groups, gamma, beta, eps))
    if res is not None and res_bias is not None:
        res = res + res_bias[:, None]
    return _epilogue(y, film, res)


def check_args(h, bias, gamma, beta, groups: int, film=None, res=None,
               res_bias=None) -> None:
    """Raise on what the kernel does not take."""
    if film is not None and res is not None:
        raise ValueError("groupnorm_mish: FiLM or a residual, not both")
    if res_bias is not None and res is None:
        raise ValueError("groupnorm_mish: res_bias without res")
    if not isinstance(h, torch.Tensor) or h.dim() != 3:
        raise ValueError(f"h: expected a (B, C, L) tensor, got "
                         f"{getattr(h, 'shape', type(h))}")
    B, C, L = h.shape
    want = {"h": (h, (B, C, L)), "bias": (bias, (C,)),
            "gamma": (gamma, (C,)), "beta": (beta, (C,)),
            "film": (film, (B, 2 * C)), "res": (res, (B, C, L)),
            "res_bias": (res_bias, (C,))}
    for name, (t, shape) in want.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: not a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != h.device:
            raise ValueError(f"{name}: on {t.device}, expected {h.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if name in ("h", "res") and t.data_ptr() % 16:
            raise ValueError(f"{name}: pointer not 16-byte aligned")
    if groups <= 0 or C % groups:
        raise ValueError(f"groupnorm_mish: {C} channels in {groups} groups")
    if L % 4:
        raise ValueError(f"groupnorm_mish: length {L}; the kernel takes "
                         f"multiples of 4")
    if C // groups * L > MAX_GROUP_FLOATS:
        raise ValueError(f"groupnorm_mish: a group of {C // groups * L} "
                         f"floats; the kernel takes at most "
                         f"{MAX_GROUP_FLOATS}")


def groupnorm_mish(h, bias, gamma, beta, groups: int, eps: float, film=None,
                   res=None, res_bias=None) -> torch.Tensor:
    """``plain``'s function; the kernel for CUDA tensors, ``plain`` for CPU
    tensors. The kernel has no backward, so on the card a call under grad
    mode with an input that requires grad raises."""
    dev = h.device
    if dev.type == "cpu":
        return plain(h, bias, gamma, beta, groups, eps, film, res, res_bias)
    if dev.type != "cuda":
        raise ValueError(f"groupnorm_mish: unsupported device {dev}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (h, bias, gamma, beta, film, res, res_bias)):
        raise RuntimeError(
            "groupnorm_mish has no backward: call it under torch.no_grad()")
    check_args(h, bias, gamma, beta, groups, film, res, res_bias)
    if _launch is None:
        build()
    B, C, L = h.shape
    y = torch.empty_like(h)
    # the source's Epilogue: 0 none, 1 FiLM, 2 residual
    epilogue = 1 if film is not None else 2 if res is not None else 0
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _launch(h.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), ptr(film), ptr(res), ptr(res_bias),
                  y.data_ptr(), B, C, L, groups, eps, epilogue,
                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("groupnorm_mish kernel launch failed: "
                           + _lib.prt_groupnorm_mish_error_string(err)
                           .decode())
    groupnorm_mish.launches += 1
    profiler.count("norm_launches")
    if profiler.nan_checks_on:
        profiler.check_outputs("groupnorm_mish (ops/csrc/groupnorm_mish.cu)",
                               (y,))
    return y


groupnorm_mish.launches = 0


def conv_groupnorm_mish(x, weight, bias, gamma, beta, groups: int,
                        eps: float, padding: int, film=None, res=None,
                        res_weight=None, res_bias=None) -> torch.Tensor:
    """A ``Conv1dBlock`` (stride 1) and its epilogue; on the CPU the
    published composition, on the card bias-less convolutions and the
    kernel."""
    if res_weight is None and res_bias is not None:
        raise ValueError("conv_groupnorm_mish: res_bias without res_weight")
    if x.device.type == "cpu":
        h = F.mish(F.group_norm(F.conv1d(x, weight, bias, padding=padding),
                                groups, gamma, beta, eps))
        if res_weight is not None:
            res = F.conv1d(res, res_weight, res_bias)
        return _epilogue(h, film, res)
    h = F.conv1d(x.contiguous(), weight, None, padding=padding)
    if res_weight is not None:
        res = F.conv1d(res.contiguous(), res_weight, None)
    return groupnorm_mish(h, bias, gamma, beta, groups, eps, film, res,
                          res_bias)
