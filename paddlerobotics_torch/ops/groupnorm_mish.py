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

The row path is the same pass at one group of length 1, where GroupNorm is
LayerNorm: TD-MPC2's ``NormedLinear`` tail (``algos/tdmpc2.py``).
``linear_norm_act(x, weight, bias, gamma, beta, eps, act)`` computes
``act(LayerNorm(F.linear(x, weight, bias)))``, ``act`` Mish or SimNorm (a
softmax over each group of ``dim`` consecutive features), and
``heads_linear_norm_act`` the same for an ensemble's stacked weights
(heads, C, K), on one input shared by the heads or one input a head. On
CPU tensors both run the published composition (``F.linear`` with its bias,
``F.layer_norm``, ``F.mish`` or SimNorm); on the card the GEMM runs without
its bias (one ``mm`` over the stacked weights for a shared input, a
``bmm`` otherwise) and ``row_norm``, whose kernel adds the bias per element
and takes each row's head from its index, one launch for every head.
``row_norm`` launches count in ``groupnorm_mish.launches`` and
``norm_launches`` as the U-Net's do.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from paddlerobotics_torch.utils import profiler

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "groupnorm_mish.cu"
MAX_GROUP_FLOATS = 512
ACTS = {"mish": 0, "simnorm": 1}    # the source's Act

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
    lib.prt_row_norm.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong] * 4 + [ctypes.c_double, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_void_p]
    lib.prt_row_norm.restype = ctypes.c_int
    lib.prt_row_norm_plan.argtypes = [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    lib.prt_row_norm_plan.restype = ctypes.c_int
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


# --- the row path: LayerNorm tails of linear layers --------------------------

def simnorm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """TD-MPC2's SimNorm: a softmax over each group of ``dim`` consecutive
    features."""
    shp = x.shape
    return F.softmax(x.view(*shp[:-1], -1, dim), dim=-1).view(shp)


def _act(x, act: str, dim: int):
    return F.mish(x) if act == "mish" else simnorm(x, dim)


def row_launch_plan(rows: int, C: int) -> dict:
    """The launch ``row_norm`` makes for ``rows`` rows of C (needs the
    card)."""
    lib = build()
    out = (ctypes.c_longlong * 4)()
    err = lib.prt_row_norm_plan(rows, C, out)
    if err != 0:
        raise RuntimeError("row_norm launch plan: "
                           + lib.prt_groupnorm_mish_error_string(err).decode())
    return dict(zip(("blocks", "threads", "rows_per_block",
                     "floats_per_lane"), out))


def row_plain(h, bias, gamma, beta, eps: float, act: str = "mish",
              dim: int = 8, head_div: int = 1) -> torch.Tensor:
    """The row kernel's function in PyTorch operations: each row of h
    (R, C) plus its head's bias, ``F.layer_norm`` with the head's scale and
    shift, then Mish or SimNorm; the parameters are (C,) or (heads, C), row
    r taking head (r // head_div) % heads."""
    C = h.shape[-1]
    if bias.dim() == 1:
        return _act(F.layer_norm(h + bias, (C,), gamma, beta, eps), act, dim)
    heads = bias.shape[0]
    x = h.reshape(-1, heads, head_div, C)
    return torch.stack([
        _act(F.layer_norm(x[:, k] + bias[k], (C,), gamma[k], beta[k], eps),
             act, dim) for k in range(heads)], dim=1).reshape(h.shape)


def check_rows(h, bias, gamma, beta, act: str, dim: int,
               head_div: int) -> None:
    """Raise on what the row kernel does not take."""
    if act not in ACTS:
        raise ValueError(f"row_norm: act {act!r}, expected one of "
                         f"{sorted(ACTS)}")
    if not isinstance(h, torch.Tensor) or h.dim() != 2:
        raise ValueError(f"h: expected a (rows, C) tensor, got "
                         f"{getattr(h, 'shape', type(h))}")
    R, C = h.shape
    pshape = tuple(getattr(bias, "shape", ()))
    if pshape != (C,) and not (len(pshape) == 2 and pshape[1] == C):
        raise ValueError(f"bias: shape {pshape}, expected (C,) or "
                         f"(heads, C) with C = {C}")
    heads = pshape[0] if len(pshape) == 2 else 1
    for name, t in (("h", h), ("bias", bias), ("gamma", gamma),
                    ("beta", beta)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: not a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != h.device:
            raise ValueError(f"{name}: on {t.device}, expected {h.device}")
        if name != "h" and tuple(t.shape) != pshape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{pshape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: pointer not 16-byte aligned")
    if C % 4 or C > MAX_GROUP_FLOATS:
        raise ValueError(f"row_norm: rows of {C} floats; the kernel takes "
                         f"multiples of 4 up to {MAX_GROUP_FLOATS}")
    if head_div <= 0 or R % (heads * head_div):
        raise ValueError(f"row_norm: {R} rows in blocks of {heads} heads "
                         f"x {head_div}")
    if act == "simnorm" and (dim not in (4, 8, 16, 32, 64, 128) or C % dim):
        raise ValueError(f"row_norm: SimNorm groups of {dim} over {C}")


def row_norm(h, bias, gamma, beta, eps: float, act: str = "mish",
             dim: int = 8, head_div: int = 1) -> torch.Tensor:
    """``row_plain``'s function; the kernel for CUDA tensors, ``row_plain``
    for CPU tensors. As ``groupnorm_mish``, no backward on the card."""
    dev = h.device
    if dev.type == "cpu":
        return row_plain(h, bias, gamma, beta, eps, act, dim, head_div)
    if dev.type != "cuda":
        raise ValueError(f"row_norm: unsupported device {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, bias, gamma, beta)):
        raise RuntimeError(
            "row_norm has no backward: call it under torch.no_grad()")
    check_rows(h, bias, gamma, beta, act, dim, head_div)
    if _launch is None:
        build()
    R, C = h.shape
    y = torch.empty_like(h)
    heads = bias.shape[0] if bias.dim() == 2 else 1
    err = _lib.prt_row_norm(h.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
                            beta.data_ptr(), y.data_ptr(), R, C, heads,
                            head_div, eps, ACTS[act], dim,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("row_norm kernel launch failed: "
                           + _lib.prt_groupnorm_mish_error_string(err)
                           .decode())
    groupnorm_mish.launches += 1
    profiler.count("norm_launches")
    if profiler.nan_checks_on:
        profiler.check_outputs("row_norm (ops/csrc/groupnorm_mish.cu)", (y,))
    return y


def linear_norm_act(x, weight, bias, gamma, beta, eps: float,
                    act: str = "mish", dim: int = 8) -> torch.Tensor:
    """``act(LayerNorm(F.linear(x, weight, bias)))`` for x (..., K): on the
    CPU the published composition, on the card a bias-less GEMM and the
    row kernel."""
    if x.device.type == "cpu":
        y = F.linear(x, weight, bias)
        return _act(F.layer_norm(y, y.shape[-1:], gamma, beta, eps), act, dim)
    h = torch.mm(x.reshape(-1, x.shape[-1]), weight.t())
    return row_norm(h, bias, gamma, beta, eps, act, dim).view(
        *x.shape[:-1], -1)


def heads_linear_norm_act(x, weight, bias, gamma, beta, eps: float,
                          act: str = "mish", dim: int = 8) -> torch.Tensor:
    """An ensemble's layer: for each head k, ``act(LayerNorm(F.linear(x_k,
    weight[k], bias[k])))`` with weight (H, C, K) and bias, gamma, beta
    (H, C); x (N, K) shared by the heads or (H, N, K). Returns (H, N, C):
    on the CPU the heads one after another; on the card one GEMM over the
    stacked weights (a shared x; the result a view of (N, H, C)) or one
    batched GEMM, then one launch of the row kernel for every head."""
    H, C, K = weight.shape
    shared = x.dim() == 2
    if x.device.type == "cpu":
        return torch.stack([linear_norm_act(x if shared else x[k], weight[k],
                                            bias[k], gamma[k], beta[k], eps,
                                            act, dim) for k in range(H)])
    if shared:
        h = torch.mm(x, weight.reshape(H * C, K).t())      # (N, H * C)
        y = row_norm(h.view(-1, C), bias, gamma, beta, eps, act, dim)
        return y.view(x.shape[0], H, C).transpose(0, 1)
    h = torch.bmm(x, weight.transpose(1, 2))                # (H, N, C)
    y = row_norm(h.view(-1, C), bias, gamma, beta, eps, act, dim,
                 head_div=x.shape[1])
    return y.view(H, -1, C)
