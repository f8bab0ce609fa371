"""Masked flash attention: hand-written CUDA kernel, wrapper and plain version.

``flash_attention`` has the contract of the JAX package's
``ops/pallas/attention.flash_attention``: q (B,H,T,hd), k and v (B,H,S,hd),
a float 0/1 mask (B,T,S) shared by the heads → (B,H,T,hd). Scores are
``(q·k)·hd^-0.5``, masked as ``s·m − 1e10·(1−m)``, the softmax weights are
re-masked, so a row with every key masked gives zeros. It dispatches on
the device of ``q``:

- CPU tensors run the plain PyTorch version, ``reference_attention``;
- CUDA tensors launch the kernel in ``ops/csrc/attention.cu`` (tensor-core
  products in three TF32 passes at float32 accuracy) or raise. There is no
  fallback.

The kernel takes any head dim that is a multiple of 8 up to ``MAX_HD``, and
q, k and v whose pointers and strides are multiples of 16 bytes (it copies
them with ``cp.async``). It is built at first use through ``ops/build.py``.
``flash_attention.launches`` counts kernel launches (plain-version calls do
not count); a caller may reset it to 0. It refuses autograd: see its
docstring. Under ``utils/profiler``'s NaN checks the wrapper checks the
kernel's output and raises ``FloatingPointError`` naming
``flash_attention``.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from paddlerobotics_torch.utils import profiler

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "attention.cu"
NEG_INF = -1e10
MAX_HD = 128
_PTRS = ctypes.c_void_p * 5
_INTS = ctypes.c_longlong * 19

_lib = None
_launch = None                      # prt_flash_attention, argtypes bound once
build_info: dict = {}


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The materialized path (hri/transformer.py:86-93 semantics):
    returns (out (B,H,T,hd), weights (B,H,T,S))."""
    hd = q.shape[-1]
    s = torch.einsum("bhtd,bhsd->bhts", q, k) * (hd ** -0.5)
    m = mask[:, None, :, :]
    s = s * m + NEG_INF * (1.0 - m)
    w = torch.softmax(s, dim=-1) * m
    return torch.einsum("bhts,bhsd->bhtd", w, v), w


def reference_attention(q, k, v, mask) -> torch.Tensor:
    """The kernel's plain version (``ops/pallas/attention.reference_attention``)."""
    return masked_attention(q, k, v, mask)[0]


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _launch
    if _lib is not None:
        return _lib
    from paddlerobotics_torch.ops import build as kbuild

    lib, info = kbuild.build_library("attention", SOURCE)
    fn = lib.prt_flash_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.prt_attn_error_string.argtypes = [ctypes.c_int]
    lib.prt_attn_error_string.restype = ctypes.c_char_p
    lib.prt_attn_plan.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_void_p]
    lib.prt_attn_plan.restype = ctypes.c_int
    build_info.update(info)
    _lib, _launch = lib, fn
    return lib


def launch_plan(B: int, H: int, T: int, hd: int) -> dict:
    """The launch the kernel makes for such a call (needs the card): grid,
    block, dynamic shared memory and the instance it runs on."""
    lib = build()
    out = (ctypes.c_longlong * 7)()
    err = lib.prt_attn_plan(B * H, T, hd, out)
    if err != 0:
        raise RuntimeError("attention launch plan: "
                           + lib.prt_attn_error_string(err).decode())
    return dict(zip(("blocks", "threads", "smem_bytes", "instance_hd",
                     "query_tiles_per_block", "key_partitions",
                     "keys_per_partition"), out))


def launch_args(q, k, v, mask):
    """Check the inputs of one launch and allocate its output.

    Returns (ptrs, ints, out): the C entry point's pointer and int arrays
    (``attention.cu``, ``prt_flash_attention``) and the output, a
    (B,H,T,hd) view of a (B,T,H,hd) buffer. Runs on every launch, so each
    tensor's attributes are read once."""
    names, tensors = ("q", "k", "v", "mask"), (q, k, v, mask)
    for name, t in zip(names, tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    dev = q.device
    shapes, strides = [], []
    for name, t, nd in zip(names, tensors, (4, 4, 4, 3)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        shape, st = t.shape, t.stride()
        if len(shape) != nd:
            raise ValueError(f"{name}: shape {tuple(shape)}")
        if shape[-1] > 1 and st[-1] != 1:
            raise ValueError(f"{name}: last dimension not contiguous")
        shapes.append(shape)
        strides.append(st)
    B, H, T, hd = shapes[0]
    S = shapes[1][2]
    if shapes[1] != (B, H, S, hd) or shapes[2] != (B, H, S, hd):
        raise ValueError(f"k {tuple(shapes[1])} / v {tuple(shapes[2])} do "
                         f"not match q {tuple(shapes[0])}")
    if shapes[3] != (B, T, S):
        raise ValueError(f"mask: shape {tuple(shapes[3])}, expected "
                         f"{(B, T, S)}")
    if hd % 8 or not 8 <= hd <= MAX_HD:
        raise ValueError(f"head dim {hd}: the kernel takes multiples of 8 "
                         f"up to {MAX_HD}")
    o_st = (T * H * hd, hd, H * hd)        # (B,H,T,hd) view of (B,T,H,hd)
    out = torch.empty_strided((B, H, T, hd), (*o_st, 1), dtype=torch.float32,
                              device=dev)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr()]
    for i in range(3):
        # 16-byte cp.async: the pointer and every stride of a dimension
        # longer than 1 a multiple of 4 floats
        (n0, n1, n2, _), (s0, s1, s2, _) = shapes[i], strides[i]
        if ptrs[i] % 16 or (n0 > 1 and s0 % 4) or (n1 > 1 and s1 % 4) or (
                n2 > 1 and s2 % 4):
            raise ValueError(f"{names[i]}: pointer or strides not 16-byte "
                             f"aligned (strides {strides[i]})")
    ints = [B, H, T, S, hd, *strides[0][:3], *strides[1][:3],
            *strides[2][:3], *strides[3][:2], *o_st]
    return ptrs, ints, out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked attention; the kernel for CUDA tensors, the plain version
    (``reference_attention``) for CPU tensors.

    Neither the kernel nor the JAX package's has a backward pass, so a call
    under grad mode with an input that requires grad raises on every
    device: its output would carry no gradient to the projections before
    it. Train through ``masked_attention``; score under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad or mask.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad() "
            "or train through masked_attention")
    dev = q.device
    if dev.type == "cpu":
        return reference_attention(q, k, v, mask)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if _launch is None:
        build()
    ptrs, ints, out = launch_args(q, k, v, mask)
    err = _launch(_PTRS(*ptrs), _INTS(*ints), 19, ints[4] ** -0.5,
                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + _lib.prt_attn_error_string(err).decode())
    flash_attention.launches += 1
    if profiler.nan_checks_on:
        profiler.check_outputs("flash_attention (ops/csrc/attention.cu)",
                               (out,))
    return out


flash_attention.launches = 0
