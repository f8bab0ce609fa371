"""Masked flash attention: hand-written CUDA kernel, wrapper and plain version.

``flash_attention`` has the contract of the JAX package's
``ops/pallas/attention.flash_attention``: q (B,H,T,hd), k and v (B,H,S,hd),
a float 0/1 mask (B,T,S) shared by the heads → (B,H,T,hd). Scores are
``(q·k)·hd^-0.5``, masked as ``s·m − 1e10·(1−m)``, the softmax weights are
re-masked, so a row with every key masked gives zeros. It dispatches on
the device of ``q``:

- CPU tensors run the plain PyTorch version, ``reference_attention``;
- CUDA tensors launch the kernel in ``ops/csrc/attention.cu`` or raise.
  There is no fallback.

The kernel is built at first use through ``ops/build.py``.
``flash_attention.launches`` counts kernel launches (plain-version calls do
not count); a caller may reset it to 0.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "attention.cu"
NEG_INF = -1e10
SUPPORTED_HD = (16, 32, 64)

_lib = None
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
    global _lib
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
    build_info.update(info)
    _lib = lib
    return lib


def launch_args(q, k, v, mask):
    """Check the inputs of one launch and allocate its output.

    Returns (ptrs, ints, out): the C entry point's pointer and int arrays
    (``attention.cu``, ``prt_flash_attention``) and the output, a
    (B,H,T,hd) view of a (B,T,H,hd) buffer."""
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
        if t.dim() != (3 if name == "mask" else 4):
            raise ValueError(f"{name}: shape {tuple(t.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension not contiguous")
    B, H, T, hd = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, H, S, hd) or tuple(v.shape) != (B, H, S, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(mask.shape) != (B, T, S):
        raise ValueError(f"mask: shape {tuple(mask.shape)}, expected "
                         f"{(B, T, S)}")
    if hd not in SUPPORTED_HD:
        raise ValueError(f"head dim {hd}: the kernel takes {SUPPORTED_HD}")
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=q.device)
    out = out.permute(0, 2, 1, 3)
    ints = [B, H, T, S, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *mask.stride()[:2], *out.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q, k, v, mask, out)]
    return ptrs, ints, out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked attention; the kernel for CUDA tensors, the plain version
    (``reference_attention``) for CPU tensors."""
    dev = q.device
    if dev.type == "cpu":
        return reference_attention(q, k, v, mask)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    lib = build()
    ptrs, ints, out = launch_args(q, k, v, mask)
    c_p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_i = (ctypes.c_longlong * len(ints))(*ints)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.prt_flash_attention(c_p, c_i, len(ints),
                                  float(q.shape[-1]) ** -0.5, stream)
    if err != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.prt_attn_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
