"""Exact linear assignment and the tracker's matching step: plain PyTorch
versions, and the wrapper of the hand-written CUDA kernel
``ops/csrc/track_match.cu``.

``solve_lap`` and ``min_cost_match`` copy the JAX package's ``ops/lap.py``
step for step (successive shortest augmenting paths with dual potentials,
the textbook O(n³) method that scipy's ``linear_sum_assignment`` also
implements): the same dual updates, ``argmin`` taking the first minimum,
``BIG = 1e18``, the clip ``float32(max_cost + 1e-5)`` with the sum taken in
double first. Their loops read a scalar back to the host on every
iteration, so on the card the tracker's whole matching step is one kernel
launch instead: ``track_match`` dispatches on the device of its costs:

- CPU tensors run the plain version, ``track_match_plain`` (the matching
  cascade of the JAX package's ``hri/tracker.tracker_update`` over
  ``min_cost_match``);
- CUDA tensors launch the kernel or raise. There is no fallback.

``track_match.launches`` counts kernel launches (plain-version calls do not
count); a caller may reset it to 0.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import numpy as np
import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "track_match.cu"
BIG = 1e18
MAX_N = 32
# track slot states, as hri/tracker keeps them and the kernel reads them
EMPTY, TENTATIVE, CONFIRMED = 0, 1, 2
_PTRS = ctypes.c_void_p * 8

_lib = None
_launch = None                      # prt_track_match, argtypes bound once
build_info: dict = {}


def solve_lap(cost: torch.Tensor,
              work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact min-cost perfect assignment on a square (n,n) matrix of finite
    costs → col_for_row (n,) int32. ``work`` (2,) int, if given, gets the
    Dijkstra scans added to its first entry."""
    n = cost.shape[0]
    dev = cost.device
    cost = cost.to(torch.float32)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    ar = torch.arange(n, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    row4col = [-1] * n
    col4row = [-1] * n
    scans = 0
    for cur_row in range(n):
        # Dijkstra over the equality graph from cur_row
        shortest = torch.full((n,), BIG, device=dev)
        path = torch.full((n,), cur_row, dtype=torch.int64, device=dev)
        remaining = torch.ones(n, dtype=torch.bool, device=dev)
        sr = torch.zeros(n, dtype=torch.bool, device=dev)
        sink, min_val, i = -1, zero, cur_row
        while sink < 0:
            sr[i] = True
            r = min_val + cost[i] - u[i] - v
            better = remaining & (r < shortest)
            shortest = torch.where(better, r, shortest)
            path = torch.where(better, i, path)
            d = torch.where(remaining, shortest, big)
            j = int(torch.argmin(d))                  # the first minimum
            min_val = d[j]
            remaining[j] = False
            scans += 1
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
        # dual updates (keep reduced costs ≥ 0)
        c4r = torch.tensor(col4row, device=dev).clamp(0, n - 1)
        d_of_row = torch.where(ar == cur_row, zero, shortest[c4r])
        u = torch.where(sr, u + min_val - d_of_row, u)
        v = torch.where(~remaining, v - (min_val - shortest), v)
        # augment along the alternating path
        j = sink
        path_h = path.tolist()
        while j >= 0:
            i = path_h[j]
            row4col[j] = i
            j_next = col4row[i]
            col4row[i] = j
            j = j_next
    if work is not None:
        work[0] += scans
    return torch.tensor(col4row, dtype=torch.int32, device=dev)


def clip_value(max_cost: float) -> float:
    """The pre-solve clamp: max_cost + 1e-5 in double, rounded to float32."""
    return float(np.float32(max_cost + 1e-5))


def min_cost_match(cost: torch.Tensor, max_cost: float,
                   rows_valid: torch.Tensor, cols_valid: torch.Tensor,
                   work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deep-SORT ``min_cost_matching`` on fixed shapes: clip the (R,C) cost
    at max_cost + 1e-5, pad to a square, solve exactly, drop matches whose
    cost exceeds max_cost or that hit an invalid row or column. → col_for_row
    (R,) int32, −1 for unmatched."""
    R, C = cost.shape
    n = max(R, C)
    dev = cost.device
    clipc = torch.tensor(clip_value(max_cost), dtype=torch.float32, device=dev)
    valid = (rows_valid[:, None] > 0) & (cols_valid[None, :] > 0)
    gated = torch.where(valid, torch.minimum(cost, clipc), clipc)
    sq = clipc.expand(n, n).clone()
    sq[:R, :C] = gated
    col4row = solve_lap(sq, work)[:R].to(torch.int64)
    a = torch.clamp(col4row, 0, C - 1)
    limit = torch.tensor(max_cost, dtype=torch.float32, device=dev)
    ok = ((col4row < C) & (rows_valid > 0) & (cols_valid[a] > 0) &
          (cost[torch.arange(R, device=dev), a] <= limit))
    return torch.where(ok, a, -1).to(torch.int32)


def _taken(assign: torch.Tensor, D: int) -> torch.Tensor:
    """(D,) bool: the detections some row of ``assign`` took."""
    hit = torch.zeros(D, dtype=torch.int32, device=assign.device)
    hit.index_add_(0, assign.clamp(min=0).to(torch.int64),
                   (assign >= 0).to(torch.int32))
    return hit > 0


def track_match_plain(cost1: torch.Tensor, iou_cost: torch.Tensor,
                      status: torch.Tensor, tsu: torch.Tensor,
                      det_valid: torch.Tensor,
                      max_cosine_distance: float = 0.2,
                      max_iou_distance: float = 0.7, max_age: int = 30,
                      work: Optional[torch.Tensor] = None):
    """The kernel's plain version: the appearance cascade (one
    ``min_cost_match`` on cost1 per track age level with an eligible row
    and column, freshest first) then IoU matching on iou_cost for tentative
    tracks and confirmed ones unmatched for one frame. → (assign (T,)
    int32, matched (D,) bool). ``work`` (2,) int, if given, gets (Dijkstra
    scans, solves) added. A stage without an eligible row or column is
    skipped: its ``min_cost_match`` would give −1 for every row."""
    T, D = cost1.shape
    dev = cost1.device
    confirmed = status == CONFIRMED
    assign1 = torch.full((T,), -1, dtype=torch.int32, device=dev)
    matched = torch.zeros(D, dtype=torch.bool, device=dev)
    solves = 0
    for level in range(max_age):
        rows = confirmed & (tsu == 1 + level) & (assign1 < 0)
        cols = det_valid & ~matched
        if not (bool(rows.any()) and bool(cols.any())):
            continue
        a = min_cost_match(cost1, max_cosine_distance, rows.float(),
                           cols.float(), work)
        solves += 1
        assign1 = torch.where(a >= 0, a, assign1)
        matched = matched | _taken(a, D)
    rows2 = (((status == TENTATIVE) | (confirmed & (tsu == 1)))
             & (assign1 < 0))
    cols2 = det_valid & ~matched
    assign2 = torch.full((T,), -1, dtype=torch.int32, device=dev)
    if bool(rows2.any()) and bool(cols2.any()):
        assign2 = min_cost_match(iou_cost, max_iou_distance, rows2.float(),
                                 cols2.float(), work)
        solves += 1
    assign = torch.where(assign1 >= 0, assign1, assign2)
    if work is not None:
        work[1] += solves
    return assign, _taken(assign, D)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _launch
    if _lib is not None:
        return _lib
    from paddlerobotics_torch.ops import build as kbuild

    lib, info = kbuild.build_library("track_match", SOURCE)
    fn = lib.prt_track_match
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.prt_tm_error_string.argtypes = [ctypes.c_int]
    lib.prt_tm_error_string.restype = ctypes.c_char_p
    build_info.update(info)
    _lib, _launch = lib, fn
    return lib


def _check(name, t, dtype, shape, dev):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def track_match(cost1: torch.Tensor, iou_cost: torch.Tensor,
                status: torch.Tensor, tsu: torch.Tensor,
                det_valid: torch.Tensor, max_cosine_distance: float = 0.2,
                max_iou_distance: float = 0.7, max_age: int = 30,
                work: Optional[torch.Tensor] = None):
    """The tracker's matching step; the kernel for CUDA tensors, the plain
    version (``track_match_plain``) for CPU tensors.

    cost1 and iou_cost (T,D) float32, status and tsu (T,) int32, det_valid
    (D,) bool, T and D at most 32 → (assign (T,) int32, matched (D,) bool).
    ``work`` (2,) int32 on the same device, if given, gets (Dijkstra scans,
    solves) added."""
    dev = cost1.device
    if dev.type == "cpu":
        return track_match_plain(cost1, iou_cost, status, tsu, det_valid,
                                 max_cosine_distance, max_iou_distance,
                                 max_age, work)
    if dev.type != "cuda":
        raise ValueError(f"track_match: unsupported device {dev}")
    T, D = cost1.shape
    if not (1 <= T <= MAX_N and 1 <= D <= MAX_N):
        raise ValueError(f"track_match: (T, D) = {(T, D)}, the kernel takes "
                         f"1..{MAX_N} of each")
    _check("cost1", cost1, torch.float32, (T, D), dev)
    _check("iou_cost", iou_cost, torch.float32, (T, D), dev)
    _check("status", status, torch.int32, (T,), dev)
    _check("tsu", tsu, torch.int32, (T,), dev)
    _check("det_valid", det_valid, torch.bool, (D,), dev)
    if work is not None:
        _check("work", work, torch.int32, (2,), dev)
    if _launch is None:
        build()
    assign = torch.empty(T, dtype=torch.int32, device=dev)
    matched = torch.empty(D, dtype=torch.bool, device=dev)
    ptrs = _PTRS(cost1.data_ptr(), iou_cost.data_ptr(), status.data_ptr(),
                 tsu.data_ptr(), det_valid.data_ptr(), assign.data_ptr(),
                 matched.data_ptr(), 0 if work is None else work.data_ptr())
    err = _launch(ptrs, T, D, max_age, max_cosine_distance,
                  clip_value(max_cosine_distance), max_iou_distance,
                  clip_value(max_iou_distance),
                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("track_match kernel launch failed: "
                           + _lib.prt_tm_error_string(err).decode())
    track_match.launches += 1
    return assign, matched


track_match.launches = 0
