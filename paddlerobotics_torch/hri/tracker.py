"""Multi-object tracker: Deep-SORT on fixed-shape tensors (port of the JAX
package's ``hri/tracker.py``).

A constant-velocity Kalman filter over (cx, cy, aspect, height) with the
1/20 and 1/160 noise weights and chi² gating; the appearance (cosine)
cascade for confirmed tracks under motion gating, IoU matching after it;
the tentative → confirmed → deleted lifecycle. Tracks live in MAX_TRACKS
slots, so a frame's update has fixed shapes and reads nothing back to the
host: the Kalman algebra is batched over the slots (``torch.linalg.inv_ex``
and ``solve_ex``, which skip the error check that would synchronise), and
the matching step is one call of ``ops/lap.track_match``, the CUDA kernel
on the card and its plain version on the CPU.

The Kalman functions take any leading batch dims: a single track (8,),
(8,8) as in the JAX package, or all slots at once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.utils import iou_matrix, l2_normalize
from paddlerobotics_torch.ops import lap
from paddlerobotics_torch.ops.lap import CONFIRMED, EMPTY, TENTATIVE

MAX_TRACKS = 32
FEATURE_DIM = 128
CHI2_95_DOF4 = 9.4877   # chi2inv95[4]
INF = 1e9

_W_POS = 1.0 / 20.0
_W_VEL = 1.0 / 160.0


class TrackerState(NamedTuple):
    mean: torch.Tensor        # (T,8) [cx,cy,a,h, vx,vy,va,vh]
    cov: torch.Tensor         # (T,8,8)
    status: torch.Tensor      # (T,) int32 EMPTY|TENTATIVE|CONFIRMED
    hits: torch.Tensor        # (T,) int32
    time_since_update: torch.Tensor  # (T,) int32
    feature: torch.Tensor     # (T,FEATURE_DIM) smoothed appearance
    track_id: torch.Tensor    # (T,) int32
    next_id: torch.Tensor     # () int32


def init_tracker(device=None) -> TrackerState:
    """An empty tracker on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    z = lambda *s: torch.zeros(s, device=dev)
    zi = lambda: torch.zeros(MAX_TRACKS, dtype=torch.int32, device=dev)
    return TrackerState(
        mean=z(MAX_TRACKS, 8), cov=z(MAX_TRACKS, 8, 8), status=zi(),
        hits=zi(), time_since_update=zi(), feature=z(MAX_TRACKS, FEATURE_DIM),
        track_id=zi(), next_id=torch.ones((), dtype=torch.int32, device=dev))


# --- Kalman filter -------------------------------------------------------------

def _motion_mats(dev):
    F = torch.eye(8, device=dev)
    F[:4, 4:] += torch.eye(4, device=dev)
    return F, torch.eye(4, 8, device=dev)


def _diag_noise(h: torch.Tensor, std, unit) -> torch.Tensor:
    """diag((std · scale)²), scale h at every entry but the aspect ones."""
    std = torch.tensor(std, device=h.device)
    scale = torch.where(torch.tensor(unit, device=h.device), 1.0, h[..., None])
    return torch.diag_embed((std * scale) ** 2)


def kf_initiate(measurement: torch.Tensor):
    """measurement (...,4) = (cx,cy,a,h) → (mean (...,8), cov (...,8,8))."""
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    cov = _diag_noise(measurement[..., 3],
                      [2 * _W_POS, 2 * _W_POS, 1e-2, 2 * _W_POS,
                       10 * _W_VEL, 10 * _W_VEL, 1e-5, 10 * _W_VEL],
                      [False, False, True, False] * 2)
    return mean, cov


def kf_predict(mean: torch.Tensor, cov: torch.Tensor):
    F, _ = _motion_mats(mean.device)
    Q = _diag_noise(mean[..., 3], [_W_POS, _W_POS, 1e-2, _W_POS,
                                   _W_VEL, _W_VEL, 1e-5, _W_VEL],
                    [False, False, True, False] * 2)
    return (F @ mean[..., None])[..., 0], F @ cov @ F.T + Q


def kf_project(mean: torch.Tensor, cov: torch.Tensor):
    _, H = _motion_mats(mean.device)
    R = _diag_noise(mean[..., 3], [_W_POS, _W_POS, 1e-1, _W_POS],
                    [False, False, True, False])
    return (H @ mean[..., None])[..., 0], H @ cov @ H.T + R


def kf_update(mean, cov, measurement):
    _, H = _motion_mats(mean.device)
    pm, pc = kf_project(mean, cov)
    K = cov @ H.T @ torch.linalg.inv_ex(pc)[0]
    new_mean = mean + (K @ (measurement - pm)[..., None])[..., 0]
    new_cov = cov - K @ pc @ K.transpose(-1, -2)
    return new_mean, new_cov


def kf_gating_distance(mean, cov, measurements):
    """Squared Mahalanobis distance of measurements (M,4) → (...,M)."""
    pm, pc = kf_project(mean, cov)
    d = measurements - pm[..., None, :]                   # (...,M,4)
    sol = torch.linalg.solve_ex(pc, d.transpose(-1, -2))[0]   # (...,4,M)
    return (d.transpose(-1, -2) * sol).sum(dim=-2)


# --- boxes ↔ measurements --------------------------------------------------------

def xyxy_to_cah(boxes: torch.Tensor) -> torch.Tensor:
    """xyxy → (cx, cy, aspect=w/h, h)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    cx = boxes[..., 0] + w / 2
    cy = boxes[..., 1] + h / 2
    return torch.stack([cx, cy, w / h, h], dim=-1)


def cah_to_xyxy(m: torch.Tensor) -> torch.Tensor:
    h = m[..., 3]
    w = m[..., 2] * h
    return torch.stack([m[..., 0] - w / 2, m[..., 1] - h / 2,
                        m[..., 0] + w / 2, m[..., 1] + h / 2], dim=-1)


# --- greedy assignment -----------------------------------------------------------

def greedy_match(cost: torch.Tensor, max_cost: float,
                 rows_valid: torch.Tensor, cols_valid: torch.Tensor):
    """Greedy min-cost matching. cost (R,C) → col_for_row (R,) int32 (−1
    none): min(R,C) rounds, each taking the global minimum."""
    R, C = cost.shape
    big = cost + INF * (1 - rows_valid[:, None]) + \
        INF * (1 - cols_valid[None, :])
    assign = torch.full((R,), -1, dtype=torch.int32, device=cost.device)
    rows = torch.arange(R, device=cost.device)
    cols = torch.arange(C, device=cost.device)
    for _ in range(min(R, C)):
        idx = torch.argmin(big)
        r, c = idx // C, idx % C
        ok = big[r, c] <= max_cost
        assign = torch.where(ok & (rows == r), c.to(torch.int32), assign)
        hit = (rows[:, None] == r) | (cols[None, :] == c)
        cell = (rows[:, None] == r) & (cols[None, :] == c)
        big = torch.where(torch.where(ok, hit, cell), INF, big)
    return assign


# --- tracker update --------------------------------------------------------------

def tracker_predict(state: TrackerState) -> TrackerState:
    """Advance all live tracks one frame."""
    mean, cov = kf_predict(state.mean, state.cov)
    live = state.status > EMPTY
    return state._replace(
        mean=torch.where(live[:, None], mean, state.mean),
        cov=torch.where(live[:, None, None], cov, state.cov),
        time_since_update=state.time_since_update + live.to(torch.int32))


def tracker_update(state: TrackerState, boxes: torch.Tensor,
                   features: torch.Tensor, det_valid: torch.Tensor,
                   max_cosine_distance: float = 0.2,
                   max_iou_distance: float = 0.7, max_age: int = 30,
                   n_init: int = 3) -> Tuple[TrackerState, torch.Tensor]:
    """One Deep-SORT update with D detections (fixed shape).

    boxes (D,4) xyxy, features (D,FEATURE_DIM), det_valid (D,) bool →
    (new_state, track id per detection (D,) int32, 0 where unassigned)."""
    D = boxes.shape[0]
    dev = boxes.device
    det_valid = det_valid.to(torch.bool)
    meas = xyxy_to_cah(boxes)

    # 1-2) the matching step: the gated appearance cost and the IoU cost
    cos_cost = 1.0 - l2_normalize(state.feature) @ l2_normalize(features).T
    gate = kf_gating_distance(state.mean, state.cov, meas)       # (T,D)
    cost1 = torch.where(gate > CHI2_95_DOF4, INF, cos_cost)
    iou_cost = 1.0 - iou_matrix(cah_to_xyxy(state.mean[:, :4]), boxes)
    assign, det_matched = lap.track_match(
        cost1.contiguous(), iou_cost.contiguous(), state.status,
        state.time_since_update, det_valid, max_cosine_distance,
        max_iou_distance, max_age)

    # 3) update matched tracks
    a = assign.clamp(min=0).to(torch.int64)
    new_mean, new_cov = kf_update(state.mean, state.cov, meas[a])
    matched = assign >= 0
    mean = torch.where(matched[:, None], new_mean, state.mean)
    cov = torch.where(matched[:, None, None], new_cov, state.cov)
    hits = torch.where(matched, state.hits + 1, state.hits)
    tsu = torch.where(matched, 0, state.time_since_update)
    feat = torch.where(matched[:, None],
                       0.5 * state.feature + 0.5 * features[a],
                       state.feature)
    status = state.status
    status = torch.where(matched & (status == TENTATIVE) & (hits >= n_init),
                         CONFIRMED, status)
    # deletion: tentative missed once, confirmed too old
    status = torch.where((status == TENTATIVE) & ~matched & (tsu > 0),
                         EMPTY, status)
    status = torch.where(tsu > max_age, EMPTY, status).to(torch.int32)

    # 4) initiate: the k-th unmatched detection takes the k-th EMPTY slot
    #    (the JAX package's scan puts each into the first EMPTY slot), the
    #    rest are dropped
    new_dets = det_valid & ~det_matched
    det_rank = torch.cumsum(new_dets.to(torch.int64), 0) - 1
    det_of_rank = torch.full((D + 1,), -1, dtype=torch.int64, device=dev)
    det_of_rank.scatter_(0, torch.where(new_dets, det_rank, D),
                         torch.arange(D, device=dev))
    det_of_rank[D] = -1
    empty = status == EMPTY
    slot_rank = torch.cumsum(empty.to(torch.int64), 0) - 1
    d_slot = det_of_rank[torch.where(empty, slot_rank.clamp(max=D), D)]
    can = empty & (d_slot >= 0)
    d = d_slot.clamp(min=0)
    m0, c0 = kf_initiate(meas[d])
    one = torch.ones_like(status)
    st = TrackerState(
        mean=torch.where(can[:, None], m0, mean),
        cov=torch.where(can[:, None, None], c0, cov),
        status=torch.where(can, one * TENTATIVE, status),
        hits=torch.where(can, one, hits),
        time_since_update=torch.where(can, 0 * one, tsu),
        feature=torch.where(can[:, None], features[d], feat),
        track_id=torch.where(can, state.next_id + slot_rank.to(torch.int32),
                             state.track_id),
        next_id=state.next_id + can.sum().to(torch.int32))

    # per-detection track ids
    det_tid = torch.zeros(D, dtype=torch.int32, device=dev)
    det_tid.index_add_(0, a, torch.where(matched, st.track_id, 0))
    return st, det_tid
