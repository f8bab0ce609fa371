"""Procedural proactive-greeting scenes with learnable labels (port of the
JAX package's ``hri/synthetic_scene.py``).

A window holds F frames × K token slots. 0–3 "person" actors move through
the camera field on per-window trajectories (approach / leave / pass-by /
loiter); the other slots are background clutter or padding. A frame
triggers (``has_act`` = 1) iff some actor is near field (apparent bbox
height over a threshold), approaching (its bbox grew over the two frames
before) and facing the camera (an appearance direction). ``is_obj`` marks
the triggering actor's slot on triggering frames; ``act_ids`` on them is
``1 + band·2 + fast`` from the actor's salutation band and approach speed,
the null action 0 elsewhere. Fitting the labels takes appearance, position
and motion across frames.

Tokens keep the serving layout: ``visual_tokens`` are [512-d appearance |
50-d sin bbox pos-emb]; ``inst_crop`` emits (1280-d crop feature, 80-d
class scores, 50-d pos-emb); the instance family emits ``inst_fm``
(T,512,5,5) — appearance ⊗ a fixed 5×5 profile + cell noise —,
``inst_cls`` and ``inst_pos_emb``, each ``without_*`` ablation without the
key it drops.

Two generators:

- ``generate_windows`` (numpy, host): the JAX package's generator draw for
  draw, so one ``RandomState`` seed gives bit-equal windows in both
  packages; the held-out sets come from it.
- ``generate_windows_device`` (torch, on the card): the same batch keys,
  label rule and per-field distributions, drawn as batched tensor code
  from a ``torch.Generator`` (another stream than ``jax.random``'s).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.attention_ctrl import (INSTANCE_FAMILY,
                                                     variant_token_keys)

IM = 416.0              # letterboxed frame size (infer_v3.cpp:189-228)
NEAR_H = 170.0          # near-field apparent-height threshold (px)
GROW = 6.0              # min bbox-height growth (px over 2 frames)
FAST = 16.0             # fast-approach growth → distinct action id
BANDS = 3               # salutation bands (child / adult / elder)
NULL_ACT = 0

# action-id layout: 1 + band*2 + fast  ∈ [1, 6]
NUM_ACTIONS_MIN = 1 + BANDS * 2


# fixed 5×5 spatial profile for synthetic RoIAligned feature maps —
# center-weighted like a pooled object response; shared by the numpy
# and device generators so their distributions match
_FM_W = np.array([0.5, 0.8, 1.0, 0.8, 0.5], np.float32)
FM_SPATIAL = np.outer(_FM_W, _FM_W)
FM_CELL_NOISE = 0.05



def _unit(rng, d):
    v = rng.randn(d).astype(np.float32)
    return v / np.linalg.norm(v)


class ScenePrototypes:
    """Fixed random directions shared by generator draws (seeded)."""

    def __init__(self, appearance_dim: int, seed: int = 7):
        rng = np.random.RandomState(seed)
        self.person = _unit(rng, appearance_dim)
        self.facing = _unit(rng, appearance_dim)
        self.bands = [_unit(rng, appearance_dim) for _ in range(BANDS)]
        self.clutter = [_unit(rng, appearance_dim) for _ in range(8)]


def _pos_emb_np(bbox: np.ndarray) -> np.ndarray:
    """50-d sin pos-emb, numpy mirror of hri/utils.get_bbox_pos_emb
    (same formula; kept in numpy so generation never touches the
    device). bbox (..., 4) xyxy → (..., 50)."""
    bbox = np.asarray(bbox, np.float32)
    xmin, ymin, xmax, ymax = (bbox[..., 0], bbox[..., 1],
                              bbox[..., 2], bbox[..., 3])
    s = lambda v: (v - IM / 2) / (IM / 2) * (np.pi / 2)
    tx = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    x_pos = np.sin(s(xmin)[..., None] +
                   (s(xmax) - s(xmin))[..., None] * tx)     # (...,5)
    y_pos = np.sin(s(ymin)[..., None] +
                   (s(ymax) - s(ymin))[..., None] * tx)
    x_emb = np.broadcast_to(x_pos[..., None, :],
                            x_pos.shape[:-1] + (5, 5))
    y_emb = np.broadcast_to(y_pos[..., :, None],
                            y_pos.shape[:-1] + (5, 5))
    out = np.concatenate([y_emb.reshape(*y_emb.shape[:-2], 25),
                          x_emb.reshape(*x_emb.shape[:-2], 25)],
                         axis=-1)
    return out.astype(np.float32)


# Distribution-shift knobs (the JAX package's shift eval). Every key
# optional; defaults = the training distribution. The LABEL RULE
# (near-field ∧ approaching ∧ facing) is computed from the shifted
# trajectories themselves, so labels stay consistent under every shift —
# only the input distribution moves.
DEFAULT_SHIFT = {
    "n_actors": (0, 3),     # actors per window (train: randint(0,4))
    "rate_scale": 1.0,      # approach/leave speed multiplier
    "h0_range": (60.0, 150.0),   # initial bbox height (size regime)
    "app_noise": 0.25,      # appearance jitter σ
    "app_drift": 0.0,       # fixed unseen appearance offset magnitude
    "facing_p": 0.7,        # P(actor faces camera) — trigger-rate shift
    "clutter": (1, 5),      # clutter tokens per window
}


def _actor_track(rng, F: int, shift: dict | None = None):
    """One actor's bbox height/center trajectory + attributes."""
    s = shift or DEFAULT_SHIFT
    kind = rng.choice(["approach", "leave", "pass", "loiter"],
                      p=[0.4, 0.2, 0.2, 0.2])
    h0 = rng.uniform(*s.get("h0_range", (60.0, 150.0)))
    rs = s.get("rate_scale", 1.0)
    if kind == "approach":
        rate = rng.uniform(4.0, 22.0) * rs
    elif kind == "leave":
        rate = -rng.uniform(4.0, 14.0) * rs
    else:
        rate = rng.uniform(-1.5, 1.5)
    heights = h0 + rate * np.arange(F) + rng.randn(F) * 1.0
    heights = np.clip(heights, 24.0, 380.0)
    cx = rng.uniform(80.0, IM - 80.0)
    vx = rng.uniform(-14.0, 14.0) if kind == "pass" else rng.uniform(-4, 4)
    cxs = np.clip(cx + vx * np.arange(F) + rng.randn(F), 10.0, IM - 10.0)
    return {"heights": heights, "cxs": cxs,
            "facing": bool(rng.rand() < s.get("facing_p", 0.7)),
            "band": int(rng.randint(BANDS))}


def alloc_buffers(n: int, ctrl_cfg) -> dict:
    """Preallocate one reusable output-batch buffer set; pass the returned
    dict back to :func:`generate_windows` as ``out=`` so steady-state
    generation allocates no batch-sized array."""
    F, K = ctrl_cfg.num_frames, ctrl_cfg.tokens_per_frame
    keys = variant_token_keys(ctrl_cfg.inputs_type)
    T = F * K
    frame_ids = np.tile(np.repeat(np.arange(1, F + 1), K), (n, 1))
    out = {"frame_ids": frame_ids.astype(np.int64),
           "padding_mask": np.zeros((n, T), np.float32),
           "has_act": np.zeros((n, F), np.float32),
           "act_ids": np.zeros((n, F), np.int64),
           "is_obj": np.zeros((n, T), np.float32)}
    if ctrl_cfg.inputs_type == "inst_crop":
        out["inst_crop_feat"] = np.zeros((n, T, 1280), np.float32)
        out["inst_cls"] = np.zeros((n, T, ctrl_cfg.inst_cls_dim),
                                   np.float32)
        out["inst_pos_emb"] = np.zeros((n, T, 50), np.float32)
    elif ctrl_cfg.inputs_type in INSTANCE_FAMILY:
        # raw serving triple, pruned to exactly what the ablation keeps
        # (inst_fm is ~10 MB/window — never allocated when dropped)
        if "inst_fm" in keys:
            out["inst_fm"] = np.zeros((n, T, 512, 5, 5), np.float32)
        if "inst_cls" in keys:
            out["inst_cls"] = np.zeros((n, T, ctrl_cfg.inst_cls_dim),
                                       np.float32)
        if "inst_pos_emb" in keys:
            out["inst_pos_emb"] = np.zeros((n, T, 50), np.float32)
    else:
        # 562-d serving token layout: [512 appearance | 50 pos-emb],
        # written in place (a final concatenate would re-fault the
        # whole batch every call)
        out["visual_tokens"] = np.zeros((n, T, 562), np.float32)
    # touch every page once so reuse never faults
    for k, a in out.items():
        if k != "frame_ids":
            a.fill(0)
    return out


def generate_windows(rng: np.random.RandomState, n: int, ctrl_cfg,
                     protos: ScenePrototypes | None = None,
                     out: dict | None = None,
                     shift: dict | None = None) -> dict:
    """n training windows shaped for ctrl_cfg.inputs_type.

    Returns the trainer batch dict (leading axis n). All arrays numpy;
    callers move them to a device as needed. Pass ``out`` (from
    :func:`alloc_buffers`) to generate in place with zero allocation —
    the caller must finish consuming (e.g. copying) the previous
    contents first. ``shift`` (DEFAULT_SHIFT keys) moves the scene
    distribution for robustness evals; the label rule follows the
    shifted trajectories.
    """
    F, K = ctrl_cfg.num_frames, ctrl_cfg.tokens_per_frame
    crop = ctrl_cfg.inputs_type == "inst_crop"
    app_dim = 1280 if crop else 512
    protos = protos or ScenePrototypes(app_dim)
    s = {**DEFAULT_SHIFT, **(shift or {})}
    a_lo, a_hi = s["n_actors"]
    c_lo, c_hi = s["clutter"]
    app_noise = s["app_noise"]
    drift = (s["app_drift"] * _unit(np.random.RandomState(1234), app_dim)
             if s["app_drift"] else None)

    if out is None:
        out = alloc_buffers(n, ctrl_cfg)
    else:
        for k, a in out.items():
            if k != "frame_ids":
                a.fill(0)
    pad, has_act, is_obj, act_ids = (out["padding_mask"], out["has_act"],
                                     out["is_obj"], out["act_ids"])
    fm = out.get("inst_fm")
    if crop:
        toks, cls, pos = (out["inst_crop_feat"], out["inst_cls"],
                          out["inst_pos_emb"])
    elif ctrl_cfg.inputs_type in INSTANCE_FAMILY:
        # appearance goes into the RoI feature maps (if kept); cls/pos
        # are whatever this ablation retains
        toks, cls, pos = None, out.get("inst_cls"), out.get("inst_pos_emb")
    else:
        vt = out["visual_tokens"]
        toks, pos, cls = vt[..., :app_dim], vt[..., app_dim:], None

    t_idx = np.arange(F)
    for w in range(n):
        n_act = rng.randint(a_lo, min(a_hi, K - 1) + 1)
        actors = [_actor_track(rng, F, s) for _ in range(n_act)]
        n_clut = rng.randint(c_lo, c_hi + 1)
        for slot, a in enumerate(actors):
            i = t_idx * K + slot                    # (F,) flat indices
            h = a["heights"]
            wd = h * 0.45
            bbox = np.stack([a["cxs"] - wd / 2, IM - 40 - h,
                             a["cxs"] + wd / 2,
                             np.full(F, IM - 40.0)], axis=-1)
            app = (protos.person + 0.6 * protos.bands[a["band"]]
                   + (0.6 * protos.facing if a["facing"] else 0.0)
                   + app_noise * rng.randn(F, app_dim)).astype(np.float32)
            if drift is not None:
                app = app + drift
            if toks is not None:
                toks[w, i, :] = app
            if fm is not None:
                fm[w, i] = (app[:, :, None, None] * FM_SPATIAL
                            + FM_CELL_NOISE
                            * rng.randn(F, app_dim, 5, 5))
            if cls is not None:
                cls[w, i, 0] = 1.0 + 0.1 * rng.randn(F)  # person score
            if pos is not None:
                pos[w, i] = _pos_emb_np(bbox)
            pad[w, i] = 1.0
            grow = np.where(t_idx >= 2,
                            h - h[np.maximum(t_idx - 2, 0)], 0.0)
            trig = (h >= NEAR_H) & (grow >= GROW) & a["facing"]
            has_act[w, trig] = 1.0
            is_obj[w, i[trig]] = 1.0
            act_ids[w, trig] = (1 + a["band"] * 2 +
                                (grow[trig] >= FAST))
        n_c = min(n_clut, K - n_act)
        if n_c > 0:
            slots = n_act + np.arange(n_c)
            i = (t_idx[:, None] * K + slots[None, :]).ravel()   # (F*n_c,)
            cprotos = np.stack([protos.clutter[c % len(protos.clutter)]
                                for c in range(n_c)])
            app = (np.tile(cprotos, (F, 1))
                   + app_noise * rng.randn(F * n_c, app_dim)
                   ).astype(np.float32)
            if drift is not None:
                app = app + drift
            if toks is not None:
                toks[w, i] = app
            if fm is not None:
                fm[w, i] = (app[:, :, None, None] * FM_SPATIAL
                            + FM_CELL_NOISE
                            * rng.randn(F * n_c, app_dim, 5, 5))
            if cls is not None:
                ccls = 1 + rng.randint(ctrl_cfg.inst_cls_dim - 1,
                                       size=F * n_c)
                cls[w, i, ccls] = 1.0
            if pos is not None:
                cb = np.sort(rng.uniform(0, IM, (F * n_c, 2)), axis=-1)
                pos[w, i] = _pos_emb_np(
                    np.stack([cb[:, 0], cb[:, 0], cb[:, 1], cb[:, 1]],
                             axis=-1))
            pad[w, i] = 1.0

    return out




# ---------------------------------------------------------------------------
# On-device generation. The numpy generator above runs window by window on
# the host and copies ~F·K·562·4 bytes per window to the card; this one
# draws the same distributions as batched tensor code on the card, so a
# training feed never leaves it. The held-out sets stay on the numpy
# generator, so convergence doubles as a check of the two distributions
# against each other.

MAX_ACTORS = 3          # rng.randint(0, 4) above
MAX_CLUTTER = 5         # rng.randint(1, 6) above
# cumulative probabilities of approach | leave | pass (| loiter)
_KIND_CUM = (0.4, 0.6, 0.8)


def device_prototypes(ctrl_cfg, seed: int = 7, device=None) -> dict:
    """``ScenePrototypes`` (the same seeded draws) as tensors on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    p = ScenePrototypes(1280 if ctrl_cfg.inputs_type == "inst_crop"
                        else 512, seed=seed)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    return {"person": t(p.person), "facing": t(p.facing),
            "bands": t(np.stack(p.bands)),
            "clutter": t(np.stack(p.clutter[:MAX_CLUTTER]))}


def _pos_emb_dev(bbox: torch.Tensor) -> torch.Tensor:
    """Torch mirror of ``_pos_emb_np``, the same [y(25) | x(25)] layout."""
    xmin, ymin, xmax, ymax = bbox.unbind(-1)
    s = lambda v: (v - IM / 2) / (IM / 2) * (math.pi / 2)
    tx = torch.linspace(0.0, 1.0, 5, device=bbox.device)
    x_pos = torch.sin(s(xmin)[..., None] + (s(xmax) - s(xmin))[..., None] * tx)
    y_pos = torch.sin(s(ymin)[..., None] + (s(ymax) - s(ymin))[..., None] * tx)
    x_emb = x_pos[..., None, :].expand(*x_pos.shape[:-1], 5, 5)
    y_emb = y_pos[..., :, None].expand(*y_pos.shape[:-1], 5, 5)
    return torch.cat([y_emb.reshape(*y_emb.shape[:-2], 25),
                      x_emb.reshape(*x_emb.shape[:-2], 25)], dim=-1)


def generate_windows_device(generator: torch.Generator | None, n: int,
                            ctrl_cfg, protos: dict | None = None,
                            shift: dict | None = None,
                            device=None) -> dict:
    """n windows on the card (unless ``device`` says otherwise), drawn from
    ``generator`` (a fresh one seeded 0 when None; it must live on
    ``device``): the batch keys, label rule and per-field distributions of
    :func:`generate_windows`, from another random stream. ``shift`` honours
    the keys h0_range, rate_scale, facing_p and app_noise, as the JAX
    package's device generator does.

    Every window draws at most ``MAX_ACTORS`` actors and ``MAX_CLUTTER``
    clutter tokens at once; actors fill slots [0, n_act) and clutter the
    next n_c slots, the rest is padding (zero tokens)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device)
        generator.manual_seed(0)
    elif generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, windows on "
                         f"{device}")
    pp = protos if protos is not None else device_prototypes(ctrl_cfg,
                                                             device=device)
    s = {**DEFAULT_SHIFT, **(shift or {})}
    h0_min, h0_max = (float(v) for v in s["h0_range"])
    rs, facing_p = float(s["rate_scale"]), float(s["facing_p"])
    app_noise = float(s["app_noise"])
    F, K = ctrl_cfg.num_frames, ctrl_cfg.tokens_per_frame
    keys = variant_token_keys(ctrl_cfg.inputs_type)
    cls_dim = ctrl_cfg.inst_cls_dim
    A, C = MAX_ACTORS, MAX_CLUTTER
    D = pp["person"].shape[0]
    t = torch.arange(F, dtype=torch.float32, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * rand(*shape)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=generator,
                             device=device)

    # --- actors (n, A): trajectories, attributes, labels
    n_act = randint(0, A + 1, n)
    kind = torch.bucketize(rand(n, A), torch.tensor(_KIND_CUM, device=device),
                           right=True)          # 0 approach … 3 loiter
    h0 = uniform(h0_min, h0_max, n, A)
    rate = torch.where(kind == 0, uniform(4.0 * rs, 22.0 * rs, n, A),
                       torch.where(kind == 1,
                                   -uniform(4.0 * rs, 14.0 * rs, n, A),
                                   uniform(-1.5, 1.5, n, A)))
    h = (h0[..., None] + rate[..., None] * t + randn(n, A, F)).clamp(24.0,
                                                                   380.0)
    cx = uniform(80.0, IM - 80.0, n, A)
    vx = torch.where(kind == 2, uniform(-14.0, 14.0, n, A),
                     uniform(-4.0, 4.0, n, A))
    cxs = (cx[..., None] + vx[..., None] * t + randn(n, A, F)).clamp(
        10.0, IM - 10.0)
    facing = rand(n, A) < facing_p
    band = randint(0, BANDS, n, A)
    a_active = torch.arange(A, device=device) < n_act[:, None]

    a_base = (pp["person"] + 0.6 * pp["bands"][band]
              + 0.6 * facing[..., None].float() * pp["facing"])  # (n,A,D)
    app = a_base[:, :, None] + app_noise * randn(n, A, F, D)
    wd = h * 0.45
    bbox = torch.stack([cxs - wd / 2, IM - 40.0 - h, cxs + wd / 2,
                        torch.full_like(h, IM - 40.0)], dim=-1)
    a_pos = _pos_emb_dev(bbox)                                   # (n,A,F,50)

    grow = torch.zeros_like(h)
    grow[..., 2:] = h[..., 2:] - h[..., :-2]
    trig = ((h >= NEAR_H) & (grow >= GROW) & facing[..., None]
            & a_active[..., None])                               # (n,A,F)
    act_val = 1 + band[..., None] * 2 + (grow >= FAST).long()
    act_ids = torch.zeros(n, F, dtype=torch.int64, device=device)
    for a in range(A):                      # slot order: the last one wins
        act_ids = torch.where(trig[:, a], act_val[:, a], act_ids)
    has_act = trig.any(dim=1).float()

    # --- clutter (n, C)
    n_clut = randint(1, C + 1, n)
    n_c = torch.minimum(n_clut, K - n_act)
    c_app = pp["clutter"][None, :, None] + app_noise * randn(n, C, F, D)
    cb = uniform(0.0, IM, n, C, F, 2).sort(dim=-1).values
    c_pos = _pos_emb_dev(torch.stack(
        [cb[..., 0], cb[..., 0], cb[..., 1], cb[..., 1]], dim=-1))

    # --- slots: which candidate (actors 0..A-1, clutter A..A+C-1) each of
    # the K slots holds
    slot = torch.arange(K, device=device)
    is_act = slot < n_act[:, None]                               # (n,K)
    occupied = slot < (n_act + n_c)[:, None]
    cand = torch.where(is_act, slot, A + slot - n_act[:, None]).clamp(
        0, A + C - 1)
    pad = occupied.float()
    rows = torch.arange(n, device=device)[:, None]

    def place(x):
        """(n, A+C, F, ...) candidates → (n, F·K, ...) slots, zero where
        padding."""
        g = x[rows, cand]                                        # (n,K,F,..)
        g = g * pad.reshape(n, K, *([1] * (g.dim() - 2)))
        return g.transpose(1, 2).reshape(n, F * K, *x.shape[3:])

    cand_app = torch.cat([app, c_app], dim=1)                    # (n,A+C,F,D)
    cand_pos = torch.cat([a_pos, c_pos], dim=1)
    out = {"frame_ids": torch.arange(1, F + 1, device=device)
           .repeat_interleave(K)[None].expand(n, F * K).contiguous(),
           "padding_mask": pad[:, None].expand(n, F, K).reshape(n, F * K),
           "has_act": has_act, "act_ids": act_ids,
           "is_obj": place(torch.cat([trig.float(),
                                      trig.new_zeros(n, C, F).float()],
                                     dim=1))}
    if "visual_tokens" in keys:
        out["visual_tokens"] = place(torch.cat([cand_app, cand_pos], -1))
        return out
    if "inst_cls" in keys:
        a_cls = torch.zeros(n, A, F, cls_dim, device=device)
        a_cls[..., 0] = 1.0 + 0.1 * randn(n, A, F)
        c_cls = torch.nn.functional.one_hot(
            1 + randint(0, cls_dim - 1, n, C, F), cls_dim).float()
        out["inst_cls"] = place(torch.cat([a_cls, c_cls], dim=1))
    if "inst_crop_feat" in keys:
        out["inst_crop_feat"] = place(cand_app)
    if "inst_fm" in keys:
        # appearance ⊗ the fixed spatial profile + cell noise, per slot
        spatial = torch.as_tensor(FM_SPATIAL, device=device)
        out["inst_fm"] = ((place(cand_app)[..., None, None] * spatial
                           + FM_CELL_NOISE * randn(n, F * K, D, 5, 5))
                          * out["padding_mask"][..., None, None, None])
    if "inst_pos_emb" in keys:
        out["inst_pos_emb"] = place(cand_pos)
    return out
