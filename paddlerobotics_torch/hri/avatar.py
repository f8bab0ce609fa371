"""Robot avatar renderer (port of the JAX package's ``hri/avatar.py``, a
rebuild of HRI/TFVT_HRI/avatar/avatar.py; host code: numpy and cv2).

Frame-accurate numpy/cv2 compositor — no moviepy dependency (the
reference hard-depends on moviepy; this rebuild composites per-frame in
numpy so it runs in headless images).  Timeline semantics mirror
avatar.py:62-103 exactly:

- the base **action** clip sets the output duration and fps;
- the **expression** slot at ``EXP_POS`` plays ``null`` for the first
  ``dft_exp_dt`` seconds, then the chosen expression clip, then ``null``
  again to fill out the action's duration (avatar.py:78-97);
- non-empty **talk** text renders as a green caption centered at
  ``TALK_Y`` for the whole clip (avatar.py:83-86);
- a non-null **movement** png overlays centered at ``MOVE_Y``
  (avatar.py:99-101);
- an optional ``cache_dir`` keyed by the macro action short-circuits
  re-renders (avatar.py:66-73).

Assets layout (avatar.py:14-51): ``action/*.mp4`` base clips,
``expression/*.mp4`` resized to width ``EXP_WIDTH`` on load,
``movement/*.png`` static overlays (alpha respected).  ``.avi`` assets
are accepted too (useful where no mp4 encoder exists).
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

EXP_WIDTH = 168          # expression clip width (avatar.py:41)
EXP_POS = (291, 160)     # expression top-left (avatar.py:78)
TALK_Y = 50              # caption y (avatar.py:85)
MOVE_Y = 650             # movement strip y (avatar.py:100)
TALK_COLOR = (0, 255, 0)  # green caption (avatar.py:84)


def get_macro_act_key(talk: str, act: str, exp: str, move: str) -> str:
    """Stable cache key for one macro action (common/utils
    get_macro_act_key role; content-hashed so any talk string is a
    valid filename)."""
    blob = "\x1f".join([talk, act, exp, move]).encode("utf-8")
    return hashlib.md5(blob).hexdigest()


def _load_video(path: str) -> Tuple[List[np.ndarray], float]:
    """Decode a clip to RGB frames + fps."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise FileNotFoundError(f"no decodable frames in {path}")
    return frames, float(fps)


def _resize_width(frame: np.ndarray, width: int) -> np.ndarray:
    import cv2

    h, w = frame.shape[:2]
    nh = max(1, round(h * width / w))
    return cv2.resize(frame, (width, nh), interpolation=cv2.INTER_AREA)


def _overlay(dst: np.ndarray, src: np.ndarray, x: int, y: int,
             alpha: Optional[np.ndarray] = None) -> None:
    """Paste ``src`` onto ``dst`` at (x, y), clipped, optionally
    alpha-blended (in place)."""
    H, W = dst.shape[:2]
    h, w = src.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x0 >= x1 or y0 >= y1:
        return
    sx, sy = x0 - x, y0 - y
    patch = src[sy:sy + (y1 - y0), sx:sx + (x1 - x0)]
    if alpha is None:
        dst[y0:y1, x0:x1] = patch
    else:
        a = alpha[sy:sy + (y1 - y0), sx:sx + (x1 - x0)][..., None]
        region = dst[y0:y1, x0:x1].astype(np.float32)
        dst[y0:y1, x0:x1] = (a * patch + (1.0 - a) * region).astype(
            np.uint8)


def _wrap_text(text: str, max_chars: int) -> List[str]:
    lines, cur = [], ""
    for word in text.split():
        cand = (cur + " " + word).strip()
        if len(cand) > max_chars and cur:
            lines.append(cur)
            cur = word
        else:
            cur = cand
    if cur:
        lines.append(cur)
    return lines or [""]


class RobotAvatar:
    """Clip compositor with asset + render caches (avatar.py:11-103)."""

    def __init__(self, assets_path: str, cache_dir: Optional[str] = None):
        self.assets_path = assets_path
        self.cache_dir = cache_dir
        self.act_assets: Dict[str, Tuple[List[np.ndarray], float]] = {}
        self.exp_assets: Dict[str, List[np.ndarray]] = {}
        self.move_assets: Dict[str, Tuple[np.ndarray,
                                          Optional[np.ndarray]]] = {}
        self._read_act_assets(os.path.join(assets_path, "action"))
        self._read_exp_assets(os.path.join(assets_path, "expression"))
        self._read_move_assets(os.path.join(assets_path, "movement"))

    # -- asset loading (avatar.py:22-51) --------------------------------
    @staticmethod
    def _clip_files(path: str) -> List[str]:
        if not os.path.isdir(path):
            return []
        return [f for f in sorted(os.listdir(path))
                if f.endswith((".mp4", ".avi"))]

    def _read_act_assets(self, path: str) -> None:
        for f in self._clip_files(path):
            self.act_assets[os.path.splitext(f)[0]] = _load_video(
                os.path.join(path, f))

    def _read_exp_assets(self, path: str) -> None:
        for f in self._clip_files(path):
            frames, _ = _load_video(os.path.join(path, f))
            self.exp_assets[os.path.splitext(f)[0]] = [
                _resize_width(fr, EXP_WIDTH) for fr in frames]

    def _read_move_assets(self, path: str) -> None:
        import cv2

        if not os.path.isdir(path):
            return
        for f in sorted(os.listdir(path)):
            if not f.endswith(".png"):
                continue
            img = cv2.imread(os.path.join(path, f), cv2.IMREAD_UNCHANGED)
            if img is None:
                continue
            if img.ndim == 3 and img.shape[2] == 4:
                rgb = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2RGB)
                alpha = img[..., 3].astype(np.float32) / 255.0
            else:
                rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                alpha = None
            self.move_assets[os.path.splitext(f)[0]] = (rgb, alpha)

    @property
    def available(self) -> bool:
        return bool(self.act_assets)

    # -- compositing -----------------------------------------------------
    def _exp_frame_at(self, t: float, exp: str,
                      dft_exp_dt: float, fps: float) -> np.ndarray:
        """Expression timeline: null | chosen exp | null (avatar.py:78-97).
        Each segment plays its clip from ITS OWN start (set_start)."""
        null = self.exp_assets["null"]
        chosen = self.exp_assets[exp]
        exp_dur = len(chosen) / fps
        if t < dft_exp_dt:
            seg, t0 = null, 0.0
        elif t < dft_exp_dt + exp_dur:
            seg, t0 = chosen, dft_exp_dt
        else:
            seg, t0 = null, dft_exp_dt + exp_dur
        i = min(int((t - t0) * fps), len(seg) - 1)
        return seg[i]

    def _draw_talk(self, frame: np.ndarray, talk: str) -> None:
        import cv2

        W = frame.shape[1]
        font, scale, thick = cv2.FONT_HERSHEY_SIMPLEX, 0.8, 2
        # caption-style wrap (reference wraps via method='caption')
        for li, line in enumerate(_wrap_text(talk, max(8, W // 18))):
            (tw, th), _ = cv2.getTextSize(line, font, scale, thick)
            org = ((W - tw) // 2, TALK_Y + li * int(th * 1.6) + th)
            cv2.putText(frame, line, org, font, scale, TALK_COLOR, thick,
                        cv2.LINE_AA)

    def render(self, talk: str, act: str, exp: str, move: str,
               render_video: str, dft_exp_dt: float = 0.2) -> str:
        """Composite one macro action into ``render_video``
        (avatar.py:62-103) and return the written path."""
        if not self.available:
            raise FileNotFoundError(
                f"no action assets under {self.assets_path}")
        cache_video = None
        if self.cache_dir is not None:
            ext = os.path.splitext(render_video)[1] or ".mp4"
            cache_video = os.path.join(
                self.cache_dir, get_macro_act_key(talk, act, exp, move) + ext)
            if os.path.exists(cache_video):
                shutil.copyfile(cache_video, render_video)
                return render_video

        from paddlerobotics_torch.hri.video import VideoWriter

        act_frames, fps = self.act_assets[act]
        writer = VideoWriter(render_video, fps=fps)
        for i, base in enumerate(act_frames):
            frame = base.copy()
            t = i / fps
            ef = self._exp_frame_at(t, exp, dft_exp_dt, fps)
            _overlay(frame, ef, EXP_POS[0], EXP_POS[1])
            if talk:
                self._draw_talk(frame, talk)
            if move != "null" and move in self.move_assets:
                mv, alpha = self.move_assets[move]
                x = (frame.shape[1] - mv.shape[1]) // 2
                _overlay(frame, mv, x, MOVE_Y, alpha)
            writer.write(frame)
        writer.close()

        if cache_video is not None:
            os.makedirs(self.cache_dir, exist_ok=True)
            shutil.copyfile(render_video, cache_video)
        return render_video
