"""Video IO and visualisation (port of the JAX package's ``hri/video.py``,
which imports no JAX): clip → frames decode, frame writer, bbox drawing.
File I/O on the host through ``cv2``, imported where it is used."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def clip_video_to_frames(path: str, start: float = 0.0,
                         end: Optional[float] = None,
                         stride: int = 1) -> List[np.ndarray]:
    """Decode [start, end] seconds of a video to RGB frames
    (video.py:8-60)."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.set(cv2.CAP_PROP_POS_FRAMES, int(start * fps))
    n_end = int(end * fps) if end is not None else np.inf
    frames, i = [], int(start * fps)
    while i < n_end:
        ok, img = cap.read()
        if not ok:
            break
        if (i - int(start * fps)) % stride == 0:
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    return frames


class VideoWriter:
    """Frame-by-frame mp4 writer (video.py VideoWriter)."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, frame_rgb: np.ndarray):
        import cv2

        if self._writer is None:
            h, w = frame_rgb.shape[:2]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        self._writer.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def close(self):
        if self._writer is not None:
            self._writer.release()


def draw_instances(frame: np.ndarray, boxes: Sequence, labels=None,
                   scores=None, color=(0, 255, 0)) -> np.ndarray:
    """Annotate detections on a frame (visualize.py draw semantics)."""
    import cv2

    out = frame.copy()
    for i, b in enumerate(boxes):
        x0, y0, x1, y1 = [int(v) for v in b]
        cv2.rectangle(out, (x0, y0), (x1, y1), color, 2)
        txt = ""
        if labels is not None:
            txt += str(labels[i])
        if scores is not None:
            txt += f" {scores[i]:.2f}"
        if txt:
            cv2.putText(out, txt, (x0, max(y0 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return out
