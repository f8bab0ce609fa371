"""Episode visualization: render rollout states to video frames (port of
the JAX package's ``deploy/visualize.py``; a host-side tool, numpy and
matplotlib, mp4 through ``hri/video`` and cv2).

The reference renders eval episodes with PyBullet's camera + ffmpeg
(train.py:196-199, 446: `p.getCameraImage` → `ffmpeg -r 38`). Here the
renderer is self-contained: a matplotlib side+top schematic of the A1
(trunk box, legs from FK, terrain profile, contact markers) drawn from
logged states — works headless, no engine needed. States and heights are
read back to the host; ``h_fn`` is a ``sim/terrain`` height function.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from paddlerobotics_torch.sim import a1_model as a1


def _fk_points(pos, quat, q):
    """World positions of hips/knees/feet for one env.

    pos (3,), quat (4,) wxyz, q (12,). Returns dict of (4,3) arrays.
    """
    w, x, y, z = quat
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    qq = np.asarray(q).reshape(4, 3)
    hips, knees, feet = [], [], []
    for i in range(4):
        t1, t2, t3 = qq[i]
        side = 1.0 if i % 2 else -1.0
        hip_in_base = a1.HIP_JOINT_IN_TRUNK[i]
        # hip frame rotation about x by t1; thigh about y by t2
        Rx = np.array([[1, 0, 0], [0, np.cos(t1), -np.sin(t1)],
                       [0, np.sin(t1), np.cos(t1)]])
        Ry2 = np.array([[np.cos(t2), 0, np.sin(t2)], [0, 1, 0],
                        [-np.sin(t2), 0, np.cos(t2)]])
        Ry3 = np.array([[np.cos(t3), 0, np.sin(t3)], [0, 1, 0],
                        [-np.sin(t3), 0, np.cos(t3)]])
        o_h = pos + R @ hip_in_base
        R_h = R @ Rx
        o_t = o_h + R_h @ np.array([0.0, side * a1.THIGH_JOINT_IN_HIP_Y, 0.0])
        R_t = R_h @ Ry2
        o_k = o_t + R_t @ np.array([0.0, 0.0, -a1.L_UP])
        R_c = R_t @ Ry3
        o_f = o_k + R_c @ np.array([0.0, 0.0, -a1.L_LOW])
        hips.append(o_t)
        knees.append(o_k)
        feet.append(o_f)
    return {"hip": np.asarray(hips), "knee": np.asarray(knees),
            "foot": np.asarray(feet), "R": R}


def render_frame(pos, quat, q, h_fn=None, contacts=None,
                 size=(640, 480)) -> np.ndarray:
    """One state → RGB frame (H,W,3) uint8: side view (x-z) + top inset."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = _fk_points(np.asarray(pos), np.asarray(quat), np.asarray(q))
    fig, ax = plt.subplots(figsize=(size[0] / 100, size[1] / 100), dpi=100)
    cx = pos[0]
    ax.set_xlim(cx - 0.7, cx + 0.7)
    ax.set_ylim(-0.05, 0.7)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")

    # terrain profile
    xs = np.linspace(cx - 0.7, cx + 0.7, 200)
    if h_fn is not None:
        import torch

        x_t = torch.as_tensor(xs, dtype=torch.float32)
        hs = h_fn(x_t, torch.zeros_like(x_t)).numpy()
    else:
        hs = np.zeros_like(xs)
    ax.fill_between(xs, -0.05, hs, color="#d9cfc0", zorder=0)
    ax.plot(xs, hs, color="#8a7a63", lw=1.5, zorder=1)

    # trunk box (side projection)
    R = pts["R"]
    half = np.array([0.1335, 0.097, 0.057])
    corners = []
    for sx in (-1, 1):
        for sz in (-1, 1):
            c = np.asarray(pos) + R @ (half * np.array([sx, 0, sz]))
            corners.append([c[0], c[2]])
    order = [0, 1, 3, 2, 0]
    cs = np.asarray(corners)[order]
    ax.plot(cs[:, 0], cs[:, 1], color="#2a4d69", lw=2, zorder=3)

    # legs
    for i in range(4):
        leg_x = [pts["hip"][i, 0], pts["knee"][i, 0], pts["foot"][i, 0]]
        leg_z = [pts["hip"][i, 2], pts["knee"][i, 2], pts["foot"][i, 2]]
        front = i < 2
        ax.plot(leg_x, leg_z, color="#4b86b4" if front else "#adcbe3",
                lw=2.5, zorder=2)
        in_c = bool(contacts[i]) if contacts is not None else False
        ax.plot(pts["foot"][i, 0], pts["foot"][i, 2], "o",
                color="#e7553c" if in_c else "#63ace5", ms=5, zorder=4)

    ax.set_title(f"x={pos[0]:.2f} m   h={pos[2]:.2f} m")
    fig.tight_layout()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return buf


def render_episode(states: Sequence, out_path: str, h_fn=None,
                   fps: float = 38.0, env_index: int = 0,
                   stride: int = 1) -> int:
    """Logged batched states → mp4 (the reference's `ffmpeg -r 38`).

    `states` is a sequence of (pos (3,B), quat (4,B), q (12,B),
    contacts (4,B) or None) tuples of numpy arrays (take .robot.s fields
    from BEnvState, read back).
    Returns number of frames written.
    """
    from paddlerobotics_torch.hri.video import VideoWriter

    writer = VideoWriter(out_path, fps=fps / stride)
    n = 0
    for item in states[::stride]:
        pos, quat, q, contacts = item
        frame = render_frame(
            np.asarray(pos)[:, env_index], np.asarray(quat)[:, env_index],
            np.asarray(q)[:, env_index], h_fn=h_fn,
            contacts=None if contacts is None
            else np.asarray(contacts)[:, env_index])
        writer.write(frame)
        n += 1
    writer.close()
    return n
