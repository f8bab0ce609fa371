"""Tracking preprocessor for dataset-v2 annotation (PyTorch port of the JAX
package's ``cli/collect_data.py``): for every video clip, run person
detection and Deep-SORT tracking and write

    <task>_track.mp4    frames annotated with track ids and detections
    <task>_states.pkl   per frame (track_log: {track_id: tlbr},
                        det_log: [tlbr])

    python -m paddlerobotics_torch.cli.collect_data -d clips/ -o out/ \\
        [--darknet_cfg yolov4.cfg --darknet_weights yolov4.weights] \\
        [--encoder_params reid.pt] [--device cuda]

``track_frames`` is the tracking core, on the card unless ``--device``
says otherwise: per frame, resize to the detector's input (bilinear, on
the device), detect, crop each person at 64×128 and encode it
(``MarsSmall128``), ``tracker_predict`` and ``tracker_update`` (one
``track_match`` kernel launch on the card); it reads nothing back until the
clip is done. ``main`` reads and writes the mp4 files through
``hri/video.py``, which needs ``cv2``. The JAX CLI resizes ``uint8`` frames
with ``cv2.resize`` (fixed-point rounding to ``uint8``); the port resizes
the frame's float values, so its images and crops differ from those by
less than 1/255. ``--encoder_params`` is a ``.pt`` state dict of the
encoder (``convert.reid_from_flax(...).state_dict()``); without it, and
without weights, the networks are drawn from a seed (a pipeline smoke: the
detections are meaningless but the format is real).
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import List, Sequence, Tuple

import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video_dir", "-d", default="data/clips")
    p.add_argument("--output_dir", "-o", default="")
    p.add_argument("--encoder_params", type=str, default="",
                   help=".pt state dict of the ReID encoder")
    p.add_argument("--darknet_cfg", type=str, default="")
    p.add_argument("--darknet_weights", type=str, default="")
    p.add_argument("--max_cosine_distance", type=float, default=0.3)
    p.add_argument("--score_threshold", type=float, default=0.25)
    p.add_argument("--workers", "-w", type=int, default=1)
    p.add_argument("--current_worker", "-c", type=int, default=1)
    p.add_argument("--resume", type=str, default=None,
                   help="task id (video basename) to resume from")
    p.add_argument("--max_frames", type=int, default=0,
                   help="cap frames per video (0 = all)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


@torch.no_grad()
def track_frames(frames, scene, reid, max_cosine_distance: float = 0.3,
                 score_threshold: float = 0.25
                 ) -> List[Tuple[dict, list]]:
    """Detect, encode and track a clip on the scene sensor's device.

    frames: uint8 RGB (N,H,W,3), an array or a tensor, or a list of
    (H,W,3) arrays. → per frame (track_log {str(track_id): [x0,y0,x1,y1]},
    det_log [[x0,y0,x1,y1], ...]) in frame pixels, the JAX CLI's format."""
    from paddlerobotics_torch.hri import tracker as trk
    from paddlerobotics_torch.hri.perception.reid import CROP_HW
    from paddlerobotics_torch.hri.utils import crop_resize, resize_bilinear

    dev = scene.device
    if isinstance(frames, (list, tuple)):
        frames = torch.stack([torch.as_tensor(f) for f in frames])
    clip = torch.as_tensor(frames).to(dev)
    N, h, w = clip.shape[:3]
    S = scene.input_size
    scale = torch.tensor([w / S, h / S, w / S, h / S], dtype=torch.float64,
                         device=dev)
    state = trk.init_tracker(dev)
    out_boxes, out_tid, out_valid = [], [], []
    for i in range(N):
        frame = clip[i].to(torch.float32)
        img = resize_bilinear(frame, S, S) / 255.0
        inst = scene.get_instances_with_feats(img[None], score_threshold)
        fboxes = inst.boxes[0].to(torch.float64) * scale      # frame pixels
        valid = inst.valid[0]
        crops = crop_resize(frame, fboxes, valid, *CROP_HW) / 255.0
        feats = reid(crops)
        state = trk.tracker_predict(state)
        state, det_tid = trk.tracker_update(
            state, fboxes.to(torch.float32), feats, valid,
            max_cosine_distance=max_cosine_distance)
        out_boxes.append(fboxes)
        out_tid.append(det_tid)
        out_valid.append(valid)
    boxes = torch.stack(out_boxes).cpu().numpy()
    tids = torch.stack(out_tid).cpu().numpy()
    valids = torch.stack(out_valid).cpu().numpy()
    logs = []
    for fb, tid, val in zip(boxes, tids, valids):
        track_log = {str(int(t)): fb[k].tolist()
                     for k, t in enumerate(tid) if t > 0 and val[k]}
        det_log = [fb[k].tolist() for k in range(len(val)) if val[k]]
        logs.append((track_log, det_log))
    return logs


def detector_and_encoder(args, device):
    """The scene sensor and ReID encoder of ``args`` on ``device``."""
    from paddlerobotics_torch.hri.perception.reid import MarsSmall128
    from paddlerobotics_torch.hri.perception.scene import SceneSensor

    def seeded(seed):
        g = torch.Generator(device)
        g.manual_seed(seed)
        return g

    if args.darknet_cfg:
        from paddlerobotics_torch.hri.perception import darknet
        from paddlerobotics_torch.hri.perception.scene import \
            DarknetSceneSensor

        with open(args.darknet_cfg) as f:
            sections = darknet.parse_cfg(f.read())
        scene = DarknetSceneSensor(sections, device=device,
                                   generator=seeded(0))
        if args.darknet_weights:
            darknet.load_darknet_weights(scene.model, sections,
                                         args.darknet_weights)
    else:
        scene = SceneSensor(device=device, generator=seeded(0))
    reid = MarsSmall128(device=device, generator=seeded(2))
    if args.encoder_params:
        reid.load_state_dict(torch.load(args.encoder_params,
                                        map_location=device,
                                        weights_only=True))
    return scene, reid


def shard(videos: Sequence[str], args) -> List[str]:
    """This worker's clips, from ``--resume`` on."""
    tasks = [v for i, v in enumerate(videos)
             if i % args.workers == args.current_worker - 1]
    if args.resume is None:
        return tasks
    ids = [os.path.basename(v)[:-len(".mp4")] for v in tasks]
    if args.resume not in ids:
        raise SystemExit(
            f"--resume {args.resume!r} is not in worker "
            f"{args.current_worker}/{args.workers}'s shard — nothing "
            f"would run (shard tasks: "
            f"{[os.path.basename(v) for v in tasks][:5]}…)")
    return tasks[ids.index(args.resume):]


def main(argv=None):
    args = build_parser().parse_args(argv)
    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.hri.video import (VideoWriter,
                                                clip_video_to_frames,
                                                draw_instances)

    device = resolve_device(args.device)
    out_dir = args.output_dir or args.video_dir
    os.makedirs(out_dir, exist_ok=True)
    scene, reid = detector_and_encoder(args, device)
    videos = sorted(glob.glob(os.path.join(args.video_dir, "*.mp4")))
    for video_file in shard(videos, args):
        task_id = os.path.basename(video_file)[:-len(".mp4")]
        frames = clip_video_to_frames(video_file)
        if args.max_frames:
            frames = frames[:args.max_frames]
        logs = track_frames(frames, scene, reid, args.max_cosine_distance,
                            args.score_threshold) if frames else []
        writer = VideoWriter(os.path.join(out_dir, f"{task_id}_track.mp4"))
        for frame, (track_log, det_log) in zip(frames, logs):
            labels = {tuple(b): t for t, b in track_log.items()}
            writer.write(draw_instances(
                frame, det_log, labels=[labels.get(tuple(b), "")
                                        for b in det_log]))
        writer.close()
        with open(os.path.join(out_dir, f"{task_id}_states.pkl"),
                  "wb") as f:
            pickle.dump(logs, f)
        print(f"saved {task_id}: {len(logs)} frames")


if __name__ == "__main__":
    main()
