"""Native serving-path benchmark (port of the JAX package's
``scripts_dev/serving_bench.py``).

The reference's Jetson server is a latency-hiding thread pipeline
(infer_v3.cpp:1167-1313, 1736-1756). This bench drives the rebuild's
serving surfaces end to end with the serving models at their full widths
(the YOLOv4 scene sensor at 416² and the attention controller, random
weights from a seed; the controller's attention is the hand-written
kernel on the card) and prints one JSON row per arm: frames/s and
p50/p90/p99 ms per frame.

  model_sync        — ``ProactiveGreetingService.process_frame`` direct
                      (no transport, sequential)
  stream_sync       — the C++ stream server (length-prefixed TCP),
                      lock-step send → wait for the response per frame
  stream_pipelined  — the same server, frames offered at camera rate
                      without waiting; the pipeline's detector and
                      controller threads may overlap, but both call back
                      into Python and take turns on the GIL, so the row
                      reports the measured overlap of detect and attend
                      calls (``overlap_s``)
  grpc_pipelined    — the C++ HTTP/2 + HPACK gRPC server driven by a
                      grpcio bidi stream (needs ``grpcio``; skipped
                      without it)

The stream rows also count the callbacks: ``attend_calls`` is the decided
frames (6 attention launches each), ``detect_calls`` the detected ones.
Writes ``<out>/summary.json``.

    python -m paddlerobotics_torch.cli.serving_bench [--frames 120]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pct(xs, p) -> float:
    return float(np.percentile(np.asarray(xs), p))


def summarize(name, lat_s, wall_s, n) -> dict:
    row = {"arm": name, "frames": n, "fps": n / wall_s,
           "p50_ms": pct(lat_s, 50) * 1e3, "p90_ms": pct(lat_s, 90) * 1e3,
           "p99_ms": pct(lat_s, 99) * 1e3}
    print(json.dumps(row), flush=True)
    return row


def build_models(num_act: int, device=None, seed: int = 1):
    """The serving models at their full widths with random weights drawn
    from ``seed``: the service (YOLOv4 at 416², the ``num_act``-action
    controller; trigger threshold 0.5, no near-field rule, no cooldown)
    and the native runtime's callbacks over its parts and generator. On
    the card unless ``device`` says otherwise. Returns (service,
    callbacks)."""
    import torch

    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                         AttnCtrlConfig)
    from paddlerobotics_torch.hri.native_pipeline import ServiceCallbacks
    from paddlerobotics_torch.hri.perception.scene import SceneSensor
    from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                                  ServiceConfig)

    dev = resolve_device(device)
    g = torch.Generator(dev)
    g.manual_seed(seed)
    scene = SceneSensor(input_size=416, device=dev, generator=g)
    ctrl = AttentionController(AttnCtrlConfig(num_actions=num_act),
                               device=dev, generator=g)
    svc = ProactiveGreetingService(
        ServiceConfig(trigger_threshold=0.5, near_field_frac=0.0,
                      wakeup_cooldown_s=0.0), scene, ctrl, device=dev)
    return svc, ServiceCallbacks.from_service(svc)


def arm_model_sync(svc, frames, n) -> dict:
    lat = []
    t0 = time.time()
    for i in range(n):
        t = time.time()
        svc.process_frame(frames[i % len(frames)])
        lat.append(time.time() - t)
    return summarize("model_sync", lat, time.time() - t0, n)


def _reset(cbs) -> None:
    cbs.detect_calls = cbs.attend_calls = 0
    cbs.intervals = []


def _counts(cbs) -> dict:
    from paddlerobotics_torch.hri.native_pipeline import overlap

    return {"detect_calls": cbs.detect_calls,
            "attend_calls": cbs.attend_calls, **overlap(cbs.intervals)}


def arm_stream(cbs, frames, n, pipelined: bool, pace_s: float,
               offered_fps: float = 25.0, lib_path=None) -> dict:
    """Stream-server arms, on the pipeline's semantics: the controller
    emits nothing until its 10-frame window fills, and under load the
    bounded queues drop the oldest frame and skip frames older than 0.5 s,
    so responses are not 1:1 with frames. The window is filled paced to
    the model (``pace_s``, from the model_sync arm's p50). The sync arm is
    lock-step after the fill; the pipelined arm offers frames at
    ``offered_fps``, matches decisions to frames by the frame_id echoed in
    the response, and reports dropped frames. The callback counts and
    their overlap cover the whole arm, the fill included."""
    from paddlerobotics_torch.hri.native_pipeline import NativePipeline
    from paddlerobotics_torch.hri.stream_client import GreetingStreamClient

    _reset(cbs)
    pipe = NativePipeline(cbs.detect, cbs.attend, trigger_threshold=0.5,
                          near_field_frac=0.0, cooldown_s=0.0,
                          lib_path=lib_path)
    client = None
    quiet = (TimeoutError, socket.timeout)
    try:
        port = pipe.serve(0)
        client = GreetingStreamClient(port=port, timeout=300.0)
        # window fill: send paced to the model, until two decisions have
        # come back, then drain until quiet
        got = 0
        for i in range(40):
            client.send_frame(i, frames[i % len(frames)])
            deadline = time.time() + max(pace_s, 0.05)
            while True:
                rem = deadline - time.time()
                if rem <= 0:
                    break
                client.set_timeout(rem)
                try:
                    client.read_response()
                    got += 1
                except quiet:
                    break
            if got >= 2:
                break
        pipe.check()
        if got < 2:
            raise RuntimeError(
                f"window never produced decisions (pace_s={pace_s})")
        client.set_timeout(max(2.0, 2 * pace_s))
        try:
            while True:
                client.read_response()
        except quiet:
            pass
        name = "stream_pipelined" if pipelined else "stream_sync"
        if not pipelined:
            client.set_timeout(max(60.0, 20 * pace_s))
            lat = []
            t0 = time.time()
            for j in range(n):
                t = time.time()
                client.send_frame(100 + j, frames[j % len(frames)])
                client.read_response()
                lat.append(time.time() - t)
            row = summarize(name, lat, time.time() - t0, n)
            row.update(decisions=n, dropped=0, **_counts(cbs))
            print(json.dumps(row), flush=True)
            return row

        send_t = {}
        lat = []
        n_resp = [0]
        last_fid = 100 + n - 1
        done = threading.Event()
        t_last = [None]

        def reader():
            # a quiet stream ends the run (the tail where every queued
            # frame went stale and was skipped)
            client.set_timeout(max(10.0, 4 * pace_s))
            while True:
                try:
                    r = client.read_response()
                except quiet:
                    break
                t_last[0] = time.time()
                n_resp[0] += 1
                fid = r.get("frame_id", -1)
                if fid in send_t:
                    lat.append(t_last[0] - send_t[fid])
                if fid >= last_fid:
                    break
            done.set()

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        period = 1.0 / offered_fps
        t0 = time.time()
        for j in range(n):
            dt = t0 + j * period - time.time()
            if dt > 0:
                time.sleep(dt)
            send_t[100 + j] = time.time()
            client.send_frame(100 + j, frames[j % len(frames)])
        done.wait(timeout=600)
        th.join(timeout=10)
        wall = (t_last[0] or time.time()) - t0
        row = summarize(name, lat or [float("nan")], wall, n_resp[0])
        row.update(offered_fps=offered_fps, frames_offered=n,
                   decisions=n_resp[0], dropped=n - n_resp[0],
                   matched=len(lat), **_counts(cbs))
        print(json.dumps(row), flush=True)
        return row
    finally:
        if client is not None:
            client.close()
        pipe.close()


def arm_grpc(cbs, frames, n, num_act, lib_path=None) -> dict:
    from paddlerobotics_torch.hri.grpc_transport import GreetingGrpcClient
    from paddlerobotics_torch.hri.native_pipeline import NativeGrpcServer

    _reset(cbs)
    server = NativeGrpcServer(cbs.detect, cbs.attend, num_act=num_act,
                              trigger_threshold=0.5, near_field_frac=0.0,
                              lib_path=lib_path)
    client = None
    try:
        client = GreetingGrpcClient(f"127.0.0.1:{server.port}", timeout=300)
        warm = [client.video_request(i, frames[i % len(frames)])
                for i in range(12)]
        list(client.infer(iter(warm)))
        send_t = {}
        lat = []
        pending = 0
        t0 = time.time()

        def gen():
            for j in range(n):
                send_t[j] = time.time()
                yield client.video_request(100 + j, frames[j % len(frames)])

        k = 0
        for resp in client.infer(gen()):
            # "pending": the bounded lock-step wait elapsed with no decision
            # ready (window fill or a dropped frame): a round trip, not a
            # decision, kept out of the latency distribution
            if resp.get("reason") == "pending":
                pending += 1
            else:
                lat.append(time.time() - send_t[k])
            k += 1
        wall = time.time() - t0
        row = summarize("grpc_pipelined", lat or [float("nan")], wall,
                        n - pending)
        row.update(requests=n, pending=pending, **_counts(cbs))
        print(json.dumps(row), flush=True)
        return row
    finally:
        if client is not None:
            client.close()
        server.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--num_act", type=int, default=317)
    p.add_argument("--out", type=str,
                   default=str(ROOT / "build" / "serving_bench"))
    p.add_argument("--offered_fps", type=float, default=25.0,
                   help="camera rate offered to the pipelined arm")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    svc, cbs = build_models(args.num_act, device=args.device)
    rng = np.random.default_rng(0)
    frames = [np.asarray(rng.random((416, 416, 3)), np.float32)
              for _ in range(4)]
    for i in range(12):     # warm-up and window fill
        svc.process_frame(frames[i % len(frames)])
    # the callbacks too: their first call must not land in a server's
    # read loop
    _, _, tok, _ = cbs.detect(frames[0])
    cbs.attend(np.zeros((cbs.nf, cbs.tpf, tok.shape[-1]), np.float32),
               np.zeros((cbs.nf, cbs.tpf), np.float32))

    n = args.frames
    rows = [arm_model_sync(svc, frames, n)]
    # window fills paced to the serial model latency: faster pumping only
    # makes the pipeline skip stale frames
    pace_s = 1.5 * rows[0]["p50_ms"] / 1e3 + 0.05
    rows.append(arm_stream(cbs, frames, n, pipelined=False, pace_s=pace_s))
    rows.append(arm_stream(cbs, frames, n, pipelined=True, pace_s=pace_s,
                           offered_fps=args.offered_fps))
    try:
        import grpc  # noqa: F401
    except ImportError:
        print("grpcio absent: grpc arm skipped", flush=True)
    else:
        rows.append(arm_grpc(cbs, frames, n, args.num_act))

    import torch

    dev = svc.device
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"), "frames": n, "num_act": args.num_act,
           "arms": rows}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "summary.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("written", path)


if __name__ == "__main__":
    main()
