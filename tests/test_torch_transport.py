"""Port parity of the HRI transport and tracking front ends: the proto3
codec (``hri/pg_proto``), frame decoding and the transport-free handlers
(``hri/grpc_transport``), the letterbox and box helpers (``hri/utils``),
``cli/serve_grpc`` over a grpcio loopback and ``cli/collect_data`` on a
4-frame mp4, against the JAX package and ``cv2`` on the same inputs.

Tolerances: codec bytes and handler responses equal; letterboxed frames
within 1e-6 of JAX's ``cv2.resize`` path on float32 (both take the
sampling coordinates in double and blend in float32); the box helpers within
float32 rounding (1e-6 relative); the port's crops and detector input
within 1/255 of ``cv2.resize`` on ``uint8`` frames, which rounds to
``uint8`` in fixed point where the port resizes the float values.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri import grpc_transport as j_gt
from paddlerobotics_tpu.hri import pg_proto as j_pb
from paddlerobotics_tpu.hri import utils as j_utils

from paddlerobotics_torch.cli import collect_data, serve_grpc
from paddlerobotics_torch.hri import grpc_transport as gt
from paddlerobotics_torch.hri import pg_proto as pb
from paddlerobotics_torch.hri import utils
from test_darknet_import import TINY_CFG

cv2 = pytest.importorskip("cv2")

IMG_TOL = 1e-6
U8_TOL = 1 / 255


def _t(x):
    return torch.tensor(np.array(x))


def _messages(mod):
    return [
        mod.VideoRequest(req_id=7, lag=120, wakeup="1",
                         cur_frame=b"\x00\x01\xff" * 5),
        mod.VideoRequest(req_id=-3),
        mod.VideoRequest(),
        mod.InferResponse(response='{"triggered":false}'),
        mod.EvalRequest(nframe=8, frames=b"z" * 300),
        mod.EvalResponse(response="hi", response_score=0.5,
                         trigger_pred=-1.25, nullact_score=0.0009765625,
                         nullact_id=2147483647),
        mod.EvalResponse(nullact_id=-1),
    ]


def test_pg_proto_bytes_equal_to_jax():
    for mine, ref in zip(_messages(pb), _messages(j_pb)):
        blob = mine.encode()
        assert blob == ref.encode()
        assert type(mine).decode(blob) == mine
        back = type(ref).decode(blob)
        assert {f: getattr(back, f) for f in vars(back)} == vars(mine)
    assert (pb.GREETING_INFER, pb.EVAL_INFER) == (j_pb.GREETING_INFER,
                                                  j_pb.EVAL_INFER)
    with pytest.raises(ValueError):
        pb.VideoRequest.decode(b"\x22\x10ab")       # truncated bytes field


@pytest.mark.parametrize("shape", [(360, 640, 3), (640, 360, 3), (48, 64, 3),
                                   (416, 416, 3), (100, 37, 1)])
def test_letterbox_image_matches_cv2_path(shape):
    img = np.random.default_rng(sum(shape)).random(shape, np.float32)
    want = j_utils.letterbox_image(img[..., 0] if shape[-1] == 1 else img)
    got = utils.letterbox_image(_t(img))
    assert got.shape == (416, 416, shape[-1])
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               atol=IMG_TOL)
    assert utils.letterbox_params(*shape[:2]) == \
        j_utils.letterbox_params(*shape[:2])


def test_box_helpers_match():
    rng = np.random.default_rng(1)
    lo = rng.uniform(0, 300, (6, 2))
    a = np.concatenate([lo, lo + rng.uniform(1, 120, (6, 2))], 1).astype(
        np.float32)
    b = a[::-1] + rng.normal(0, 10, a.shape).astype(np.float32)
    for got, want in (
            (utils.iou_matrix(_t(a), _t(b)),
             j_utils.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
            (utils.expand_boxes(_t(a), 1.3),
             j_utils.expand_boxes(jnp.asarray(a), 1.3)),
            (utils.cosine_sim(_t(a), _t(b)),
             j_utils.cosine_sim(jnp.asarray(a), jnp.asarray(b)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(utils.unletterbox_boxes(a, 360, 640),
                               j_utils.unletterbox_boxes(a, 360, 640))


def _view_frames(n, seed=2):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *gt.VIEW_HW, 3), dtype=np.uint8)


def test_decode_frame_and_eval_frames_both_formats():
    view = _view_frames(1)[0]
    lb = np.random.default_rng(3).random((416, 416, 3), np.float32)
    for blob in (view.tobytes(), lb.tobytes()):
        np.testing.assert_allclose(gt.decode_frame(blob).numpy(),
                                   j_gt.decode_frame(blob), atol=IMG_TOL)
    with pytest.raises(ValueError, match="curFrame"):
        gt.decode_frame(b"x" * 10)
    views = _view_frames(3, seed=4)
    for frames in (views, np.stack([lb, lb * 0.5])):
        req = pb.EvalRequest(nframe=len(frames), frames=frames.tobytes())
        got = gt.decode_eval_frames(req)
        want = j_gt.decode_eval_frames(j_pb.EvalRequest.decode(req.encode()))
        assert len(got) == len(want) == len(frames)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=IMG_TOL)
    assert gt.decode_eval_frames(pb.EvalRequest()) == []


class Stub:
    """A decision backend that records the frames it was given and answers
    from the request's fields alone."""

    def __init__(self):
        self.frames = []

    def process(self, img, lag_ms, wakeup):
        self.frames.append(np.asarray(img))
        return {"triggered": lag_ms > 50, "lag": lag_ms, "wakeup": wakeup}

    def score(self, frames):
        self.frames += [np.asarray(f) for f in frames]
        return {"response": {"n": len(frames)}, "response_score": 0.5,
                "trigger_pred": 0.25, "nullact_id": 3}


def test_handlers_match_the_jax_servers():
    pytest.importorskip("grpc")
    views = _view_frames(2, seed=5)
    lb = np.random.default_rng(6).random((416, 416, 3), np.float32)
    reqs = [pb.VideoRequest(req_id=i, lag=40 * i, wakeup=w, cur_frame=f)
            for i, (w, f) in enumerate([("", views[0].tobytes()),
                                        ("1", lb.tobytes()),
                                        ("", views[1].tobytes()),
                                        ("", b"bad frame")])]
    j_stub, t_stub = Stub(), Stub()
    server = j_gt.GreetingGrpcServer(j_stub.process).start()
    client = j_gt.GreetingGrpcClient(f"127.0.0.1:{server.port}", timeout=60)
    try:
        want = list(client.infer(iter(j_pb.VideoRequest.decode(r.encode())
                                      for r in reqs)))
    finally:
        client.close()
        server.stop(0)
    handle = gt.greeting_handler(t_stub.process, device="cpu")
    got = [json.loads(pb.InferResponse.decode(handle(r.encode())).response)
           for r in reqs]
    assert got == want and "error" in got[-1]
    assert len(t_stub.frames) == len(j_stub.frames) == 3
    for g, w in zip(t_stub.frames, j_stub.frames):
        np.testing.assert_allclose(g, w, atol=IMG_TOL)

    req = pb.EvalRequest(nframe=2, frames=views.tobytes())
    j_stub, t_stub = Stub(), Stub()
    server = j_gt.EvalGrpcServer(j_stub.score).start()
    client = j_gt.EvalGrpcClient(f"127.0.0.1:{server.port}")
    try:
        want = client.infer(list(views))
    finally:
        client.close()
        server.stop(0)
    blob = gt.eval_handler(t_stub.score, device="cpu")(req.encode())
    assert blob == j_pb.EvalResponse(
        response=json.dumps(want["response"]),
        **{k: want[k] for k in ("response_score", "trigger_pred",
                                "nullact_score", "nullact_id")}).encode()
    for g, w in zip(t_stub.frames, j_stub.frames):
        np.testing.assert_allclose(g, w, atol=IMG_TOL)


def test_serve_grpc_smoke_loopback(capsys):
    """``serve_grpc --smoke --steps 2 --device cpu`` over grpcio: two
    greeting decisions and one eval response, in the JAX CLI's form."""
    pytest.importorskip("grpc")
    serve_grpc.main(["--smoke", "--steps", "2", "--device", "cpu",
                     "--port", "0", "--eval_port", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("ProactiveGreeting.infer on 127.0.0.1:")
    decisions = [json.loads(x) for x in lines[1:3]]
    assert [d["req_id"] for d in decisions] == [0, 1]
    assert all(d["reason"] == "window_filling" for d in decisions)
    ev = json.loads(lines[3])
    assert set(ev) == {"response", "response_score", "trigger_pred",
                       "nullact_score", "nullact_id"}


def test_collect_data_matches_track_frames_and_cv2(tmp_path):
    """``collect_data --device cpu`` on a 4-frame mp4 with the tiny cfg:
    its logs equal a direct ``track_frames`` call on the decoded frames;
    the port's detector input and crops are within 1/255 of the JAX CLI's
    ``cv2.resize`` of the ``uint8`` frames."""
    from paddlerobotics_torch.hri.video import clip_video_to_frames

    clips = tmp_path / "clips"
    clips.mkdir()
    w = cv2.VideoWriter(str(clips / "t01.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.RandomState(0)
    for _ in range(4):
        w.write(rng.randint(0, 255, (48, 64, 3), np.uint8))
    w.release()
    cfg_path = tmp_path / "tiny.cfg"
    cfg_path.write_text(TINY_CFG)
    out = tmp_path / "out"
    argv = ["-d", str(clips), "-o", str(out), "--darknet_cfg", str(cfg_path),
            "--score_threshold", "0.0", "--device", "cpu"]
    collect_data.main(argv)
    with open(out / "t01_states.pkl", "rb") as f:
        logs = pickle.load(f)
    assert (out / "t01_track.mp4").exists() and len(logs) == 4
    track_log, det_log = logs[0]
    assert isinstance(track_log, dict) and 0 < len(det_log) <= 20

    args = collect_data.build_parser().parse_args(argv)
    scene, reid = collect_data.detector_and_encoder(args, torch.device("cpu"))
    frames = clip_video_to_frames(str(clips / "t01.mp4"))
    assert collect_data.track_frames(frames, scene, reid,
                                     score_threshold=0.0) == logs
    # the last frame's ids come from tracks the earlier frames started
    assert set(logs[-1][0]) <= {str(i) for i in range(1, 81)}

    frame = frames[1]
    S = scene.input_size
    img = utils.resize_bilinear(_t(frame).float(), S, S) / 255.0
    np.testing.assert_allclose(img.numpy(), cv2.resize(frame, (S, S)) / 255.0,
                               atol=U8_TOL)
    boxes = np.asarray(logs[1][1] + [[-5.0, 2.5, 70.0, 60.0],
                                     [63.2, 47.9, 63.3, 48.0],
                                     [10.0, 48.0, 20.0, 60.0]])
    crops = utils.crop_resize(_t(frame).float(), _t(boxes),
                              torch.ones(len(boxes), dtype=torch.bool),
                              128, 64) / 255.0
    for b, crop in zip(boxes, crops.numpy()):
        x0, y0, x1, y1 = [int(max(c, 0)) for c in b]
        patch = frame[y0:max(y1, y0 + 1), x0:max(x1, x0 + 1)]
        if patch.size == 0:                 # below the frame: zeros
            assert np.abs(crop).max() == 0.0
            continue
        np.testing.assert_allclose(crop, cv2.resize(patch, (64, 128)) / 255.0,
                                   atol=U8_TOL)
        ref = utils.resize_bilinear(_t(patch).float(), 128, 64) / 255
        np.testing.assert_allclose(crop, ref.numpy(), atol=IMG_TOL)
    empty = utils.crop_resize(_t(frame).float(), _t(boxes[:2]),
                              torch.tensor([False, True]), 128, 64)
    assert float(empty[0].abs().max()) == 0.0
    assert os.path.getsize(out / "t01_track.mp4") > 0
