"""gRPC transport for the greeting and eval services (port of the JAX
package's ``hri/grpc_transport.py``).

The reference serves ProactiveGreeting.infer (bidi stream) and
EvalServer.infer (unary) over gRPC; the method paths and the proto3 wire
bytes (``pg_proto``) are the reference's. The port splits each service in
two:

- a transport-free handler, wire bytes in and wire bytes out
  (``greeting_handler``, ``eval_handler``): decode the request, decode its
  frames onto the service's device, call the decision function, encode the
  response. This is the part that runs on the card, and what a caller
  without ``grpcio`` drives;
- the ``grpcio`` servers and clients around them, with ``grpcio`` imported
  where they are built; without it, building one raises.

Frame payloads (told apart by byte length, per request):
  - reference-exact: raw uint8 BGR ``(view_h, view_w, 3)`` frames (eval
    frames stacked on height; VIEW = 360×640), flipped to RGB, scaled to
    [0,1] and letterboxed to the 416 detector input on the device by
    ``hri/utils.letterbox_image``;
  - native-stack: float32 RGB letterboxed ``(416,416,3)`` in [0,1].
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri import pg_proto as pb
from paddlerobotics_torch.hri.utils import letterbox_image

VIEW_HW = (360, 640)       # (720/2, 1280/2)
TARGET = 416
# float32 letterboxed clips exceed gRPC's 4 MB default message cap (one
# 416x416x3 f32 frame is ~2 MB)
_MSG_OPTIONS = [("grpc.max_receive_message_length", 256 * 1024 * 1024),
                ("grpc.max_send_message_length", 256 * 1024 * 1024)]


def _grpc():
    try:
        import grpc
    except ImportError as e:
        raise RuntimeError("grpcio is not installed: drive the transport-free "
                           "handlers (greeting_handler, eval_handler) "
                           "instead") from e
    return grpc


def _from_view(bgr: torch.Tensor, target: int) -> torch.Tensor:
    """uint8 BGR (h,w,3) → float32 RGB (target,target,3) letterboxed."""
    rgb = bgr.flip(-1).to(torch.float32) / 255.0
    return letterbox_image(rgb, target)


def decode_frame(blob: bytes, view_hw: Tuple[int, int] = VIEW_HW,
                 target: int = TARGET, device="cpu") -> torch.Tensor:
    """curFrame bytes → float32 RGB (target,target,3) in [0,1] on
    ``device``."""
    h, w = view_hw
    if len(blob) == target * target * 3 * 4:
        arr = np.frombuffer(blob, np.float32).reshape(target, target, 3)
        return torch.as_tensor(arr.copy(), device=device)
    if len(blob) == h * w * 3:
        bgr = np.frombuffer(blob, np.uint8).reshape(h, w, 3)
        return _from_view(torch.as_tensor(bgr.copy(), device=device), target)
    raise ValueError(
        f"curFrame is {len(blob)} bytes; expected float32 letterboxed "
        f"({target}x{target}x3) or uint8 view ({h}x{w}x3)")


def decode_eval_frames(req: pb.EvalRequest,
                       view_hw: Tuple[int, int] = VIEW_HW,
                       target: int = TARGET,
                       device="cpu") -> List[torch.Tensor]:
    """EvalRequest → list of nframe float32 RGB (target,target,3) on
    ``device``."""
    n = req.nframe
    if n <= 0:
        return []
    h, w = view_hw
    if len(req.frames) == n * h * w * 3:           # stacked uint8 view
        merge = np.frombuffer(req.frames, np.uint8).reshape(n, h, w, 3)
        merge = torch.as_tensor(merge.copy(), device=device)
        return [_from_view(f, target) for f in merge]
    if len(req.frames) == n * target * target * 3 * 4:
        arr = np.frombuffer(req.frames, np.float32).reshape(n, target,
                                                            target, 3)
        return list(torch.as_tensor(arr.copy(), device=device))
    raise ValueError(f"frames is {len(req.frames)} bytes for nframe={n}")


def greeting_handler(process_frame: Callable[[torch.Tensor, int, str], dict],
                     view_hw: Tuple[int, int] = VIEW_HW,
                     device=None) -> Callable[[bytes], bytes]:
    """One ProactiveGreeting.infer exchange: VideoRequest bytes →
    InferResponse bytes. ``process_frame(image, lag_ms, wakeup) -> dict``
    is the decision backend and gets the frame on the card unless
    ``device`` says otherwise; a frame that does not decode is answered
    with ``{"triggered": false, "error": ...}``, not raised."""
    device = resolve_device(device)

    def handle(blob: bytes) -> bytes:
        req = pb.VideoRequest.decode(blob)
        try:
            img = decode_frame(req.cur_frame, view_hw, device=device)
            decision = process_frame(img, req.lag, req.wakeup)
        except ValueError as e:
            decision = {"triggered": False, "error": str(e)}
        decision.setdefault("req_id", req.req_id)
        return pb.InferResponse(response=json.dumps(decision)).encode()

    return handle


def eval_handler(score_clip: Callable[[Sequence[torch.Tensor]], dict],
                 view_hw: Tuple[int, int] = VIEW_HW,
                 device=None) -> Callable[[bytes], bytes]:
    """One EvalServer.infer call: EvalRequest bytes → EvalResponse bytes.
    ``score_clip(frames) -> dict`` gets the frames on the card unless
    ``device`` says otherwise and returns the EvalResponse fields
    (``response`` may be any JSON-able value)."""
    device = resolve_device(device)

    def handle(blob: bytes) -> bytes:
        frames = decode_eval_frames(pb.EvalRequest.decode(blob), view_hw,
                                    device=device)
        out = score_clip(frames)
        resp = out.get("response", "")
        return pb.EvalResponse(
            response=resp if isinstance(resp, str) else json.dumps(resp),
            response_score=float(out.get("response_score", 0.0)),
            trigger_pred=float(out.get("trigger_pred", 0.0)),
            nullact_score=float(out.get("nullact_score", 0.0)),
            nullact_id=int(out.get("nullact_id", 0))).encode()

    return handle


class _Server:
    """A grpcio server on 127.0.0.1 with one method of raw-bytes handler."""

    def __init__(self, path: str, rpc: str, behaviour, port: int,
                 max_workers: int):
        grpc = _grpc()
        service, method = path.strip("/").split("/")
        make = getattr(grpc, f"{rpc}_rpc_method_handler")
        handler = grpc.method_handlers_generic_handler(
            service, {method: make(behaviour)})
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            handlers=(handler,), options=_MSG_OPTIONS)
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self):
        self._server.start()
        return self

    def stop(self, grace: Optional[float] = 1.0):
        """Stop serving; returns once the server has shut down."""
        self._server.stop(grace).wait()


class GreetingGrpcServer(_Server):
    """ProactiveGreeting.infer bidi-stream server around
    ``greeting_handler``: one response per request, in order."""

    def __init__(self, process_frame, port: int = 0,
                 view_hw: Tuple[int, int] = VIEW_HW, max_workers: int = 4,
                 device=None):
        handle = greeting_handler(process_frame, view_hw, device)

        def infer(request_iterator, context):
            for blob in request_iterator:
                yield handle(blob)

        super().__init__(pb.GREETING_INFER, "stream_stream", infer, port,
                         max_workers)


class EvalGrpcServer(_Server):
    """EvalServer.infer unary server around ``eval_handler``."""

    def __init__(self, score_clip, port: int = 0,
                 view_hw: Tuple[int, int] = VIEW_HW, max_workers: int = 4,
                 device=None):
        handle = eval_handler(score_clip, view_hw, device)
        super().__init__(pb.EVAL_INFER, "unary_unary",
                         lambda blob, context: handle(blob), port,
                         max_workers)


class GreetingGrpcClient:
    """Robot-side client of ProactiveGreeting.infer."""

    def __init__(self, target: str, timeout: Optional[float] = None):
        grpc = _grpc()
        self._channel = grpc.insecure_channel(target, options=_MSG_OPTIONS)
        self._infer = self._channel.stream_stream(
            pb.GREETING_INFER,
            request_serializer=pb.VideoRequest.encode,
            response_deserializer=pb.InferResponse.decode)
        self._timeout = timeout

    def infer(self, requests: Iterator[pb.VideoRequest]) -> Iterator[dict]:
        """Bidi stream: yields one parsed JSON decision per request."""
        for resp in self._infer(requests, timeout=self._timeout):
            yield json.loads(resp.response)

    @staticmethod
    def video_request(req_id: int, frame: np.ndarray, lag_ms: int = 0,
                      wakeup: str = "") -> pb.VideoRequest:
        """frame: uint8 BGR view image or float32 RGB letterboxed."""
        arr = np.ascontiguousarray(frame)
        return pb.VideoRequest(req_id=req_id, lag=lag_ms, wakeup=wakeup,
                               cur_frame=arr.tobytes())

    def close(self):
        self._channel.close()


class EvalGrpcClient:
    """Offline eval client."""

    def __init__(self, target: str, timeout: Optional[float] = 30.0):
        grpc = _grpc()
        self._channel = grpc.insecure_channel(target, options=_MSG_OPTIONS)
        self._infer = self._channel.unary_unary(
            pb.EVAL_INFER,
            request_serializer=pb.EvalRequest.encode,
            response_deserializer=pb.EvalResponse.decode)
        self._timeout = timeout

    def infer(self, frames: Sequence[np.ndarray]) -> dict:
        blob = b"".join(np.ascontiguousarray(f).tobytes() for f in frames)
        resp = self._infer(pb.EvalRequest(nframe=len(frames), frames=blob),
                           timeout=self._timeout)
        try:
            response = json.loads(resp.response) if resp.response else ""
        except json.JSONDecodeError:
            response = resp.response
        return {"response": response,
                "response_score": resp.response_score,
                "trigger_pred": resp.trigger_pred,
                "nullact_score": resp.nullact_score,
                "nullact_id": resp.nullact_id}

    def close(self):
        self._channel.close()
