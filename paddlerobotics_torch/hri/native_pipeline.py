"""ctypes bridge to the native (C++) serving runtime (port of the JAX
package's ``hri/native_pipeline.py``, over the same C ABI,
``runtime_cpp/src/capi.cpp``).

The native side (``libserving_capi.so``, built from ``runtime_cpp/`` by
``ops/build.build_native_runtime`` at first use) owns the thread pipeline,
the windows, the business rules and the transports, and calls back into
Python for the model programs: here the port's scene sensor and controller
(``ServiceCallbacks``, the attention kernel on the card) or R(2+1)D
(``hri/r2plus1d_train.ClipScorer``). Frames go down, decisions come up.

Three things differ from a plain ctypes binding:

- ctypes prints an exception raised inside a callback and returns 0, and
  the C++ side carries on with zeros. Every callback here records the
  first exception instead; ``check()`` raises it, and so do ``poll()``
  and ``close()``. After one, the handle's callbacks return at once.
- The callbacks run on the runtime's detector and controller threads.
  ``ServiceCallbacks`` makes its device current in each call and draws
  from its own ``torch.Generator``.
- Every ``CFUNCTYPE`` object is kept for the handle's lifetime.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.attention_ctrl import top_k_sampling

TOKEN_DIM = 562
MAX_INSTANCES = 20
NUM_FRAMES = 10
CLIP_LEN = 8     # OB_WINDOW_LEN, jetson/eval_r2plus1d.cpp:47
CLIP_RES = 224   # IMG_RESIZE, eval_r2plus1d.cpp:43

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
# detect(pixels) → fills boxes, scores, tokens, valid; returns the count
_DETECT_FN = ctypes.CFUNCTYPE(ctypes.c_int, _F, _F, _F, _F, _I)
# attend(tokens, valid) → trigger, obj scores, action id
_ATTEND_FN = ctypes.CFUNCTYPE(None, _F, _I, _F, _F, _I)
# attend for eval: also the last frame's action distribution (num_act)
_ATTEND_EVAL_FN = ctypes.CFUNCTYPE(None, _F, _I, _F, _F, _I, _F)
# clip score: preprocessed clip → action distribution, sampled id
_CLIP_SCORE_FN = ctypes.CFUNCTYPE(None, _F, _F, _I)


@functools.lru_cache(maxsize=None)
def _load(lib_path: Optional[str]) -> ctypes.CDLL:
    """The runtime library (built at first use unless a path is given),
    with every entry point's signature bound."""
    if lib_path is None:
        from paddlerobotics_torch.ops.build import build_native_runtime
        lib_path = build_native_runtime()[0]
    lib = ctypes.CDLL(lib_path)
    vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    us, d = ctypes.c_ushort, ctypes.c_double
    sigs = {
        "pipeline_create": (vp, [f, f, d, _DETECT_FN, _ATTEND_FN]),
        "pipeline_submit": (None, [vp, _F, ctypes.c_long, d]),
        "pipeline_poll": (i, [vp, _I, _F, _I, _F]),
        "pipeline_destroy": (None, [vp]),
        "server_create": (vp, [vp, us]),
        "server_port": (i, [vp]),
        "server_destroy": (None, [vp]),
        "eval_server_create": (vp, [_DETECT_FN, _ATTEND_EVAL_FN, i, f, f,
                                    us]),
        "eval_server_create_r2p1d": (vp, [_CLIP_SCORE_FN, i, us]),
        "eval_server_port": (i, [vp]),
        "eval_server_destroy": (None, [vp]),
        "grpc_server_create": (vp, [_DETECT_FN, _ATTEND_EVAL_FN, i, f, f, d,
                                    us]),
        "grpc_server_port": (i, [vp]),
        "grpc_server_destroy": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


class NativeCallbackError(RuntimeError):
    """A Python callback raised inside the native runtime."""


class _Handle:
    """A native object, the ctypes callbacks it calls, and the first
    exception any of them raised."""

    _destroy = ""

    def __init__(self, lib_path: Optional[str]):
        self._lib = _load(lib_path)
        self._keep = []
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._handle = None

    def _callback(self, proto, fn: Callable, default=None):
        def call(*args):
            if self._error is not None:
                return default
            try:
                return fn(*args)
            except Exception as e:      # the C++ side cannot take it
                with self._error_lock:
                    if self._error is None:
                        self._error = e
                return default

        c = proto(call)
        self._keep.append(c)
        return c

    def check(self) -> None:
        """Raise the first exception a callback raised, if any."""
        if self._error is not None:
            raise NativeCallbackError(
                f"a callback of the native runtime raised "
                f"{type(self._error).__name__}: {self._error}"
            ) from self._error

    def close(self) -> None:
        """Stop the native threads and free the object; then ``check()``."""
        if self._handle:
            getattr(self._lib, self._destroy)(self._handle)
            self._handle = None
        self.check()

    def _detect_cb(self, detect):
        """detect(img (416,416,3)) → (boxes (K,4), scores (K,),
        tokens (K,562), valid (K,)) as the C detect callback."""
        def cb(pixels, boxes, scores, tokens, valid):
            img = np.ctypeslib.as_array(pixels, (416, 416, 3)).copy()
            b, s, t, v = detect(img)
            k = min(len(b), MAX_INSTANCES)
            np.ctypeslib.as_array(boxes, (MAX_INSTANCES * 4,))[:k * 4] = \
                np.asarray(b, np.float32)[:k].reshape(-1)
            np.ctypeslib.as_array(scores, (MAX_INSTANCES,))[:k] = \
                np.asarray(s, np.float32)[:k]
            np.ctypeslib.as_array(
                tokens, (MAX_INSTANCES * TOKEN_DIM,))[:k * TOKEN_DIM] = \
                np.asarray(t, np.float32)[:k].reshape(-1)
            np.ctypeslib.as_array(valid, (MAX_INSTANCES,))[:k] = \
                np.asarray(v, np.int32)[:k]
            return k

        return self._callback(_DETECT_FN, cb, 0)

    def _attend_cb(self, attend, num_act: Optional[int] = None):
        """attend(tokens (F,K,562), valid (F,K)) → (trigger, obj (K,),
        action_id[, act_scores (num_act,)]) as the C attend callback (the
        eval form when ``num_act`` is given)."""
        def cb(tokens, valid, trigger, obj, act, act_scores=None):
            t = np.ctypeslib.as_array(
                tokens, (NUM_FRAMES, MAX_INSTANCES, TOKEN_DIM)).copy()
            v = np.ctypeslib.as_array(valid,
                                      (NUM_FRAMES, MAX_INSTANCES)).copy()
            out = attend(t, v)
            trigger[0] = float(out[0])
            ob = np.asarray(out[1], np.float32)[:MAX_INSTANCES]
            np.ctypeslib.as_array(obj, (MAX_INSTANCES,))[:ob.size] = ob
            act[0] = int(out[2])
            if num_act is not None:
                acts = np.asarray(out[3], np.float32)[:num_act]
                np.ctypeslib.as_array(act_scores, (num_act,))[:acts.size] = \
                    acts

        return self._callback(
            _ATTEND_FN if num_act is None else _ATTEND_EVAL_FN, cb)


class NativePipeline(_Handle):
    """Python handle on the C++ GreetingPipeline with Python callbacks."""

    _destroy = "pipeline_destroy"

    def __init__(self, detect: Callable[[np.ndarray], tuple],
                 attend: Callable[[np.ndarray, np.ndarray], tuple],
                 trigger_threshold: float = 0.8,
                 near_field_frac: float = 0.1,
                 cooldown_s: float = 5.0,
                 lib_path: Optional[str] = None):
        """detect(pixels (416,416,3)) → (boxes (K,4), scores (K,),
        tokens (K,562), valid (K,)); attend(tokens (F,K,562),
        valid (F,K)) → (trigger, obj_scores (K,), action_id, ...)."""
        super().__init__(lib_path)
        self._server = None
        self._handle = self._lib.pipeline_create(
            trigger_threshold, near_field_frac, cooldown_s,
            self._detect_cb(detect), self._attend_cb(attend))

    def submit(self, image: np.ndarray, frame_id: int,
               timestamp: float = 0.0):
        img = np.ascontiguousarray(image, np.float32)
        if img.size != 416 * 416 * 3:
            raise ValueError(f"a frame is 416·416·3 floats, not {img.shape}")
        self._lib.pipeline_submit(self._handle, img.ctypes.data_as(_F),
                                  frame_id, timestamp)

    def poll(self) -> Optional[dict]:
        self.check()
        trig, score, act = ctypes.c_int(), ctypes.c_float(), ctypes.c_int()
        bbox = (ctypes.c_float * 4)()
        if not self._lib.pipeline_poll(self._handle, ctypes.byref(trig),
                                       ctypes.byref(score),
                                       ctypes.byref(act), bbox):
            return None
        return {"triggered": bool(trig.value),
                "trigger_score": score.value,
                "action_id": act.value,
                "target_bbox": list(bbox)}

    def serve(self, port: int = 0) -> int:
        """Expose this pipeline over the native streaming transport
        (``runtime_cpp/src/stream_server.cpp``). Returns the bound port
        (ephemeral when port=0). Client: ``hri/stream_client``."""
        self._server = self._lib.server_create(self._handle, port)
        return int(self._lib.server_port(self._server))

    def close(self):
        if self._server:
            self._lib.server_destroy(self._server)
            self._server = None
        super().close()


class NativeEvalServer(_Handle):
    """Python handle on the C++ offline EvalServer
    (``runtime_cpp/src/eval_server.cpp``): scores whole frame windows per
    request. Client: ``hri/stream_client.EvalStreamClient``."""

    _destroy = "eval_server_destroy"

    def __init__(self, detect: Callable[[np.ndarray], tuple],
                 attend: Callable[[np.ndarray, np.ndarray], tuple],
                 num_act: int, trigger_threshold: float = 0.8,
                 near_field_frac: float = 0.1, port: int = 0,
                 lib_path: Optional[str] = None):
        """detect as NativePipeline; attend(tokens (F,K,562),
        valid (F,K)) → (trigger, obj_scores (K,), action_id,
        act_scores (num_act,))."""
        super().__init__(lib_path)
        self._handle = self._lib.eval_server_create(
            self._detect_cb(detect), self._attend_cb(attend, num_act),
            num_act, trigger_threshold, near_field_frac, port)
        self.port = int(self._lib.eval_server_port(self._handle))


class NativeClipEvalServer(_Handle):
    """Python handle on the C++ EvalServer's R(2+1)D variant: the clip
    preprocessing (416-letterbox → 224 CHW Kinetics-normalized), windowing,
    null-action rule and transport are native; ``score`` is the model.
    Client: ``hri/stream_client.EvalStreamClient``."""

    _destroy = "eval_server_destroy"

    def __init__(self, score: Callable[[np.ndarray], tuple], num_act: int,
                 port: int = 0, lib_path: Optional[str] = None):
        """score(clip (CLIP_LEN,3,224,224) float32) →
        (act_scores (num_act,), sampled_id)."""
        super().__init__(lib_path)

        def cb(clip, act_scores, sampled_id):
            c = np.ctypeslib.as_array(
                clip, (CLIP_LEN, 3, CLIP_RES, CLIP_RES)).copy()
            acts, sid = score(c)
            acts = np.asarray(acts, np.float32)[:num_act]
            np.ctypeslib.as_array(act_scores, (num_act,))[:acts.size] = acts
            sampled_id[0] = int(sid)

        self._handle = self._lib.eval_server_create_r2p1d(
            self._callback(_CLIP_SCORE_FN, cb), num_act, port)
        self.port = int(self._lib.eval_server_port(self._handle))


class NativeGrpcServer(_Handle):
    """Python handle on the C++ gRPC front (``runtime_cpp/src/
    grpc_server.cpp``, HTTP/2 + HPACK): ``/grpc.ProactiveGreeting/infer``
    (bidi, lock-step, a GreetingPipeline behind it) and
    ``/evalserver.EvalServer/infer`` (unary) on one port. Clients:
    ``hri/grpc_transport.GreetingGrpcClient`` / ``EvalGrpcClient``.

    It letterboxes a uint8 BGR 360×640 view in C++ with a nearest-neighbour
    resize, so its pixels are not those of ``hri/utils.letterbox_image``."""

    _destroy = "grpc_server_destroy"

    def __init__(self, detect: Callable[[np.ndarray], tuple],
                 attend: Callable[[np.ndarray, np.ndarray], tuple],
                 num_act: int, trigger_threshold: float = 0.8,
                 near_field_frac: float = 0.1, cooldown_s: float = 0.0,
                 port: int = 0, lib_path: Optional[str] = None):
        """Callbacks exactly as NativeEvalServer."""
        super().__init__(lib_path)
        self._handle = self._lib.grpc_server_create(
            self._detect_cb(detect), self._attend_cb(attend, num_act),
            num_act, trigger_threshold, near_field_frac, cooldown_s, port)
        self.port = int(self._lib.grpc_server_port(self._handle))


class ServiceCallbacks:
    """The runtime's two model programs over the port's scene sensor and
    attention controller (``ProactiveGreetingService``'s parts), on the card
    unless ``device`` says otherwise.

    ``detect(img)`` runs ``scene.get_instances_with_feats`` on one frame;
    ``attend(tokens, valid)`` the controller on the window with the
    hand-written attention kernel (``use_kernel=True``: 6 launches per
    call at the default depth), then the trigger and object sigmoids, a
    top-k sample without the null action from ``generator`` and the last
    frame's action softmax. Each reads back one tensor. ``detect_calls`` /
    ``attend_calls`` count the calls, ``intervals`` holds each call's
    (kind, start, end) on the host clock (``overlap`` reads it), and
    ``last`` the newest attend's outputs."""

    def __init__(self, scene, ctrl, generator: Optional[torch.Generator]
                 = None, temperature: float = 1.0, top_k: int = 5,
                 device=None):
        self.device = resolve_device(device)
        self.scene, self.ctrl = scene, ctrl
        self.temperature, self.top_k = temperature, top_k
        if generator is None:
            generator = torch.Generator(self.device)
            generator.manual_seed(0)
        self.generator = generator
        cfg = ctrl.cfg
        self.nf, self.tpf = cfg.num_frames, cfg.tokens_per_frame
        self.frame_ids = torch.arange(
            1, self.nf + 1, device=self.device).repeat_interleave(
                self.tpf)[None]
        self.detect_calls = self.attend_calls = 0
        self.intervals: list = []
        self.last: dict = {}

    @classmethod
    def from_service(cls, svc) -> "ServiceCallbacks":
        c = svc.cfg
        return cls(svc.scene, svc.ctrl, svc.generator, c.temperature,
                   c.top_k, svc.device)

    def _on_device(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    @torch.no_grad()
    def detect(self, img: np.ndarray):
        t0 = time.perf_counter()
        with self._on_device():
            x = torch.as_tensor(img, dtype=torch.float32,
                                device=self.device)[None]
            inst = self.scene.get_instances_with_feats(x)
            host = torch.cat([inst.boxes[0].reshape(-1), inst.scores[0],
                              inst.tokens[0].reshape(-1),
                              inst.valid[0].to(torch.float32)]).cpu().numpy()
        k = inst.scores.shape[1]
        boxes = host[:4 * k].reshape(k, 4)
        scores = host[4 * k:5 * k]
        tokens = host[5 * k:5 * k + k * TOKEN_DIM].reshape(k, TOKEN_DIM)
        valid = host[5 * k + k * TOKEN_DIM:].astype(np.int32)
        self.detect_calls += 1
        self.intervals.append(("detect", t0, time.perf_counter()))
        return boxes, scores, tokens, valid

    @torch.no_grad()
    def attend(self, tokens: np.ndarray, valid: np.ndarray):
        t0 = time.perf_counter()
        nf, tpf = self.nf, self.tpf
        with self._on_device():
            tok = torch.as_tensor(tokens, dtype=torch.float32,
                                  device=self.device).reshape(1, nf * tpf, -1)
            pad = torch.as_tensor(valid, dtype=torch.float32,
                                  device=self.device).reshape(1, nf * tpf)
            out = self.ctrl({"visual_tokens": tok}, self.frame_ids, pad,
                            use_kernel=True)
            trig = torch.sigmoid(out["trigger_logits"][0, -1:])
            obj = torch.sigmoid(out["obj_logits"][0, -tpf:])
            act_logits = out["act_logits"][:, -1:, :]
            act_id = top_k_sampling(act_logits, self.temperature, self.top_k,
                                    generator=self.generator)[0]
            acts = torch.softmax(act_logits[0, 0], dim=-1)
            host = torch.cat([trig, obj, act_id.to(torch.float32),
                              acts]).cpu().numpy()
        trigger, obj_s = float(host[0]), host[1:1 + tpf]
        act, act_scores = int(host[1 + tpf]), host[2 + tpf:]
        self.attend_calls += 1
        self.last = {"trigger": trigger, "obj_scores": obj_s,
                     "action_id": act, "act_scores": act_scores}
        self.intervals.append(("attend", t0, time.perf_counter()))
        return trigger, obj_s, act, act_scores


def overlap(intervals) -> dict:
    """Seconds in which a detect call and an attend call ran at once, beside
    each kind's total, from ``ServiceCallbacks.intervals``."""
    det = sorted((a, b) for k, a, b in intervals if k == "detect")
    att = sorted((a, b) for k, a, b in intervals if k == "attend")
    both, j = 0.0, 0
    for a0, a1 in att:
        while j < len(det) and det[j][1] <= a0:
            j += 1
        for d0, d1 in det[j:]:
            if d0 >= a1:
                break
            both += min(a1, d1) - max(a0, d0)
    return {"overlap_s": both,
            "detect_s": sum(b - a for a, b in det),
            "attend_s": sum(b - a for a, b in att)}
