"""The port's bridge to the native C++ serving runtime
(``hri/native_pipeline``, ``hri/stream_client``, ``cli/serving_bench``),
against the JAX package's bridge on the same library.

The library is built from ``runtime_cpp/`` by
``ops/build.build_native_runtime`` into ``build/torch_kernels/``. Both
packages' servers are driven with the same stub detections (computed from
the pixels, as in ``test_torch_serving``) and a small controller (D=32, 2
blocks) carried across by ``convert.ctrl_from_flax``. Each side samples
its action from its own random stream, so the sampled ids are not
compared: each side's wire ``response_score`` is held to the other side's
action distribution at its id, within 1e-5, as are ``trigger_pred`` and
``nullact_score``. On the CPU the controller's attention runs the kernel's
plain version and launches nothing.
"""

import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri import native_pipeline as jnp_native
from paddlerobotics_tpu.hri import stream_client as j_stream
from paddlerobotics_tpu.hri.attention_ctrl import (AttentionController as
                                                   JController)
from paddlerobotics_tpu.hri.attention_ctrl import AttnCtrlConfig as JConfig
from paddlerobotics_tpu.hri.attention_ctrl import \
    top_k_sampling as j_top_k_sampling

from paddlerobotics_torch import convert
from paddlerobotics_torch.cli import serving_bench
from paddlerobotics_torch.hri import native_pipeline as native
from paddlerobotics_torch.hri import stream_client
from paddlerobotics_torch.hri.attention_ctrl import AttnCtrlConfig
from paddlerobotics_torch.ops import attention, build
from test_torch_hri_ctrl import ctrl_variables
from test_torch_serving import CTRL, JStubScene, StubScene
from torch_parity import one_thread  # noqa: F401  (autouse)

TOL = 1e-5
NF, K = 10, 20


@pytest.fixture(scope="module")
def lib():
    path, info = build.build_native_runtime()
    return path


@pytest.fixture(scope="module")
def ctrls():
    jcfg = JConfig(**CTRL)
    params = ctrl_variables(jcfg, seed=3)
    ctrl = convert.ctrl_from_flax(params, AttnCtrlConfig(**CTRL),
                                  device="cpu")
    return jcfg, params, ctrl


def _frames(seed, n):
    return np.random.default_rng(seed).random((n, 416, 416, 3), np.float32)


def _jax_callbacks(jcfg, params, seen):
    """The JAX package's callbacks as its serving bench builds them, over
    the stub scene; ``seen`` keeps each attend's action distribution."""
    scene, ctrl = JStubScene(), JController(jcfg)
    tpf = jcfg.tokens_per_frame
    fid0 = jnp.repeat(jnp.arange(1, NF + 1), tpf)[None]

    @jax.jit
    def attend_jit(tokens, valid, key):
        out = ctrl.apply(params, {"visual_tokens": tokens}, fid0, valid)
        act_logits = out["act_logits"][:, -1:, :]
        return (jax.nn.sigmoid(out["trigger_logits"][0, -1]),
                jax.nn.sigmoid(out["obj_logits"][0, -tpf:]),
                j_top_k_sampling(key, act_logits, 1.0, 5)[0, 0],
                jax.nn.softmax(act_logits[0, 0]))

    key = [jax.random.key(5)]

    def detect(img):
        inst = scene.get_instances_with_feats(None, jnp.asarray(img)[None])
        return (np.asarray(inst.boxes[0]), np.asarray(inst.scores[0]),
                np.asarray(inst.tokens[0]), np.asarray(inst.valid[0]))

    def attend(tokens, valid):
        key[0], k = jax.random.split(key[0])
        tr, ob, a, acts = attend_jit(
            jnp.asarray(tokens).reshape(1, NF * tpf, -1),
            jnp.asarray(valid, jnp.float32).reshape(1, NF * tpf), k)
        seen.append(np.asarray(acts))
        return float(tr), np.asarray(ob), int(a), np.asarray(acts)

    return detect, attend


def _port_callbacks(ctrl, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return native.ServiceCallbacks(StubScene(), ctrl, gen, device="cpu")


def test_runtime_builds_outside_runtime_cpp_build(lib):
    """The library lands in a hashed directory of build/torch_kernels/, not
    in runtime_cpp/build/, whose presence decides whether the JAX package's
    native tests run; a second call loads the same file."""
    p = pathlib.Path(lib)
    assert p.name == "libserving_capi.so" and p.exists()
    assert p.parent.parent == build.BUILD_DIR
    assert build.RUNTIME_DIR / "build" not in p.parents
    again, info = build.build_native_runtime()
    assert again == lib and info["compiler"].startswith("g++")


@pytest.mark.parametrize("threshold,reason", [(0.0, None),
                                              (1.0, "below_threshold")])
def test_eval_server_matches_jax(lib, ctrls, threshold, reason):
    jcfg, params, ctrl = ctrls
    seen_j = []
    jdet, jatt = _jax_callbacks(jcfg, params, seen_j)
    cbs = _port_callbacks(ctrl)
    num_act = CTRL["num_actions"]
    jserver = jnp_native.NativeEvalServer(
        jdet, jatt, num_act=num_act, trigger_threshold=threshold,
        near_field_frac=0.0, lib_path=lib)
    server = native.NativeEvalServer(
        cbs.detect, cbs.attend, num_act=num_act, trigger_threshold=threshold,
        near_field_frac=0.0, lib_path=lib)
    jclient = client = None
    launches = attention.flash_attention.launches
    try:
        jclient = j_stream.EvalStreamClient(port=jserver.port)
        client = stream_client.EvalStreamClient(port=server.port)
        for n in (10, 3):                       # full and left-padded
            frames = list(_frames(n, n))
            out_j, out_t = jclient.infer(frames), client.infer(frames)
            acts_j, acts_t = seen_j[-1], cbs.last["act_scores"]
            np.testing.assert_allclose(acts_t, acts_j, atol=TOL)
            assert abs(out_t["trigger_pred"] - out_j["trigger_pred"]) <= TOL
            assert abs(out_t["nullact_score"] - out_j["nullact_score"]) <= TOL
            assert out_t["nullact_id"] == out_j["nullact_id"]
            r_t, r_j = out_t["response"], out_j["response"]
            assert r_t["triggered"] == r_j["triggered"]
            assert r_t.get("reason") == r_j.get("reason") == reason
            if reason is None:
                np.testing.assert_allclose(r_t["target_bbox"],
                                           r_j["target_bbox"], atol=TOL)
                assert r_t["action_id"] != 0
                assert abs(out_t["response_score"]
                           - acts_j[r_t["action_id"]]) <= TOL
                assert abs(out_j["response_score"]
                           - acts_t[r_j["action_id"]]) <= TOL
            else:
                assert out_t["response_score"] == out_j["response_score"] == 0
        assert cbs.detect_calls == 13 and cbs.attend_calls == 2
    finally:
        for c in (jclient, client):
            if c is not None:
                c.close()
        jserver.close()
        server.close()
    assert attention.flash_attention.launches == launches


def _stub_detect(img):
    boxes = np.array([[100, 20, 200, 380]], np.float32)
    return (boxes, np.array([0.9], np.float32),
            np.full((1, 562), float(img[0, 0, 0]), np.float32),
            np.array([1], np.int32))


def _stub_attend(tokens, valid):
    m = float(tokens[valid > 0].mean()) if (valid > 0).any() else 0.0
    return m, np.array([0.8], np.float32), 2, np.array(
        [0.05, 0.15, 0.6, 0.2], np.float32)


def test_pipeline_roundtrip_and_lock_step_stream(lib):
    """submit/poll through the C++ pipeline, then the length-prefixed
    stream in front of it: decisions echo the frame the window ended on.
    Frames are paced until the window is full (queued frames beyond the
    queue's 8 are dropped oldest-first), then sent lock-step."""
    calls = {"detect": 0, "attend": 0}

    def detect(img):
        calls["detect"] += 1
        return _stub_detect(img)

    def attend(tokens, valid):
        calls["attend"] += 1
        return _stub_attend(tokens, valid)

    make = lambda: native.NativePipeline(detect, attend,
                                         trigger_threshold=0.8,
                                         near_field_frac=0.1, cooldown_s=0.0,
                                         lib_path=lib)
    img = np.full((416, 416, 3), 0.9, np.float32)
    pipe = make()
    try:
        deadline, decision, i = time.time() + 30.0, None, 0
        while time.time() < deadline and decision is None:
            pipe.submit(img, i, timestamp=time.time())
            i += 1
            time.sleep(0.01)
            decision = pipe.poll()
        assert decision is not None, calls
        assert decision["triggered"] and decision["action_id"] == 2
        assert abs(decision["trigger_score"] - 0.9) <= 1e-6
        assert calls["detect"] >= 10 and calls["attend"] >= 1
    finally:
        pipe.close()
    pipe, client = make(), None
    try:
        client = stream_client.GreetingStreamClient(port=pipe.serve(0))
        client.set_timeout(0.02)
        filled, i = False, 0
        while not filled and i < 1000:
            client.send_frame(i, img, lag_ms=20, wakeup="hi" if i == 0 else "")
            i += 1
            try:
                filled = client.read_response()["frame_id"] >= 0
            except TimeoutError:
                pass
        assert filled
        client.set_timeout(0.5)
        try:                    # drain the decisions still in flight
            while True:
                client.read_response()
        except TimeoutError:
            pass
        client.set_timeout(30.0)
        for fid in range(1000, 1003):
            client.send_frame(fid, img)
            resp = client.read_response()
            assert resp["frame_id"] == fid, resp
            assert resp["triggered"] is True and resp["action_id"] == 2
        pipe.check()
    finally:
        if client is not None:
            client.close()
        pipe.close()


def test_serving_bench_stream_arms(lib, ctrls):
    """Both stream arms of cli/serving_bench on the small controller: every
    decision is one attend call, the sync arm answers every frame, and the
    callback intervals give an overlap no larger than either total."""
    _, _, ctrl = ctrls
    cbs = _port_callbacks(ctrl)
    frames = list(_frames(4, 4))
    rows = [serving_bench.arm_stream(cbs, frames, 4, pipelined=False,
                                     pace_s=0.1, lib_path=lib),
            serving_bench.arm_stream(cbs, frames, 6, pipelined=True,
                                     pace_s=0.1, offered_fps=25.0,
                                     lib_path=lib)]
    sync, piped = rows
    assert sync["decisions"] == 4 and sync["dropped"] == 0
    assert sync["attend_calls"] >= 4 + 2
    assert piped["decisions"] + piped["dropped"] == 6
    assert piped["decisions"] >= 1
    for r in rows:
        assert r["detect_calls"] >= r["attend_calls"] > 0
        assert 0.0 <= r["overlap_s"] <= min(r["detect_s"], r["attend_s"])
        assert np.isfinite(r["fps"]) and r["p50_ms"] > 0


def test_overlap_of_intervals():
    iv = [("detect", 0.0, 1.0), ("attend", 0.5, 1.5), ("detect", 1.2, 2.0),
          ("attend", 3.0, 4.0)]
    assert native.overlap(iv) == pytest.approx(
        {"overlap_s": 0.8, "detect_s": 1.8, "attend_s": 2.0})


def test_grpc_server_interop(lib, ctrls):
    """grpcio clients of hri/grpc_transport ↔ the C++ gRPC front with the
    port's callbacks, on uint8 BGR 360×640 views: C++ letterboxes them with
    its own nearest-neighbour resize, so the reference is the controller on
    the frames the detect callback received, not on hri/utils' letterbox
    of the views."""
    pytest.importorskip("grpc")
    from paddlerobotics_torch.hri.grpc_transport import (EvalGrpcClient,
                                                         GreetingGrpcClient)
    _, _, ctrl = ctrls
    cbs = _port_callbacks(ctrl)
    received = []

    def detect(img):
        received.append(img)
        return cbs.detect(img)

    server = native.NativeGrpcServer(detect, cbs.attend,
                                     num_act=CTRL["num_actions"],
                                     trigger_threshold=0.0,
                                     near_field_frac=0.0, lib_path=lib)
    greet = ev = None
    rng = np.random.default_rng(6)
    views = rng.integers(0, 256, (12, 360, 640, 3), dtype=np.uint8)
    try:
        greet = GreetingGrpcClient(f"127.0.0.1:{server.port}", timeout=60)
        outs = list(greet.infer(iter(
            [greet.video_request(i, v) for i, v in enumerate(views)])))
        assert len(outs) == 12 and outs[0]["reason"] == "pending"
        decided = [o for o in outs if "frame_id" in o]
        assert decided and all(o["triggered"] for o in decided)
        ref = _reference_triggers(ctrl, np.stack(received[:12]))
        for o in decided:
            assert abs(o["trigger_score"] - ref[o["frame_id"]]) <= TOL
        ev = EvalGrpcClient(f"127.0.0.1:{server.port}", timeout=60)
        out = ev.infer(list(views[:10]))
        ref_eval = _reference_triggers(ctrl, np.stack(received[12:22]))
        assert abs(out["trigger_pred"] - ref_eval[9]) <= TOL
        assert abs(out["nullact_score"] - cbs.last["act_scores"][0]) <= TOL
        # the letterbox is C++'s: grey bands above and below the view
        assert np.all(received[0][:, :, :] >= 0)
        assert np.all(received[0][0] == np.float32(0.5))
        server.check()
    finally:
        for c in (greet, ev):
            if c is not None:
                c.close()
        server.close()


def _reference_triggers(ctrl, frames):
    """Trigger score of each window end (index ≥ 9) of ``frames`` through
    the stub scene and the controller in process."""
    inst = StubScene().get_instances_with_feats(torch.as_tensor(frames))
    fids = torch.arange(1, NF + 1).repeat_interleave(K)[None]
    out = {}
    for end in range(NF - 1, len(frames)):
        tok = inst.tokens[end - NF + 1:end + 1].reshape(1, NF * K, -1)
        pad = inst.valid[end - NF + 1:end + 1].reshape(1, NF * K).float()
        with torch.no_grad():
            o = ctrl({"visual_tokens": tok}, fids, pad, use_kernel=True)
        out[end] = float(torch.sigmoid(o["trigger_logits"][0, -1]))
    return out


def _boom(*a):
    raise ValueError("boom")


@pytest.mark.parametrize("which", ["eval_detect", "eval_attend",
                                   "pipeline_attend", "clip_score"])
def test_callback_error_surfaces(lib, which):
    """ctypes swallows an exception raised in a callback; the handle keeps
    the first one and check() and close() raise it."""
    if which == "pipeline_attend":
        h = native.NativePipeline(_stub_detect, _boom, lib_path=lib)
        img = np.zeros((416, 416, 3), np.float32)
        # paced: frames queued faster than the detector drains them are
        # dropped oldest-first, and the window would not fill
        deadline, i = time.time() + 30.0, 0
        while h._error is None and time.time() < deadline:
            h.submit(img, i)
            i += 1
            time.sleep(0.01)
        with pytest.raises(native.NativeCallbackError, match="boom"):
            h.poll()
    else:
        if which == "clip_score":
            h = native.NativeClipEvalServer(_boom, 4, lib_path=lib)
        else:
            det, att = ((_boom, _stub_attend) if which == "eval_detect"
                        else (_stub_detect, _boom))
            h = native.NativeEvalServer(det, att, 4, lib_path=lib)
        client = stream_client.EvalStreamClient(port=h.port)
        try:
            out = client.infer([np.full((416, 416, 3), 0.5, np.float32)] * 2)
        finally:
            client.close()
        assert out["trigger_pred"] == 0.0       # what C++ carried on with
    with pytest.raises(native.NativeCallbackError, match="boom"):
        h.check()
    with pytest.raises(native.NativeCallbackError, match="boom"):
        h.close()
