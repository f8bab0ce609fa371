"""Port parity of the HRI serving path (``hri/serving.py``,
``hri/eval_client.py``) and of the slice as a whole.

The same frames go through the JAX ``ProactiveGreetingService`` and the
port's, with a controller carried across by ``convert.ctrl_from_flax``
(D=32, 2 blocks, 2 heads, ffn 64, 10×20 tokens, 7 actions). Decisions
agree: reason, ``triggered``, ``trigger_score`` to 1e-5, target bbox and
``target_obj_score`` to 1e-5. Sampling draws from a torch generator where
JAX splits a key, so ``action_id`` is checked to lie in the top-k set of
the port's logits and not to be the null action. On the CPU the service's
attention calls run the kernel's plain version and launch nothing.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri import actions as j_actions
from paddlerobotics_tpu.hri.attention_ctrl import AttnCtrlConfig as JConfig
from paddlerobotics_tpu.hri.eval_client import OfflineEvaluator as JEvaluator
from paddlerobotics_tpu.hri.perception.scene import Instances as JInstances
from paddlerobotics_tpu.hri.perception.scene import SceneSensor as JScene
from paddlerobotics_tpu.hri.serving import (ProactiveGreetingService as
                                            JService)
from paddlerobotics_tpu.hri.serving import ServiceConfig as JServiceConfig

from paddlerobotics_torch import convert
from paddlerobotics_torch.hri import actions
from paddlerobotics_torch.hri.attention_ctrl import AttnCtrlConfig
from paddlerobotics_torch.hri.eval_client import OfflineEvaluator
from paddlerobotics_torch.hri.perception.scene import Instances, MAX_INSTANCES
from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                              ServiceConfig)
from paddlerobotics_torch.ops import attention
from test_torch_hri_ctrl import ctrl_variables
from test_torch_perception import yolo_variables

TOL = 1e-5
K = MAX_INSTANCES
CTRL = dict(num_actions=7, num_frames=10, tokens_per_frame=K, model_dim=32,
            num_decoder_blocks=2, num_heads=2, ffn_dim=64, act_tr_dim=10)
FRAMES = 12


class JStubScene:
    """SceneSensor stand-in computed from the pixels: 1–3 detections per
    frame, tokens and box heights read off the image."""

    def get_instances_with_feats(self, params, images):
        B = images.shape[0]
        n = 1 + jnp.floor(3.0 * images[:, 0, 0, 0]).astype(jnp.int32)
        valid = jnp.arange(K)[None] < n[:, None]
        tokens = images.reshape(B, -1)[:, :K * 562].reshape(B, K, 562)
        kk = jnp.broadcast_to(jnp.arange(K, dtype=jnp.float32), (B, K))
        boxes = jnp.stack([150.0 + 5.0 * kk, jnp.full((B, K), 60.0),
                           260.0 + 5.0 * kk, 60.0 + 320.0 * images[:, 1, :K, 0]],
                          axis=-1)
        vf = valid.astype(jnp.float32)
        return JInstances(boxes=boxes * vf[..., None], scores=0.9 * vf,
                          classes=jnp.zeros((B, K), jnp.int32), valid=valid,
                          tokens=tokens * vf[..., None],
                          feats=jnp.zeros((B, K, 5, 5, 8)))


class StubScene:
    """The port's counterpart of JStubScene."""

    def get_instances_with_feats(self, images):
        B = images.shape[0]
        n = 1 + torch.floor(3.0 * images[:, 0, 0, 0]).to(torch.int64)
        valid = torch.arange(K)[None] < n[:, None]
        tokens = images.reshape(B, -1)[:, :K * 562].reshape(B, K, 562)
        kk = torch.arange(K, dtype=torch.float32).expand(B, K)
        boxes = torch.stack([150.0 + 5.0 * kk, torch.full((B, K), 60.0),
                             260.0 + 5.0 * kk,
                             60.0 + 320.0 * images[:, 1, :K, 0]], dim=-1)
        vf = valid.to(torch.float32)
        return Instances(boxes=boxes * vf[..., None], scores=0.9 * vf,
                         classes=torch.zeros((B, K), dtype=torch.int64),
                         valid=valid, tokens=tokens * vf[..., None],
                         feats=torch.zeros((B, K, 5, 5, 8)))


@pytest.fixture(scope="module")
def ctrl_pair():
    jcfg = JConfig(**CTRL)
    params = ctrl_variables(jcfg, seed=2)
    return jcfg, params


def _services(ctrl_pair, scfg: dict, jscene, jscene_params, scene):
    jcfg, params = ctrl_pair
    catalog = [("wave", "smile", f"hi {i}") for i in range(CTRL["num_actions"])]
    jsvc = JService(JServiceConfig(**scfg), jscene, jscene_params, jcfg,
                    params, [j_actions.MultimodalAction(*c) for c in catalog])
    ctrl = convert.ctrl_from_flax(params, AttnCtrlConfig(**CTRL),
                                  device="cpu")
    gen = torch.Generator().manual_seed(0)
    svc = ProactiveGreetingService(
        ServiceConfig(**scfg), scene, ctrl,
        [actions.MultimodalAction(*c) for c in catalog], generator=gen,
        device="cpu")
    return jsvc, svc


def _run_and_compare(jsvc, svc, frames, top_k: int):
    logits = []
    attend = svc._attend

    def recording_attend(*a):
        out = attend(*a)
        logits.append(out["act_logits"][0, -1].numpy())
        return out

    svc._attend = recording_attend
    launches = attention.flash_attention.launches
    decisions = []
    for img in frames:
        d_j = jsvc.process_frame(img)
        d_t = svc.process_frame(img)
        decisions.append(d_t)
        assert set(d_t) == set(d_j)
        assert d_t.get("reason") == d_j.get("reason")
        assert d_t["triggered"] == d_j["triggered"]
        if "trigger_score" in d_j:
            assert abs(d_t["trigger_score"] - d_j["trigger_score"]) <= TOL
        if d_j["triggered"]:
            np.testing.assert_allclose(d_t["target_bbox"], d_j["target_bbox"],
                                       atol=TOL)
            assert abs(d_t["target_obj_score"] -
                       d_j["target_obj_score"]) <= TOL
            lg = logits[-1].copy()
            lg[0] = -np.inf
            assert d_t["action_id"] != 0
            assert d_t["action_id"] in np.argsort(lg)[-top_k:]
            assert d_t["utterance"] == f"hi {d_t['action_id']}"
    assert attention.flash_attention.launches == launches
    assert len(logits) == len(frames) - 9
    return decisions


@pytest.mark.parametrize("scfg,expect", [
    (dict(trigger_threshold=0.0, wakeup_cooldown_s=0.0, near_field_frac=0.1),
     {None}),
    (dict(trigger_threshold=0.0, wakeup_cooldown_s=1e9, near_field_frac=0.1),
     {None, "cooldown"}),
    (dict(trigger_threshold=0.0, wakeup_cooldown_s=0.0, near_field_frac=2.0),
     {None, "far_field"}),
    (dict(trigger_threshold=1.0), {None}),
], ids=["sample", "cooldown", "far_field", "below_threshold"])
def test_stub_service_decisions_match(ctrl_pair, scfg, expect):
    jsvc, svc = _services(ctrl_pair, scfg, JStubScene(), None, StubScene())
    rng = np.random.default_rng(7)
    frames = rng.random((FRAMES, 416, 416, 3), np.float32)
    ds = _run_and_compare(jsvc, svc, frames, ServiceConfig().top_k)
    assert all(d["reason"] == "window_filling" for d in ds[:9])
    assert {d.get("reason") for d in ds[9:]} == expect
    assert json.loads(svc.to_json(ds[-1])) == ds[-1]


def test_score_windows_match(ctrl_pair):
    jsvc, svc = _services(ctrl_pair, {}, JStubScene(), None, StubScene())
    rng = np.random.default_rng(8)
    N = 6
    windows = rng.standard_normal((N, 10, K, 562)).astype(np.float32)
    valid = rng.random((N, 10, K)) > 0.3
    s_j = JEvaluator(jsvc).score_windows(windows, valid)
    ev = OfflineEvaluator(svc)
    s_t = ev.score_windows(windows, valid)
    assert s_t.shape == (N,)
    np.testing.assert_allclose(s_t, s_j, atol=TOL)
    labels = np.asarray([1, 0, 1, 0, 1, 0.0])
    assert ev.sweep_thresholds(s_t, labels) == \
        JEvaluator(jsvc).sweep_thresholds(s_t, labels)


def test_whole_slice_through_the_scene_sensor(ctrl_pair):
    """process_frame end to end: full-width YOLOv4 at input 64 (the
    weights of test_torch_perception, whose detection scores are
    separated by more than the score tolerance, re-checked here), NMS,
    RoIAlign, tokens, the controller and the business rules."""
    size = 64
    var = yolo_variables(1, head_gain=8.0, obj_bias=-2.0)
    frames = np.random.default_rng(1).random((FRAMES, size, size, 3),
                                             np.float32)
    jscene = JScene(input_size=size)
    scores = np.asarray(jax.jit(jscene._forward)(var, jnp.asarray(frames))[1])
    for s in scores[..., 0]:
        top = np.sort(s)[::-1]
        top = top[top >= 0.25 - TOL]
        assert len(top) > 2
        assert np.min(-np.diff(top)) > TOL and np.min(np.abs(top - 0.25)) > TOL
    scene = convert.scene_from_flax(var, input_size=size, device="cpu")
    scfg = dict(trigger_threshold=0.0, wakeup_cooldown_s=0.0,
                near_field_frac=0.0)
    jsvc, svc = _services(ctrl_pair, scfg, jscene, var, scene)
    ds = _run_and_compare(jsvc, svc, frames, ServiceConfig().top_k)
    assert all(d["triggered"] for d in ds[9:])
    assert all(0.0 < d["target_obj_score"] for d in ds[9:])
