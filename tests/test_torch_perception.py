"""Port parity of the HRI scene sensor (``hri/perception/{backbones,yolo,
roi_align,scene}.py``, ``hri/utils.get_bbox_pos_emb``).

YOLOv4 is built at its full, fixed widths (69.7 M values with the
BatchNorm statistics) from one set of flax variables drawn from a numpy
seed, with every BatchNorm scale, bias, mean and variance perturbed, and
run on 64×64 images. The output convs are scaled (×8) and the objectness
logits shifted (−2) so that about ten candidates per image clear the 0.25
score threshold, each more than SCORE_SEP from its neighbours and from
the threshold (asserted): the end-to-end comparison then cannot turn on
last-bit differences in NMS order. Detection stages downstream of the
network are compared on identical inputs: JAX's decoded boxes, scores and
feature map fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from paddlerobotics_tpu.hri import utils as j_utils
from paddlerobotics_tpu.hri.perception import backbones as j_backbones
from paddlerobotics_tpu.hri.perception import roi_align as j_roi
from paddlerobotics_tpu.hri.perception import yolo as j_yolo
from paddlerobotics_tpu.hri.perception.scene import SceneSensor as JScene

from paddlerobotics_torch import convert
from paddlerobotics_torch.hri import utils
from paddlerobotics_torch.hri.perception import backbones, roi_align, yolo

SIZE = 64
# the network's outputs agree to ~1e-6 after ~110 convolutions in another
# summation order; tolerances leave a decade of room
NET_ATOL, NET_RTOL = 1e-5, 1e-4
SCORE_TOL = 1e-5
SCORE_SEP = 1e-5


def yolo_variables(seed: int = 0, head_gain: float = 1.0,
                   obj_bias: float = 0.0) -> dict:
    """Flax YOLOv4 (80 classes) variables, params and batch_stats, drawn
    from a numpy seed without running flax's initialiser: kernels
    N(0, 1/fan_in) (the three output convs × head_gain), BatchNorm scale
    and running variance U(0.5, 1.5), biases and running means
    0.1·N(0,1) (+ obj_bias on the objectness logit of every anchor).
    Fresh BatchNorm statistics (mean 0, var 1, scale 1, bias 0) would hide
    a wrong mapping of them."""
    shapes = jax.eval_shape(j_yolo.YOLOv4(80).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_dict(shapes).items():
        leaf = k[-1]
        if leaf == "kernel":
            v = rng.standard_normal(s.shape, np.float32) / np.sqrt(
                np.prod(s.shape[:-1]))
            if k[-3] == "YOLOHead_0" and k[-2].startswith("Conv_"):
                v = v * head_gain
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:                                   # bias, mean
            v = 0.1 * rng.standard_normal(s.shape)
            if k[-3] == "YOLOHead_0" and k[-2].startswith("Conv_"):
                v[4::85] += obj_bias
        flat[k] = v.astype(np.float32)
    return unflatten_dict(flat)


def _t(x):
    return torch.tensor(np.array(x))


@pytest.fixture(scope="module")
def det():
    var = yolo_variables(1, head_gain=8.0, obj_bias=-2.0)
    imgs = np.random.default_rng(1).random((2, SIZE, SIZE, 3), np.float32)
    jscene = JScene(input_size=SIZE)
    raw = jax.jit(lambda v, x: jscene.model.apply(v, x))(var, jnp.asarray(imgs))
    decoded = jax.jit(jscene._forward)(var, jnp.asarray(imgs))
    inst = jax.jit(jscene.get_instances_with_feats)(var, jnp.asarray(imgs))
    scene = convert.scene_from_flax(var, input_size=SIZE, device="cpu")
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(var=var, imgs=imgs, raw=np_tree(raw),
                decoded=np_tree(decoded), inst=np_tree(inst), scene=scene)


def test_yolov4_heads_and_feature_map_match_flax(det):
    (preds_j, fm_j) = det["raw"]
    with torch.no_grad():
        preds_t, fm_t = det["scene"].model(_t(det["imgs"]).permute(0, 3, 1, 2))
    assert [p.shape[1] for p in preds_t] == [8, 4, 2]
    for p_t, p_j in zip(preds_t + [fm_t], list(preds_j) + [fm_j]):
        np.testing.assert_allclose(p_t.numpy(), p_j, atol=NET_ATOL,
                                   rtol=NET_RTOL)
    assert fm_t.shape[-1] == 512


@pytest.mark.parametrize("n,stride,act", [(8, 2, "mish"), (7, 2, "leaky"),
                                          (8, 1, "mish")])
def test_conv_bn_same_padding_matches_flax(n, stride, act):
    """flax's SAME pads (0, 1) for k=3, s=2 on an even input and (1, 1) on
    an odd one; nn.Conv2d(padding=1) would shift the even case."""
    rng = np.random.default_rng(n + stride)
    x = rng.standard_normal((1, n, n, 5), np.float32)
    jm = j_backbones.ConvBN(6, 3, stride, act=act)
    var = jax.tree.map(lambda v: np.asarray(v) + 0.3 * rng.standard_normal(
        v.shape).astype(np.float32), jm.init(jax.random.key(0), x))
    var["batch_stats"] = jax.tree.map(np.abs, var["batch_stats"])
    out_j = np.asarray(jm.apply(var, x))
    tm = backbones.ConvBN(5, 6, 3, stride, act=act, device="cpu").eval()
    convert.load_flax(tm, var)
    with torch.no_grad():
        out_t = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=1e-5)


def test_decode_predictions_matches(det):
    preds_j = det["raw"][0]
    b_j, s_j = j_yolo.decode_predictions([jnp.asarray(p) for p in preds_j],
                                         j_yolo.YOLOV4_ANCHORS, 80, SIZE)
    b_t, s_t = yolo.decode_predictions([_t(p) for p in preds_j],
                                       yolo.YOLOV4_ANCHORS, 80, SIZE)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)


def test_nms_topk_keeps_the_same_indices(det):
    boxes, scores, _ = det["decoded"]
    for i in range(boxes.shape[0]):
        b, s = boxes[i], scores[i, :, 0]
        kb_j, ks_j, v_j, ki_j = j_yolo.nms_topk(
            jnp.asarray(b), jnp.asarray(s), return_indices=True)
        kb_t, ks_t, v_t, ki_t = yolo.nms_topk(_t(b), _t(s),
                                              return_indices=True)
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        assert 0 < v_t.sum() < 20
        np.testing.assert_array_equal(ki_t.numpy(), np.asarray(ki_j))
        np.testing.assert_array_equal(kb_t.numpy(), np.asarray(kb_j))
        np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    # exact ties keep the lower index first, as lax.top_k does
    b = np.tile(np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32),
                (3, 1))
    s = np.full(6, 0.5, np.float32)
    _, _, v_j, ki_j = j_yolo.nms_topk(jnp.asarray(b), jnp.asarray(s),
                                      return_indices=True)
    _, _, v_t, ki_t = yolo.nms_topk(_t(b), _t(s), return_indices=True)
    np.testing.assert_array_equal(ki_t.numpy(), np.asarray(ki_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_roi_align_matches(det):
    fm = det["decoded"][2][0]
    rng = np.random.default_rng(5)
    lo = rng.uniform(-20, 60, (16, 2))
    rois = np.concatenate([lo, lo + rng.uniform(0.5, 40, (16, 2))],
                          1).astype(np.float32)
    rois = np.concatenate([rois, det["inst"].boxes[0]])
    out_j = np.asarray(j_roi.roi_align(jnp.asarray(fm), jnp.asarray(rois),
                                       spatial_scale=fm.shape[0] / SIZE))
    out_t = roi_align.roi_align(_t(fm), _t(rois),
                                spatial_scale=fm.shape[0] / SIZE).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-6, rtol=1e-5)


def test_bbox_pos_emb_matches():
    rng = np.random.default_rng(6)
    lo = rng.uniform(0, 400, (3, 7, 2))
    box = np.concatenate([lo, lo + rng.uniform(1, 200, (3, 7, 2))],
                         -1).astype(np.float32)
    out_j = np.asarray(j_utils.get_bbox_pos_emb(jnp.asarray(box), 416, 416))
    out_t = utils.get_bbox_pos_emb(_t(box), 416, 416).numpy()
    assert out_t.shape == (3, 7, 2, 5, 5)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)


def _assert_instances(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), want.scores,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got.feats.numpy(), want.feats, atol=NET_ATOL,
                               rtol=NET_RTOL)
    np.testing.assert_allclose(got.tokens.numpy(), want.tokens,
                               atol=NET_ATOL, rtol=NET_RTOL)


def test_scene_tokens_on_identical_inputs(det):
    boxes, scores, fm = det["decoded"]
    inst = det["scene"].instances_from_predictions(_t(boxes), _t(scores),
                                                   _t(fm))
    assert inst.tokens.shape == (2, 20, 562)
    _assert_instances(inst, det["inst"])


def test_scene_sensor_end_to_end(det):
    scores = det["decoded"][1][..., 0]
    for s in scores:                    # the premise of an exact NMS match
        top = np.sort(s)[::-1]
        top = top[top >= 0.25 - SCORE_SEP]
        assert len(top) > 2
        assert np.min(-np.diff(top)) > SCORE_SEP
        assert np.min(np.abs(top - 0.25)) > SCORE_SEP
    inst = det["scene"].get_instances_with_feats(_t(det["imgs"]))
    _assert_instances(inst, det["inst"])


def test_feature_map_and_instances_match_jax(det):
    """``SceneSensor.get_feature_map`` and ``get_instances`` (JAX
    scene.py:97-103) on the converted weights."""
    jscene, imgs = JScene(input_size=SIZE), jnp.asarray(det["imgs"])
    fm_j = jax.jit(jscene.get_feature_map)(det["var"], imgs)
    boxes_j, scores_j, valid_j = jax.jit(jscene.get_instances)(det["var"],
                                                               imgs)
    fm_t = det["scene"].get_feature_map(_t(det["imgs"]))
    np.testing.assert_allclose(fm_t.numpy(), np.asarray(fm_j), atol=NET_ATOL,
                               rtol=NET_RTOL)
    boxes_t, scores_t, valid_t = det["scene"].get_instances(_t(det["imgs"]))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(boxes_t.numpy(), np.asarray(boxes_j),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j),
                               atol=SCORE_TOL)
