"""Port parity of the Darknet and YOLOv3 detectors
(``hri/perception/{darknet,yolo,backbones,scene}.py``, ``convert``,
``cli/export_hri_model --darknet_cfg``) against the JAX package on the same
seeded numpy inputs.

Tolerances: a cfg-built network's every layer within 1e-5 (a few
convolutions summed in another order); YOLOv3 at its full, fixed widths
(Darknet53, 75 convolutions, 80 classes) on 64×64 with perturbed
BatchNorm statistics within rtol 1e-4 and an atol of 1e-5 of each
tensor's largest magnitude: its residual sums grow the activations to
~100, and float32 sums in another order then differ by ~2e-6 of that
scale (JAX's own jitted and eager forwards differ by 7e-5); NMS and the
instances on identical decoded inputs equal, end to end where the scores
keep a margin (asserted) within the same tolerances; ``.weights`` bytes
equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from paddlerobotics_tpu.hri.perception import darknet as j_dn
from paddlerobotics_tpu.hri.perception import yolo as j_yolo
from paddlerobotics_tpu.hri.perception.scene import (DarknetSceneSensor as
                                                     JDarknetScene,
                                                     SceneSensor as JScene)

from paddlerobotics_torch import convert
from paddlerobotics_torch.cli import export_hri_model, train_attention
from paddlerobotics_torch.hri import export
from paddlerobotics_torch.hri.perception import darknet, yolo
from paddlerobotics_torch.hri.perception.scene import DarknetSceneSensor
from test_darknet_import import TINY_CFG

SIZE = 64
NET_SCALE_ATOL, NET_RTOL = 1e-5, 1e-4
LAYER_TOL = 1e-5
SCORE_SEP = 1e-5

# route groups, an odd input (25 → 13 after the stride-2 conv) so the
# stride-2 max pool pads (0, 1), a [yolo] head with 2 anchors
GROUPS_CFG = """
[net]
width=25
height=25
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=4
size=3
stride=1
pad=1
activation=mish

[route]
layers=-1,-2

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=0
filters=14
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1
anchors=10,13, 16,30
classes=2
num=2
scale_x_y=1.1
"""
CFGS = {"tiny": TINY_CFG, "groups": GROUPS_CFG}


def _t(x):
    return torch.tensor(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _tanh_initialised():
    """The first ``torch.tanh`` of a process on the CPU now and then comes
    out ~4e-5 off in some entries (seen in one run of three; every later
    call agrees with float64 to 1e-7): one large call first, so mish's
    comparisons below read the op's steady state."""
    torch.tanh(torch.linspace(-4, 4, 1 << 16))


def perturbed(shapes, seed, head=None, head_gain=1.0, obj_bias=0.0,
              n_out=85):
    """Variables of the given shapes from a numpy seed: kernels N(0,
    1/fan_in), BatchNorm scale and running variance U(0.5, 1.5), biases and
    running means 0.1·N(0,1). The output convs under scope ``head``
    (``YOLOHead_0``) are scaled by head_gain and their objectness logits
    shifted by obj_bias, so a few candidates clear the score threshold."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_dict(shapes).items():
        out = head is not None and k[-3] == head and k[-2].startswith("Conv_")
        if k[-1] == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            v = v * head_gain if out else v
        elif k[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
            if out:
                v[4::n_out] += obj_bias
        flat[k] = v.astype(np.float32)
    return unflatten_dict(flat)


def _dn_variables(cfg: str, seed: int):
    sections = j_dn.parse_cfg(cfg)
    w = int(dict(sections[0][1])["width"])
    shapes = jax.eval_shape(j_dn.DarknetNet(sections).init, jax.random.key(0),
                            jnp.zeros((1, w, w, 3)))
    return sections, w, perturbed(shapes, seed)


@pytest.mark.parametrize("name", list(CFGS))
def test_darknet_net_matches_flax(name):
    sections, w, var = _dn_variables(CFGS[name], 1)
    x = np.random.default_rng(1).random((2, w, w, 3), np.float32)
    yolo_j, outs_j = j_dn.DarknetNet(sections).apply(var, x)
    scene = convert.darknet_from_flax(var, darknet.parse_cfg(CFGS[name]),
                                      device="cpu")
    with torch.no_grad():
        yolo_t, outs_t = scene.model(_t(x).permute(0, 3, 1, 2))
    assert len(outs_t) == len(outs_j) and len(yolo_t) == len(yolo_j) == 1
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_allclose(o_t.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(o_j), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)
    assert scene.model.channels == [o.shape[-1] for o in outs_j]
    assert darknet.yolo_meta(scene.sections) == j_dn.yolo_meta(sections)


def _header_v1(blob: bytes) -> bytes:
    """The same floats behind a version 0.1.0 header (int32 ``seen``)."""
    return (np.asarray([0, 1, 0, 0], np.int32).tobytes() + blob[20:])


@pytest.mark.parametrize("name", list(CFGS))
def test_weights_blob_from_jax(name):
    """The JAX exporter's blob loads into a fresh port network (both header
    versions) with the same outputs; the port writes the same bytes; a blob
    of another size raises."""
    sections, w, var = _dn_variables(CFGS[name], 2)
    blob = j_dn.save_darknet_weights(var, sections)
    x = np.random.default_rng(2).random((1, w, w, 3), np.float32)
    y_j = np.asarray(j_dn.DarknetNet(sections).apply(var, x)[0][0])
    t_sections = darknet.parse_cfg(CFGS[name])
    for b in (blob, _header_v1(blob)):
        net = darknet.DarknetNet(t_sections, device="cpu").eval()
        assert darknet.load_darknet_weights(net, t_sections, b) is net
        with torch.no_grad():
            y_t = net(_t(x).permute(0, 3, 1, 2))[0][0]
        np.testing.assert_allclose(y_t.permute(0, 2, 3, 1).numpy(), y_j,
                                   atol=LAYER_TOL, rtol=LAYER_TOL)
        assert darknet.save_darknet_weights(net, t_sections) == blob
    n_floats = sum(getattr(net, f"conv{li}").weight.numel()
                   + getattr(net, f"conv{li}").out_channels * (4 if bn else 1)
                   for li, bn in darknet._conv_layers(t_sections))
    assert n_floats * 4 + 20 == len(blob)
    for bad in (blob[:-8], blob + b"\0" * 4):
        with pytest.raises(ValueError):
            darknet.load_darknet_weights(darknet.DarknetNet(t_sections),
                                         t_sections, bad)


@pytest.fixture(scope="module")
def v3():
    shapes = jax.eval_shape(j_yolo.YOLOv3(80).init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    var = perturbed(shapes, 4, head="YOLOHead_0", head_gain=1.0,
                    obj_bias=-2.5)
    imgs = np.random.default_rng(4).random((2, SIZE, SIZE, 3), np.float32)
    jscene = JScene(input_size=SIZE, arch="yolov3")

    def run(v, x):
        raw = jscene.model.apply(v, x)
        decoded = yolo_decode(jscene, raw)
        return raw, decoded, jscene.get_instances_with_feats(v, x)

    def yolo_decode(s, raw):
        preds, fm = raw
        b, sc = j_yolo.decode_predictions(preds, s.anchors, s.num_classes,
                                          s.input_size)
        return b, sc, fm

    out = jax.jit(run)(var, jnp.asarray(imgs))
    scene = convert.scene_from_flax(var, input_size=SIZE, arch="yolov3",
                                    device="cpu")
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    raw, decoded, inst = np_tree(out)
    return dict(imgs=imgs, raw=raw, decoded=decoded, inst=inst, scene=scene)


def test_yolov3_heads_and_feature_map_match_flax(v3):
    preds_j, fm_j = v3["raw"]
    with torch.no_grad():
        preds_t, fm_t = v3["scene"].model(_t(v3["imgs"]).permute(0, 3, 1, 2))
    assert [p.shape[1] for p in preds_t] == [8, 4, 2]
    assert fm_t.shape[-1] == 512 and v3["scene"].anchors == \
        j_yolo.YOLOV3_ANCHORS
    for p_t, p_j in zip(preds_t + [fm_t], list(preds_j) + [fm_j]):
        _close(p_t, p_j)


def _close(got, want, scale_atol=NET_SCALE_ATOL, rtol=NET_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=scale_atol * np.abs(want).max())


def _assert_instances(got, want, scale_atol=NET_SCALE_ATOL, rtol=NET_RTOL,
                      size=SIZE):
    """Instances within the tolerances above; a token's position part
    (sin of the box scaled by π/size) within the boxes' error times π/size:
    a perturbed head decodes boxes of thousands of pixels."""
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-5)
    for f in ("boxes", "feats"):
        _close(getattr(got, f), getattr(want, f), scale_atol, rtol)
    c = want.feats.shape[-1]
    _close(got.tokens[..., :c], want.tokens[..., :c], scale_atol, rtol)
    pos_atol = scale_atol * np.abs(want.boxes).max() * np.pi / size
    np.testing.assert_allclose(got.tokens[..., c:].numpy(),
                               want.tokens[..., c:], atol=pos_atol)


def _score_margin(scores, threshold=0.25):
    """The premise of an exact NMS match end to end."""
    for s in scores:
        top = np.sort(s)[::-1]
        top = top[top >= threshold - SCORE_SEP]
        assert len(top) > 2
        assert np.min(-np.diff(top)) > SCORE_SEP
        assert np.min(np.abs(top - threshold)) > SCORE_SEP


def test_yolov3_scene_sensor_instances(v3):
    boxes, scores, fm = v3["decoded"]
    inst = v3["scene"].instances_from_predictions(_t(boxes), _t(scores),
                                                  _t(fm))
    assert inst.tokens.shape == (2, 20, 562)
    _assert_instances(inst, v3["inst"])
    _score_margin(scores[..., 0])
    _assert_instances(v3["scene"].get_instances_with_feats(_t(v3["imgs"])),
                      v3["inst"])


def test_nms_topk_multiclass_equal(v3):
    boxes, scores, _ = v3["decoded"]
    for i in range(boxes.shape[0]):
        b, s = boxes[i], scores[i][:, :6]
        out_j = j_yolo.nms_topk_multiclass(jnp.asarray(b), jnp.asarray(s))
        out_t = yolo.nms_topk_multiclass(_t(b), _t(s))
        assert 0 < int(out_t[3].sum()) <= 20
        assert len(set(out_t[2][out_t[3]].tolist())) > 1
        for t, j in zip(out_t, out_j):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _jax_darknet_scene(cfg, var, input_size=None):
    """JAX's DarknetSceneSensor on ``var``, its feature-map layer picked as
    its ``init`` picks it (the deepest layer with 512 channels, else the
    last) from the layer shapes, without the eager ``init`` pass."""
    sections = j_dn.parse_cfg(cfg)
    js = JDarknetScene(sections, input_size=input_size)
    x = jnp.zeros((1, js.input_size, js.input_size, 3))
    _, outs = jax.eval_shape(js.model.apply, var, x)
    picks = [i for i, o in enumerate(outs) if o.shape[-1] == 512]
    js._fm_layer = picks[-1] if picks else len(outs) - 1
    return js


@pytest.mark.parametrize("name", list(CFGS))
def test_darknet_scene_sensor_instances(name):
    """Each head decoded with its own anchors and scale_x_y; the auto-picked
    feature-map layer; the instances on identical decoded inputs equal."""
    sections, w, var = _dn_variables(CFGS[name], 5)
    js = _jax_darknet_scene(CFGS[name], var)
    scene = convert.darknet_from_flax(var, darknet.parse_cfg(CFGS[name]),
                                      device="cpu")
    assert scene.fm_layer == js._fm_layer and scene.input_size == w
    imgs = np.random.default_rng(5).random((2, w, w, 3), np.float32)
    run = jax.jit(lambda v, x: (js._forward(v, x), js.get_instances_with_feats(
        v, x, score_threshold=0.0)))
    decoded_j, inst_j = jax.tree.map(np.asarray, run(var, jnp.asarray(imgs)))
    decoded_t = scene._forward(_t(imgs))
    for t, j in zip(decoded_t, decoded_j):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=1e-5)
    inst_t = scene.instances_from_predictions(
        *[_t(x) for x in decoded_j], score_threshold=0.0)
    assert inst_t.tokens.shape[-1] == scene.model.channels[
        scene.fm_layer] + 50
    _assert_instances(inst_t, inst_j, 1e-6, 1e-5, w)


def test_export_hri_model_darknet_cfg_through_load_bundle(tmp_path):
    """checkpoint → ``export_hri_model --darknet_cfg --darknet_weights`` →
    ``load_bundle``: a Darknet sensor at 416² carrying the blob's weights,
    the files named in the manifest, detections as JAX's sensor gives them
    from the same blob."""
    out, bundle = str(tmp_path / "run"), str(tmp_path / "bundle")
    widths = ["--num_actions", "7", "--model_dim", "16",
              "--num_decoder_blocks", "1", "--num_heads", "2", "--ffn_dim",
              "32"]
    train_attention.main(widths + ["--batch_size", "2", "--device", "cpu",
                                   "--synthetic", "2", "--epochs", "1",
                                   "--outdir", out])
    sections, _, var = _dn_variables(TINY_CFG, 6)
    blob_path = tmp_path / "tiny.weights"
    blob_path.write_bytes(j_dn.save_darknet_weights(var, sections))
    cfg_path = tmp_path / "tiny.cfg"
    cfg_path.write_text(TINY_CFG)
    export_hri_model.main(widths + [
        "--ckpt", out + "/itr_2.pt", "--out", bundle, "--darknet_cfg",
        str(cfg_path), "--darknet_weights", str(blob_path)])
    b = export.load_bundle(bundle, device="cpu")
    assert isinstance(b.scene, DarknetSceneSensor)
    with open(f"{bundle}/manifest.json") as f:
        scene_m = json.load(f)["scene"]
    assert scene_m["meta"] == {"cfg": str(cfg_path),
                               "weights": str(blob_path)}
    assert b.scene.input_size == 416 and scene_m["arch"] == "darknet"
    js = _jax_darknet_scene(TINY_CFG, var, 416)
    params = j_dn.load_darknet_weights(jax.tree.map(np.zeros_like, var),
                                       sections, blob_path.read_bytes())
    img = np.random.default_rng(6).random((1, 416, 416, 3), np.float32)
    decoded_j = jax.tree.map(np.asarray, jax.jit(js._forward)(
        params, jnp.asarray(img)))
    for t, j in zip(b.scene._forward(_t(img)), decoded_j):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=1e-5)
