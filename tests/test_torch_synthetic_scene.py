"""Port parity of the synthetic greeting scenes (``hri/synthetic_scene.py``).

The numpy generator is the JAX package's draw for draw: one
``RandomState`` seed gives bit-equal windows in both packages, for every
``inputs_type``, with a distribution ``shift`` and into preallocated
``out=`` buffers. The device generator draws from a ``torch.Generator``,
which cannot reproduce ``jax.random``, so it is held as the JAX package
holds its own device generator against the numpy one
(``tests/test_hri_convergence.py``): the label rule exactly, and summary
statistics within those tests' bounds (has_act / padding means 0.03,
is_obj 0.02, mean token norm 0.5, action histogram 0.1, the fm profile's
cell ratios 0.1). The tiny config is that file's: 6 frames × 8 tokens.
"""

import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri import synthetic_scene as jss
from paddlerobotics_tpu.hri.attention_ctrl import AttnCtrlConfig as JConfig

from paddlerobotics_torch.hri import synthetic_scene as ss
from paddlerobotics_torch.hri.attention_ctrl import AttnCtrlConfig

VARIANTS = ("visual_token", "inst_crop", "instance", "without_inst_fm",
            "without_inst_cls", "without_inst_pos")
TINY = dict(num_actions=8, num_frames=6, tokens_per_frame=8, model_dim=64,
            num_decoder_blocks=2, num_heads=4, ffn_dim=128)
SHIFT = {"n_actors": (1, 3), "rate_scale": 1.5, "h0_range": (90.0, 170.0),
         "app_noise": 0.4, "app_drift": 0.3, "facing_p": 0.9,
         "clutter": (2, 4)}


def _cfgs(variant):
    return AttnCtrlConfig(inputs_type=variant, **TINY), \
        JConfig(inputs_type=variant, **TINY)


def _device_windows(n, cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: v.numpy() for k, v in ss.generate_windows_device(
        g, n, cfg, device="cpu").items()}


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_generate_windows_bit_equal(variant):
    cfg, jcfg = _cfgs(variant)
    _assert_same(ss.generate_windows(np.random.RandomState(4), 12, cfg),
                 jss.generate_windows(np.random.RandomState(4), 12, jcfg))


@pytest.mark.parametrize("variant", ["visual_token", "without_inst_cls"])
def test_generate_windows_bit_equal_with_shift_into_buffers(variant):
    """A shift of every knob, generated twice into one preallocated buffer
    set (the second call must clear the first's windows)."""
    cfg, jcfg = _cfgs(variant)
    rng, jrng = np.random.RandomState(9), np.random.RandomState(9)
    out, jout = ss.alloc_buffers(10, cfg), jss.alloc_buffers(10, jcfg)
    _assert_same(out, jout)
    for _ in range(2):
        a = ss.generate_windows(rng, 10, cfg, out=out, shift=SHIFT)
        b = jss.generate_windows(jrng, 10, jcfg, out=jout, shift=SHIFT)
        assert a is out
        _assert_same(a, b)


def test_constants_prototypes_and_pos_emb_match_jax():
    for name in ("IM", "NEAR_H", "GROW", "FAST", "BANDS", "NULL_ACT",
                 "NUM_ACTIONS_MIN", "INSTANCE_FAMILY", "FM_CELL_NOISE",
                 "DEFAULT_SHIFT", "MAX_ACTORS", "MAX_CLUTTER"):
        assert getattr(ss, name) == getattr(jss, name), name
    np.testing.assert_array_equal(ss.FM_SPATIAL, jss.FM_SPATIAL)
    for v in VARIANTS + ("bogus",):
        if v == "bogus":
            with pytest.raises(ValueError):
                ss.variant_token_keys(v)
        else:
            assert ss.variant_token_keys(v) == jss.variant_token_keys(v)
    p, jp = ss.ScenePrototypes(512), jss.ScenePrototypes(512)
    for f in ("person", "facing", "bands", "clutter"):
        np.testing.assert_array_equal(np.asarray(getattr(p, f)),
                                      np.asarray(getattr(jp, f)))
    for v in ("visual_token", "inst_crop"):
        cfg, jcfg = _cfgs(v)
        dp = ss.device_prototypes(cfg, device="cpu")
        jdp = jss.device_prototypes(jcfg)
        for k in jdp:
            np.testing.assert_array_equal(dp[k].numpy(), np.asarray(jdp[k]))
    boxes = np.sort(np.random.RandomState(2).uniform(0, 416, (7, 3, 4)), -1)
    np.testing.assert_array_equal(ss._pos_emb_np(boxes),
                                  jss._pos_emb_np(boxes))
    np.testing.assert_allclose(
        ss._pos_emb_dev(torch.as_tensor(boxes, dtype=torch.float32)).numpy(),
        np.asarray(jss._pos_emb_dev(boxes.astype(np.float32))), atol=1e-6)


def _check_labels(b, cfg, n):
    """The label rule's invariants (test_hri_convergence.py)."""
    F, K = cfg.num_frames, cfg.tokens_per_frame
    has, acts = b["has_act"], b["act_ids"]
    obj = b["is_obj"].reshape(n, F, K)
    assert ((acts > 0) == (has > 0.5)).all()
    assert (obj.sum(-1) >= 1)[has > 0.5].all()
    assert (obj.sum(-1) == 0)[has <= 0.5].all()
    assert acts.max() < ss.NUM_ACTIONS_MIN + 1
    assert 0.01 < has.mean() < 0.5
    pad = b["padding_mask"] > 0.5
    assert (b["is_obj"][~pad] == 0).all()
    np.testing.assert_array_equal(
        b["frame_ids"], np.tile(np.repeat(np.arange(1, F + 1), K), (n, 1)))


def test_device_generator_labels_follow_rule():
    cfg, _ = _cfgs("visual_token")
    b = _device_windows(64, cfg, 0)
    _check_labels(b, cfg, 64)
    tok, pad = b["visual_tokens"], b["padding_mask"]
    assert np.abs(tok[pad < 0.5]).max() == 0


def test_device_generator_label_rule_exact():
    """The labels recomputed from the windows themselves. With every actor
    facing the camera (``facing_p`` 1), a slot triggers iff it holds an
    actor (a class-0 score; clutter is one-hot elsewhere) whose box height,
    read back from its pos-emb's ymin row, is near field and grew by GROW
    over two frames; a frame triggers iff one of its slots does; its action
    is ``1 + band·2 + fast`` with fast = growth ≥ FAST. Heights within 1e-2
    px of a threshold are skipped (the read-back's rounding)."""
    cfg, _ = _cfgs("without_inst_fm")            # cls + pos, no fm
    n, F, K = 96, cfg.num_frames, cfg.tokens_per_frame
    b = {k: v.numpy() for k, v in ss.generate_windows_device(
        torch.Generator().manual_seed(11), n, cfg, shift={"facing_p": 1.0},
        device="cpu").items()}
    pos = b["inst_pos_emb"].reshape(n, F, K, 50).astype(np.float64)
    cls = b["inst_cls"].reshape(n, F, K, -1)
    obj = b["is_obj"].reshape(n, F, K)
    is_actor = cls[..., 0] != 0.0                                # (n,F,K)
    ymin = np.arcsin(np.clip(pos[..., 0], -1, 1)) / (np.pi / 2) * 208 + 208
    h = (416 - 40) - ymin
    grow = np.zeros_like(h)
    grow[:, 2:] = h[:, 2:] - h[:, :-2]
    rule = is_actor & (h >= ss.NEAR_H) & (grow >= ss.GROW)
    sure = ((np.abs(h - ss.NEAR_H) > 1e-2) & (np.abs(grow - ss.GROW) > 1e-2)
            & (np.abs(grow - ss.FAST) > 1e-2))
    assert sure.mean() > 0.99 and rule.sum() > 20
    np.testing.assert_array_equal(obj[sure], rule[sure])
    np.testing.assert_array_equal(b["has_act"], obj.max(-1))
    acts = b["act_ids"]
    one = obj.sum(-1) == 1                  # one triggering slot: its action
    slot = obj.argmax(-1)
    g = np.take_along_axis(grow, slot[..., None], -1)[..., 0]
    ok = one & np.take_along_axis(sure, slot[..., None], -1)[..., 0]
    assert ok.sum() > 10
    np.testing.assert_array_equal((acts[ok] - 1) % 2, g[ok] >= ss.FAST)
    assert ((acts[ok] - 1) // 2 < ss.BANDS).all()
    assert (acts[b["has_act"] == 0] == 0).all()


@pytest.mark.parametrize("variant", ["inst_crop", "instance",
                                     "without_inst_fm", "without_inst_cls",
                                     "without_inst_pos"])
def test_device_generator_variant_keys(variant):
    """Exactly the variant's keys, zero tokens off the padding, the label
    rule."""
    cfg, _ = _cfgs(variant)
    n = 24
    T = cfg.num_frames * cfg.tokens_per_frame
    b = _device_windows(n, cfg, 5)
    keys = ss.variant_token_keys(variant)
    assert sorted(k for k in b if k not in (
        "frame_ids", "padding_mask", "has_act", "act_ids", "is_obj")) == \
        sorted(keys)
    pad = b["padding_mask"] > 0.5
    _check_labels(b, cfg, n)
    dims = {"inst_fm": (512, 5, 5), "inst_crop_feat": (1280,),
            "inst_cls": (cfg.inst_cls_dim,), "inst_pos_emb": (50,)}
    for k in keys:
        assert b[k].shape == (n, T) + dims[k], k
        assert np.abs(b[k][~pad]).max() == 0, k
    if "inst_cls" in keys:
        assert b["inst_cls"][pad].sum(-1).min() > 0.5


def test_device_generator_matches_numpy_distribution():
    cfg, _ = _cfgs("visual_token")
    n = 512
    a = ss.generate_windows(np.random.RandomState(3), n, cfg)
    d = _device_windows(n, cfg, 3)
    for key, tol in (("has_act", 0.03), ("padding_mask", 0.03),
                     ("is_obj", 0.02)):
        assert abs(a[key].mean() - d[key].mean()) < tol, (
            key, a[key].mean(), d[key].mean())

    def tok_norm(b):
        t = b["visual_tokens"].reshape(-1, 562)
        m = b["padding_mask"].ravel() > 0.5
        return float(np.linalg.norm(t[m], axis=-1).mean())
    assert abs(tok_norm(a) - tok_norm(d)) < 0.5
    ha = np.bincount(a["act_ids"][a["has_act"] > 0.5], minlength=8)[1:7]
    hd = np.bincount(d["act_ids"][d["has_act"] > 0.5], minlength=8)[1:7]
    assert np.abs(ha / ha.sum() - hd / hd.sum()).max() < 0.1


def test_device_generator_fm_spatial_structure():
    cfg, _ = _cfgs("without_inst_cls")
    for b in (ss.generate_windows(np.random.RandomState(6), 16, cfg),
              _device_windows(16, cfg, 6)):
        fm = b["inst_fm"][b["padding_mask"] > 0.5]
        assert len(fm) > 0
        prof = np.abs(fm).mean(axis=(0, 1))
        ratio = prof / prof[2, 2]
        ref = ss.FM_SPATIAL / ss.FM_SPATIAL[2, 2]
        assert np.abs(ratio - ref).max() < 0.1, ratio
        assert float(np.linalg.norm(fm[:, :, 2, 2], axis=-1).mean()) > 1.0


def test_device_generator_shift_and_seed():
    """facing_p=0 leaves nothing to trigger; one seed repeats its windows,
    another does not; a generator on another device is refused."""
    cfg, _ = _cfgs("visual_token")
    g = torch.Generator().manual_seed(0)
    b = ss.generate_windows_device(g, 64, cfg, shift={"facing_p": 0.0},
                                   device="cpu")
    assert b["has_act"].sum() == 0 and b["is_obj"].sum() == 0
    x, y = _device_windows(8, cfg, 1), _device_windows(8, cfg, 1)
    _assert_same(x, y)
    assert not np.array_equal(x["visual_tokens"],
                              _device_windows(8, cfg, 2)["visual_tokens"])
    with pytest.raises(ValueError, match="generator"):
        ss.generate_windows_device(torch.Generator(), 2, cfg, device="meta")
