"""Port parity of the HRI attention controller's training path
(``hri/attention_ctrl`` inputs and loss, ``hri/train_attention``,
``train/checkpoints``' HRI state, ``cli/train_attention``,
``cli/parallel_train_attn``, ``hri/export`` and ``cli/export_hri_model``).

The flax controller is initialised at D=32, 2 blocks, 2 heads, ffn 64,
F=3 frames × K=4 tokens, 9 actions, the instance path narrowed to an 8-wide
1×1 conv and a 16-wide flatten (``SMALL``); every leaf is then perturbed by
0.1·N(0,1) from a numpy seed and carried across by ``convert``.

Tolerances:
- forward of every ``inputs_type``: atol / rtol 1e-4 (float32 sums in
  another order, two blocks deep);
- ``controller_loss`` and its aux: rtol 1e-6;
- train steps from ``convert.attn_train_from_flax`` against JAX's
  ``train_step`` on the same ``synthetic_batch`` (lr 1e-4, l2 0.1, the
  CLI's): losses rtol 1e-4; Adam moments within 1e-4 (one step) and 5e-3
  (three steps) of each leaf's largest |moment|, step counts equal;
  weights: at most 1e-3 of a leaf's entries more than 1e-6 apart, none
  more than 2·lr per step taken. Adam's first steps move a weight by
  ±lr·g/|g|, so an entry whose decayed gradient is ~0 (1e-5 of the
  gradients' 1e-5 relative difference) may step the other way in one
  package;
- ``eval_step`` metrics: equal;
- ``synthetic_batch``: bit-equal;
- checkpoint round trips and bundle round trips: equal (0.0).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri import export as j_export
from paddlerobotics_tpu.hri.attention_ctrl import (AttentionController as
                                                   JController,
                                                   AttnCtrlConfig as JConfig,
                                                   controller_loss as j_loss)
from paddlerobotics_tpu.hri.train_attention import (AttentionTrainer as
                                                    JTrainer,
                                                    synthetic_batch as j_batch)

from paddlerobotics_torch import convert
from paddlerobotics_torch.cli import (export_hri_model, parallel_train_attn,
                                      train_attention)
from paddlerobotics_torch.hri import export, synthetic_scene as ss
from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                     AttnCtrlConfig,
                                                     controller_loss)
from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                              ServiceConfig)
from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                      synthetic_batch,
                                                      to_device)
from paddlerobotics_torch.ops import attention
from paddlerobotics_torch.train import checkpoints
from torch_parity import _flax_leaf
from test_torch_serving import StubScene

VARIANTS = ("visual_token", "inst_crop", "instance", "without_inst_fm",
            "without_inst_cls", "without_inst_pos")
SMALL = dict(num_actions=9, num_frames=3, tokens_per_frame=4, model_dim=32,
             num_decoder_blocks=2, num_heads=2, ffn_dim=64, act_tr_dim=12,
             inst_fm_reduce_dim=8, inst_fm_flatten_dim=16)
ATOL = RTOL = 1e-4
LR, L2 = 1e-4, 0.1
OUTPUTS = ("trigger_logits", "obj_logits", "act_logits", "hid", "frame_hid",
           "present_kv_arr")
# the CLIs' widths in these tests
WIDTHS = ["--num_actions", "7", "--model_dim", "16", "--num_decoder_blocks",
          "1", "--num_heads", "2", "--ffn_dim", "32"]
CLI_W = WIDTHS + ["--batch_size", "2", "--device", "cpu"]
CLI_SMALL = CLI_W + ["--num_frames", "3", "--tokens_per_frame", "4"]


def _perturbed_state(variant, seed=0):
    """A JAX trainer (lr 1e-4, l2 0.1) and its state with every param
    perturbed by 0.1·N(0,1)."""
    jcfg = JConfig(inputs_type=variant, **SMALL)
    jt = JTrainer(jcfg, lr=LR, weight_decay=L2)
    st = jt.init(jax.random.key(seed))
    rng = np.random.default_rng(100 + seed)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(
        x.shape).astype(np.float32), st.params)
    return jt, st._replace(params=params, opt_state=jt.tx.init(params))


def _all_tokens(B, T, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, np.float32)
    return {"visual_tokens": f(B, T, 562), "inst_fm": f(B, T, 512, 5, 5),
            "inst_cls": f(B, T, 80), "inst_pos_emb": f(B, T, 50),
            "inst_crop_feat": f(B, T, 1280)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_controller_inputs_match_flax(variant):
    """Each variant against flax on converted weights. The port gets every
    token key and must read only its variant's (the concat order
    ``[fm, crop, cls, pos]``); flax gets only the variant's. The 1×1 conv's
    kernel is not symmetric, so a flatten in c-h-w order would show."""
    jt, st = _perturbed_state(variant)
    cfg = AttnCtrlConfig(inputs_type=variant, **SMALL)
    B, T = 2, 12
    toks = _all_tokens(B, T)
    fids = np.repeat(np.arange(1, 4), 4)[None].repeat(B, 0)
    pad = np.ones((B, T), np.float32)
    pad[0, 2] = pad[1, 9] = 0.0
    out_j = jt.model.apply(st.params, jt._tokens(toks), jnp.asarray(fids),
                           jnp.asarray(pad))
    ctrl = convert.ctrl_from_flax(st.params, cfg, device="cpu")
    assert set(ctrl.token_keys) == set(jt._variant_keys())
    with torch.no_grad():
        out_t = ctrl({k: torch.as_tensor(v) for k, v in toks.items()},
                     torch.as_tensor(fids), torch.as_tensor(pad))
    for k in OUTPUTS:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    missing = {k: torch.as_tensor(v) for k, v in toks.items()
               if k != ctrl.token_keys[0]}
    with pytest.raises(KeyError, match=ctrl.token_keys[0]):
        ctrl(missing, torch.as_tensor(fids), torch.as_tensor(pad))


@pytest.mark.parametrize("use_last", [False, True], ids=["all_frames",
                                                         "last_frame"])
def test_controller_loss_matches_jax(use_last):
    """Every term on the same outputs; obj_loss averages over all tokens,
    padding included."""
    cfg = AttnCtrlConfig(**SMALL, use_last_act_loss=use_last)
    jcfg = JConfig(**SMALL, use_last_act_loss=use_last)
    rng = np.random.default_rng(4)
    B, F, T, A = 3, 3, 12, 9
    outs = {"trigger_logits": 3 * rng.standard_normal((B, F), np.float32),
            "obj_logits": 3 * rng.standard_normal((B, T), np.float32),
            "act_logits": 2 * rng.standard_normal((B, F, A), np.float32)}
    has = (rng.random((B, F)) > 0.5).astype(np.float32)
    obj = (rng.random((B, T)) > 0.7).astype(np.float32)
    acts = rng.integers(0, A, (B, F))
    pad = (rng.random((B, T)) > 0.3).astype(np.float32)
    tot_j, aux_j = j_loss(jcfg, {k: jnp.asarray(v) for k, v in outs.items()},
                          jnp.asarray(has), jnp.asarray(obj),
                          jnp.asarray(acts), jnp.asarray(pad))
    tot_t, aux_t = controller_loss(
        cfg, {k: torch.as_tensor(v) for k, v in outs.items()},
        torch.as_tensor(has), torch.as_tensor(obj), torch.as_tensor(acts),
        torch.as_tensor(pad))
    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-6)
    # not divided by the mask's sum
    ce = (np.maximum(outs["obj_logits"], 0) - outs["obj_logits"] * obj
          + np.log1p(np.exp(-np.abs(outs["obj_logits"]))))
    np.testing.assert_allclose(float(aux_t["obj_loss"]), (ce * pad).mean(),
                               rtol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_synthetic_batch_bit_equal(variant):
    cfg = AttnCtrlConfig(inputs_type=variant, **SMALL)
    ours = synthetic_batch(cfg, np.random.RandomState(3), 2, device="cpu")
    theirs = j_batch(JConfig(inputs_type=variant, **SMALL),
                     np.random.RandomState(3), 2)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)


def _assert_state_matches(ts, st, steps):
    adam = st.opt_state[1][0]
    mom_tol = 1e-4 if steps == 1 else 5e-3
    for prm, path, transposed in convert.flax_leaves(ts.model):
        p = prm.detach().numpy()
        d = np.abs((p.T if transposed else p) - _flax_leaf(st.params, path))
        assert (d > 1e-6).mean() <= 1e-3, (path, (d > 1e-6).mean())
        assert d.max() <= 2 * LR * steps * 1.001, (path, d.max())
        s = ts.opt.state[prm]
        assert float(s["step"]) == int(adam.count) == steps
        for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            t = s[ours].numpy()
            j = _flax_leaf(theirs, path)
            np.testing.assert_allclose(t.T if transposed else t, j,
                                       atol=mom_tol * np.abs(j).max(),
                                       err_msg=f"{ours} {path}")
    assert ts.step == int(st.step) == steps


@pytest.mark.parametrize("variant", ["visual_token", "instance",
                                     "inst_crop"])
def test_train_steps_match_jax(variant):
    """One and three steps from the converted JAX state on the same
    synthetic batches: losses, weights, Adam moments and step counts."""
    jt, st = _perturbed_state(variant, seed=1)
    cfg = AttnCtrlConfig(inputs_type=variant, **SMALL)
    ts = convert.attn_train_from_flax(jax.tree.map(np.asarray, st), cfg,
                                      lr=LR, weight_decay=L2, device="cpu")
    tr = AttentionTrainer(cfg, lr=LR, weight_decay=L2, device="cpu")
    rng_j, rng_t = np.random.RandomState(0), np.random.RandomState(0)
    for step in (1, 2, 3):
        st, aux_j = jt.train_step(st, j_batch(jt.cfg, rng_j, 4))
        aux_t = tr.train_step(ts, synthetic_batch(cfg, rng_t, 4, "cpu"))
        assert sorted(aux_t) == sorted(aux_j)
        for k in aux_j:
            np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                       rtol=1e-4, err_msg=f"{k} {step}")
        if step != 2:
            _assert_state_matches(ts, st, step)


def test_eval_step_matches_jax():
    """Accuracies through the kernel's dispatch (its plain version on the
    CPU) equal JAX's eval_step on scene windows with learnable labels."""
    jt, st = _perturbed_state("visual_token", seed=2)
    cfg = AttnCtrlConfig(**SMALL)
    ts = convert.attn_train_from_flax(jax.tree.map(np.asarray, st), cfg,
                                      device="cpu")
    tr = AttentionTrainer(cfg, device="cpu")
    win = ss.generate_windows(np.random.RandomState(5), 64, cfg)
    win["has_act"][:, -1] = np.random.RandomState(6).rand(64) > 0.5
    m_j = jt.eval_step(st, {k: jnp.asarray(v) for k, v in win.items()})
    launches = attention.flash_attention.launches
    m_t = tr.eval_step(ts, to_device(win, "cpu"))
    assert attention.flash_attention.launches == launches
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        assert float(m_t[k]) == pytest.approx(float(m_j[k]), abs=1e-7), k
    assert 0.0 < float(m_t["trigger_acc"]) < 1.0


def test_trainer_tokens_dummy_and_refusals():
    for variant in VARIANTS:
        cfg = AttnCtrlConfig(inputs_type=variant, **SMALL)
        tr = AttentionTrainer(cfg, device="cpu")
        jt = JTrainer(JConfig(inputs_type=variant, **SMALL))
        assert tr._variant_keys() == jt._variant_keys()
        dummy, jdummy = tr.dummy_tokens(2), jt.dummy_tokens(2)
        assert {k: tuple(v.shape) for k, v in dummy.items()} == \
            {k: tuple(v.shape) for k, v in jdummy.items()}
        with pytest.raises(KeyError, match="token keys"):
            tr._tokens({"frame_ids": None})
    # a mesh of ranks on another device type is refused; without a mesh a
    # batch is not cut (the mesh itself runs on gloo ranks in
    # tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="a mesh of cuda ranks"):
        AttentionTrainer(AttnCtrlConfig(), device="cpu",
                         mesh=types.SimpleNamespace(device_type="cuda"))
    batch = {"frame_ids": torch.zeros(2, 3)}
    assert tr.shard_batch(batch) is batch
    with pytest.raises(ValueError, match="inputs_type"):
        AttentionController(AttnCtrlConfig(inputs_type="bogus"),
                            device="cpu")


def _auc(scores, labels):
    o = np.argsort(scores)
    r = np.empty(len(scores), float)
    r[o] = np.arange(len(scores))
    npos, nneg = labels.sum(), (1 - labels).sum()
    return float((r[labels > 0.5].sum() - npos * (npos - 1) / 2)
                 / (npos * nneg))


def test_trigger_auc_converges():
    """The port's copy of test_hri_convergence.py::test_trigger_auc_converges:
    the tiny controller (D=64, 2 blocks, 4 heads, F=6 × K=8) reaches trigger
    AUC > 0.85 on 256 held-out windows of the numpy generator after 200
    steps of 64 windows. It trains on the device generator's windows (on
    the CPU here), so the AUC also holds the two generators'
    distributions against each other. One intra-op thread: the suite's
    workers share the cores, and 200 steps of spinning thread pools slow
    every worker by an order of magnitude."""
    cfg = AttnCtrlConfig(num_actions=8, num_frames=6, tokens_per_frame=8,
                         model_dim=64, num_decoder_blocks=2, num_heads=4,
                         ffn_dim=128)
    tr = AttentionTrainer(cfg, lr=3e-4, weight_decay=0.01, device="cpu")
    state = tr.init(torch.Generator().manual_seed(0))
    ev = to_device(ss.generate_windows(np.random.RandomState(0), 256, cfg),
                   "cpu")
    lab = ev["has_act"].numpy().ravel()
    gen = torch.Generator().manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(200):
            tr.train_step(state, ss.generate_windows_device(gen, 64, cfg,
                                                            device="cpu"))
        with torch.no_grad():
            logits = state.model(tr._tokens(ev), ev["frame_ids"],
                                 ev["padding_mask"],
                                 use_kernel=True)["trigger_logits"]
    finally:
        torch.set_num_threads(threads)
    auc = _auc(torch.sigmoid(logits).numpy().ravel(), lab)
    assert auc > 0.85, f"trigger AUC {auc:.3f}: controller not learning"
    assert state.step == 200


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """2 steps, save, restore into a trainer of other initial weights, 2
    more steps: weights, Adam state and step equal to 4 uninterrupted
    steps."""
    cfg = AttnCtrlConfig(inputs_type="without_inst_fm", **SMALL)
    tr = AttentionTrainer(cfg, lr=1e-3, device="cpu")
    batches = [synthetic_batch(cfg, np.random.RandomState(i), 2, "cpu")
               for i in range(4)]
    a = tr.init(torch.Generator().manual_seed(0))
    for b in batches[:2]:
        tr.train_step(a, b)
    path = checkpoints.save_attn(str(tmp_path), a)
    assert path.endswith("itr_2.pt") and checkpoints.latest_step(
        str(tmp_path)) == 2
    b_state = tr.init(torch.Generator().manual_seed(1))
    restored = checkpoints.restore(str(tmp_path / "itr_2"))
    checkpoints.load_attn_state(b_state, restored["attn"])
    assert restored["ctrl_cfg"]["inputs_type"] == "without_inst_fm"
    for b in batches[2:]:
        tr.train_step(a, b)
        tr.train_step(b_state, b)
    assert a.step == b_state.step == 4
    for (n, p), q in zip(a.model.named_parameters(), b_state.model.parameters()):
        assert torch.equal(p, q), n
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.opt.state[p][k], b_state.opt.state[q][k])


def _read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_trains_and_resumes(tmp_path):
    out = str(tmp_path / "run")
    state = train_attention.main(CLI_SMALL + [
        "--synthetic", "2", "--epochs", "2", "--outdir", out,
        "--use_pallas_attention", "1"])
    assert state.step == 4
    ck = checkpoints.restore(out + "/itr_4.pt")
    assert ck["step"] == 4 and ck["ctrl_cfg"]["use_pallas_attention"] is True
    assert checkpoints.latest_step(out) == 4
    resumed = train_attention.main(CLI_SMALL + [
        "--synthetic", "2", "--epochs", "1", "--outdir", out,
        "--init_params", out + "/itr_4.pt"])
    assert resumed.step == 6 and checkpoints.latest_step(out) == 6
    for p in resumed.model.parameters():
        assert float(resumed.opt.state[p]["step"]) == 6
    steps = [r["step"] for r in _read_metrics(out + "/metrics.jsonl")
             if r["tag"] == "train/loss"]
    assert steps == [1, 2, 3, 4, 5, 6]
    with pytest.raises(SystemExit, match="distributed"):
        train_attention.main(CLI_SMALL + ["--distributed", "1"])


def test_train_cli_instance_variant_on_npz_windows(tmp_path):
    """The instance variant on a directory of window files that carry
    every token key (5 files at batch 2: two batches, the last file
    dropped)."""
    cfg = AttnCtrlConfig(inputs_type="instance", **SMALL)
    win = ss.generate_windows(np.random.RandomState(0), 5, cfg)
    extra = ss.generate_windows(np.random.RandomState(1), 5, AttnCtrlConfig(
        inputs_type="inst_crop", **SMALL))
    data = tmp_path / "windows"
    data.mkdir()
    for i in range(5):
        np.savez(data / f"w{i:03d}.npz", **{k: v[i] for k, v in win.items()},
                 inst_crop_feat=extra["inst_crop_feat"][i])
    state = train_attention.main(CLI_SMALL + [
        "--inputs_type", "instance", "--data_dir", str(data), "--epochs",
        "1", "--outdir", str(tmp_path / "run")])
    assert state.step == 2
    assert state.model.token_keys == ("inst_fm", "inst_cls", "inst_pos_emb")
    assert checkpoints.latest_step(str(tmp_path / "run")) == 2


def test_fleet_cli_all_variants(tmp_path):
    """The five ablation variants in one process, one checkpoint each; the
    first variant's type trains on the shared batch."""
    out = tmp_path / "fleet"
    fleet = parallel_train_attn.main(CLI_SMALL + [
        "--variants", ",".join(parallel_train_attn.VARIANTS),
        "--synthetic", "1", "--epochs", "1", "--outdir", str(out)])
    assert list(fleet) == list(parallel_train_attn.VARIANTS)
    for name, v in fleet.items():
        assert v["state"].step == 1
        ck = checkpoints.restore(str(out / name / "itr_1.pt"))
        assert ck["ctrl_cfg"]["inputs_type"] == name
        assert len(_read_metrics(out / name / "metrics.jsonl")) == 1
    # the first variant's step equals a lone run on the same first batch
    tr = AttentionTrainer(fleet["visual_token"]["state"].model.cfg,
                          device="cpu")
    lone = tr.init(torch.Generator().manual_seed(0))
    tr.train_step(lone, synthetic_batch(lone.model.cfg,
                                        np.random.RandomState(0), 2, "cpu"))
    for p, q in zip(lone.model.parameters(),
                    fleet["visual_token"]["state"].model.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(SystemExit, match="unknown variant"):
        parallel_train_attn.main(CLI_SMALL + ["--variants", "inst_crop"])


def test_export_bundle_serves_like_the_trained_module(tmp_path):
    """train → itr_<step>.pt → export → load_bundle → service: the bundle's
    controller is 0.0 apart from the trained module, and a service built
    on it decides the same frames as one on the trained module."""
    out, bundle = str(tmp_path / "run"), str(tmp_path / "bundle")
    state = train_attention.main(CLI_W + ["--synthetic", "2", "--epochs",
                                          "1", "--outdir", out])
    wae = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(tmp_path / "wae.npy", wae)
    export_hri_model.main(WIDTHS + ["--ckpt", out + "/itr_2.pt", "--out", bundle,
                             "--wae", str(tmp_path / "wae.npy"),
                             "--trigger_threshold", "0.6"])
    b = export.load_bundle(bundle, device="cpu")
    assert b.manifest["format"] == "paddlerobotics_torch.hri.bundle.v1"
    assert b.manifest["extra"] == {"trigger_threshold": 0.6}
    assert b.ctrl_cfg == state.model.cfg and b.scene is None
    np.testing.assert_array_equal(b.wae, wae)
    for (n, p), q in zip(state.model.state_dict().items(),
                         b.ctrl.state_dict().values()):
        assert torch.equal(p, q), n
    rng = np.random.default_rng(0)
    frames = rng.random((12, 80, 80, 3), dtype=np.float32)
    scfg = ServiceConfig(trigger_threshold=b.manifest["extra"][
        "trigger_threshold"], wakeup_cooldown_s=0.0, near_field_frac=0.0)
    decisions = []
    for ctrl in (state.model, b.ctrl):
        svc = ProactiveGreetingService(
            scfg, StubScene(), ctrl, generator=torch.Generator().manual_seed(1),
            device="cpu")
        decisions.append([svc.process_frame(f) for f in frames])
    assert decisions[0] == decisions[1]
    assert sum("trigger_score" in d for d in decisions[0]) == 3
    # --darknet_cfg adds a cfg-built scene sensor (test_torch_darknet.py
    # holds its detections against JAX's); a cfg that is not there raises
    with pytest.raises(FileNotFoundError):
        export_hri_model.main(WIDTHS + [
            "--ckpt", out + "/itr_2.pt", "--out", bundle, "--darknet_cfg",
            str(tmp_path / "no.cfg")])


def test_bundle_keeps_the_scene_sensor(tmp_path):
    from paddlerobotics_torch.hri.perception.scene import SceneSensor

    cfg = AttnCtrlConfig(**SMALL)
    ctrl = AttentionController(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    scene = SceneSensor(num_classes=2, input_size=32, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    export.save_bundle(str(tmp_path), cfg, ctrl.state_dict(), scene=scene)
    b = export.load_bundle(str(tmp_path), device="cpu")
    assert b.manifest["scene"] == {"num_classes": 2, "input_size": 32,
                                   "arch": "yolov4"}
    assert b.wae is None
    for (n, p), q in zip(scene.model.state_dict().items(),
                         b.scene.model.state_dict().values()):
        assert torch.equal(p, q), n
    img = torch.as_tensor(np.random.default_rng(0).random(
        (1, 32, 32, 3), dtype=np.float32))
    np.testing.assert_array_equal(
        scene.get_instances_with_feats(img).tokens.numpy(),
        b.scene.get_instances_with_feats(img).tokens.numpy())


def test_jax_bundle_through_convert(tmp_path):
    """A JAX bundle (flax msgpack, read with flax here) carried across by
    ``convert.ctrl_from_flax`` gives the JAX controller's outputs; the
    port's ``load_bundle`` refuses it by its format."""
    jt, st = _perturbed_state("visual_token", seed=3)
    j_export.save_bundle(str(tmp_path), jt.cfg, st.params,
                         extra={"trigger_threshold": 0.7})
    manifest, jcfg, params, _, _ = j_export.load_bundle(str(tmp_path),
                                                        st.params)
    cfg = AttnCtrlConfig(**manifest["ctrl_cfg"])
    ctrl = convert.ctrl_from_flax(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    toks = _all_tokens(2, 12, seed=1)["visual_tokens"]
    fids = np.repeat(np.arange(1, 4), 4)[None].repeat(2, 0)
    pad = np.ones((2, 12), np.float32)
    out_j = JController(jcfg).apply(params, {"visual_tokens": toks},
                                    jnp.asarray(fids), jnp.asarray(pad))
    with torch.no_grad():
        out_t = ctrl({"visual_tokens": torch.as_tensor(toks)},
                     torch.as_tensor(fids), torch.as_tensor(pad))
    for k in OUTPUTS:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    with pytest.raises(ValueError, match="format"):
        export.load_bundle(str(tmp_path), device="cpu")
