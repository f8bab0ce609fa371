"""Port parity: the HRI data tools (``hri/actions``' controllers and
embedding table, ``hri/perception/utterance``, ``hri/data``,
``hri/augment``, ``hri/avatar``, ``cli/collect_act_emb``,
``cli/prepare_dataset``) against the JAX package's on the same seeded
inputs.

Tolerances: the encoders and controllers on converted flax weights within
1e-5 (float32 sums in another order; the attention kernel's plain version
scales after the q·k product, flax before); ``read_video_frames`` within
1e-6 (the port's bilinear letterbox against ``cv2.resize``); every numpy
path (tokenizer ids, tables, splits, windows, augmentation, avatar frames,
the CLIs' outputs) bit-equal.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.cli import collect_act_emb as j_collect
from paddlerobotics_tpu.cli import prepare_dataset as j_prepare
from paddlerobotics_tpu.hri import actions as j_actions
from paddlerobotics_tpu.hri import augment as j_augment
from paddlerobotics_tpu.hri import data as j_data
from paddlerobotics_tpu.hri.perception import utterance as ju

from paddlerobotics_torch import convert
from paddlerobotics_torch.cli import collect_act_emb, prepare_dataset
from paddlerobotics_torch.hri import actions, augment, data
from paddlerobotics_torch.hri.perception import utterance as tu

from torch_parity import one_thread  # noqa: F401

TOL = 1e-5

VOCAB = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "hello": 4,
         "world": 5, "hel": 6, "##lo": 7, "##wor": 8, "##ld": 9, "你": 10,
         "好": 11, "un": 12, "##aff": 13, "##able": 14, "robot": 15}
TEXTS = ["Hello world", "helloworld unaffable", "你好 robot!", "",
         "x" * 120, "hel  lo\tworld 你 好吗", "ROBOT robot robot " * 30]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_tokenizer_ids_equal_jax():
    jt, tt = ju.WordPieceTokenizer(VOCAB), tu.WordPieceTokenizer(VOCAB)
    for text in TEXTS:
        for max_len in (8, 64):
            np.testing.assert_array_equal(tt.encode(text, max_len),
                                          jt.encode(text, max_len))
        assert tt.tokenize_word(text) == jt.tokenize_word(text)


def _ernie_cfgs(act):
    kw = dict(vocab_size=120, hidden_size=64, num_layers=2, num_heads=4,
              ffn_size=128, max_len=48, hidden_act=act)
    return ju.ErnieConfig(**kw), tu.ErnieConfig(**kw)


def _ids():
    ids = np.random.RandomState(0).randint(4, 120, (3, 16))
    ids[0, 10:] = 0                    # padded rows: most keys masked
    ids[1, 3:] = 0
    return ids


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_ernie_on_converted_weights(act):
    jc, tc = _ernie_cfgs(act)
    ids = _ids()
    variables = ju.ErnieEncoder(jc).init(jax.random.key(1), jnp.asarray(ids))
    seq_j, pool_j = ju.ErnieEncoder(jc).apply(variables, jnp.asarray(ids))
    model = convert.ernie_from_flax(_np(variables), tc, device="cpu")
    with torch.no_grad():
        seq_t, pool_t = model(torch.as_tensor(ids))
        seq_m, pool_m = model(torch.as_tensor(ids), use_kernel=False)
    np.testing.assert_allclose(seq_t.numpy(), np.asarray(seq_j), atol=TOL)
    np.testing.assert_allclose(pool_t.numpy(), np.asarray(pool_j), atol=TOL)
    # CPU tensors take the kernel's plain version: the same arithmetic
    np.testing.assert_array_equal(seq_t.numpy(), seq_m.numpy())


def test_bow_on_converted_weights():
    ids = _ids()
    enc = ju.BoWEncoder(vocab_size=120, dim=32)
    params = enc.init(jax.random.key(2), jnp.asarray(ids))
    model = convert.bow_from_flax(_np(params), device="cpu")
    with torch.no_grad():
        out = model(torch.as_tensor(ids))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(enc.apply(params, jnp.asarray(ids))),
                               atol=TOL)


def test_paddle_codec_round_trip(tmp_path):
    """flax → JAX export (paddle names) → JAX-encoded files → the port's
    loader and import → forward equal; the port's export encodes the same
    bytes as JAX's."""
    jc, tc = _ernie_cfgs("relu")
    ids = _ids()
    variables = ju.ErnieEncoder(jc).init(jax.random.key(3), jnp.asarray(ids))
    named = ju.export_ernie_params(variables, jc)
    for name, arr in named.items():
        (tmp_path / name).write_bytes(ju._encode_paddle_var(arr))
    loaded = tu.load_paddle_params_dir(str(tmp_path))
    assert set(loaded) == set(named)
    model = tu.import_ernie_params(loaded, tc, device="cpu")
    with torch.no_grad():
        seq_t, pool_t = model(torch.as_tensor(ids))
    seq_j, pool_j = ju.ErnieEncoder(jc).apply(variables, jnp.asarray(ids))
    np.testing.assert_allclose(seq_t.numpy(), np.asarray(seq_j), atol=TOL)
    np.testing.assert_allclose(pool_t.numpy(), np.asarray(pool_j), atol=TOL)
    back = tu.export_ernie_params(model)
    assert set(back) == set(named)
    for name, arr in named.items():
        assert tu._encode_paddle_var(back[name]) == ju._encode_paddle_var(arr)
        np.testing.assert_array_equal(
            tu.parse_paddle_var(ju._encode_paddle_var(arr)), arr)
    with pytest.raises(KeyError, match="missing param"):
        tu.import_ernie_params({}, tc, device="cpu")


def _catalog():
    r = np.random.RandomState(4)
    acts, exps = list(j_actions.ACTION_TO_ID), list(j_actions.EXPRESSION_TO_ID)
    return [(acts[r.randint(len(acts))], exps[r.randint(len(exps))],
             " ".join(["hi"] * r.randint(1, 4)), "null") for _ in range(6)]


def test_action_maps_and_embeddings_bit_equal():
    rows = _catalog()
    utt = np.random.RandomState(5).randn(len(rows), 768).astype(np.float32)
    for version in ("v1", "v2"):
        if version == "v2":
            rows = [("wave", "shy", "hi", "null")] * 3
            utt = utt[:3]
        ja = [j_actions.MultimodalAction(*r) for r in rows]
        ta = [actions.MultimodalAction(*r) for r in rows]
        np.testing.assert_array_equal(
            actions.build_action_embeddings(ta, utt, version),
            j_actions.build_action_embeddings(ja, utt, version))
        for i in range(actions.action_set_size(version)):
            assert actions.id_to_action(i, version) == \
                j_actions.id_to_action(i, version)
        for i in range(actions.expression_set_size(version)):
            assert actions.id_to_expression(i, version) == \
                j_actions.id_to_expression(i, version)
    assert actions.movement_set_size() == j_actions.movement_set_size()
    for m in actions.MOVEMENT_TO_ID:
        assert actions.id_to_movement(actions.movement_to_id(m)) == m
    assert actions.SALUTATIONS == j_actions.SALUTATIONS


def test_discrete_controller_and_salutation_tree():
    r = np.random.RandomState(6)
    feat = r.randn(3, 40).astype(np.float32)
    jm = j_actions.DiscreteController(num_outputs=7, hidden_dims=(32, 16))
    p = jm.init(jax.random.key(4), feat)
    tm = convert.discrete_ctrl_from_flax(_np(p), device="cpu")
    with torch.no_grad():
        out = tm(torch.as_tensor(feat))
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(p, feat)),
                               atol=TOL)
    fm = r.randn(2, 3, 5, 5, 24).astype(np.float32)        # (...,5,5,C)
    js = j_actions.SalutationClsTree()
    p = js.init(jax.random.key(5), fm)
    ts = convert.salutation_from_flax(_np(p), device="cpu")
    with torch.no_grad():
        out = ts(torch.as_tensor(fm))
    assert out.shape == (2, 3, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(js.apply(p, fm)),
                               atol=TOL)


def _write_catalog(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(r) + "\n")
        f.write("\n")                       # blank rows are skipped
        f.write("hug\tsmile\n")            # missing fields are "null"


def test_collect_act_emb_random_bit_equal(tmp_path):
    cat = tmp_path / "acts.tsv"
    _write_catalog(cat, _catalog())
    for enc in ("random",):
        j_collect.main(["--catalog", str(cat), "--out", str(tmp_path / "j.npy"),
                        "--encoder", enc, "--seed", "3"])
        collect_act_emb.main(["--catalog", str(cat), "--out",
                              str(tmp_path / "t.npy"), "--encoder", enc,
                              "--seed", "3"])
        t, j = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
        assert t.dtype == j.dtype == np.float32 and t.shape == (7, 810)
        np.testing.assert_array_equal(t, j)


def test_collect_act_emb_encoders_on_cpu(tmp_path):
    """bow and the full-width ERNIE on seeded weights: the table's shape,
    its one-hot columns, and the default 3-token vocab's collapse (every
    word is [UNK], so equal word counts give equal embeddings)."""
    rows = [("wave", "smile", "hi there", "null"),
            ("hug", "shy", "good morning", "null"),
            ("null", "null", "hello", "null")]
    cat = tmp_path / "acts.tsv"
    _write_catalog(cat, rows)
    for enc in ("bow", "ernie"):
        out = tmp_path / f"{enc}.npy"
        table = collect_act_emb.main(["--catalog", str(cat), "--out", str(out),
                                      "--encoder", enc, "--device", "cpu"])
        np.testing.assert_array_equal(np.load(out), table)
        assert table.shape == (4, 810) and np.isfinite(table).all()
        np.testing.assert_array_equal(table[:, :42], np.stack(
            [actions.MultimodalAction(*r).one_hot() for r in
             rows + [("hug", "smile", "null", "null")]]))
    # ERNIE with the default vocab: "hi there" and "good morning" collide
    np.testing.assert_array_equal(table[0, 42:], table[1, 42:])
    assert not np.array_equal(table[0, 42:], table[2, 42:])


def _prepare_both(tmp_path, argv):
    outs = []
    for name, main in (("j", j_prepare.main), ("t", prepare_dataset.main)):
        out = tmp_path / name
        main(argv + ["-o", str(out)])
        outs.append(out)
    return outs


def test_prepare_dataset_ds_byte_equal(tmp_path):
    annos = tmp_path / "annos"
    annos.mkdir()
    with open(annos / "a.txt", "w") as f:
        for i in range(20):
            f.write(f"vid_{i:02d}.mp4 {i * 5} {i % 4} 1 2 30 40\n")
    with open(annos / "b.txt", "w") as f:
        f.write("short line\n")
        for i in range(7):
            f.write(f"w_{i}.mp4 {i} 2\n")
    wae = tmp_path / "wae"
    wae.mkdir()
    np.save(wae / "raw_wae.npy", np.arange(6, dtype=np.float32))
    jo, to = _prepare_both(tmp_path, ["-dv", "ds", "-ad", str(annos),
                                      "--test_frac", "0.2", "--seed", "3",
                                      "-wd", str(wae)])
    assert (to / "dataset.json").read_bytes() == \
        (jo / "dataset.json").read_bytes()
    assert (to / "raw_wae.npy").read_bytes() == \
        (jo / "raw_wae.npy").read_bytes()


def test_prepare_dataset_salutation_byte_equal(tmp_path):
    annos = tmp_path / "annos"
    annos.mkdir()
    labels = ["uncle", "null", "aunt", "man", "young_girl", "woman",
              "young_boy"]
    for v in range(7):
        with open(annos / f"vid_{v:02d}_anno.jsonl", "w") as f:
            for i in range(3):
                lab = labels[(v + i) % len(labels)]
                f.write(json.dumps({"ID": i, "Salutation": lab}) + "\n")
            f.write("\n")
    jo, to = _prepare_both(tmp_path, ["-dv", "salutation", "-ad", str(annos),
                                      "--test_frac", "0.3"])
    assert (to / "salutation.json").read_bytes() == \
        (jo / "salutation.json").read_bytes()
    jd = j_augment.SalutationDataset(str(annos), 0.3, seed=1)
    td = augment.SalutationDataset(str(annos), 0.3, seed=1)
    assert [vars(s) for s in td.train] == [vars(s) for s in jd.train]
    assert [vars(s) for s in td.test] == [vars(s) for s in jd.test]
    feat = lambda s: None if s.track_id == 2 else np.full(3, s.track_id)
    jb, tb = jd.build(feat), td.build(feat)
    for split in ("train", "test"):
        assert [(f.tolist(), t) for f, t in tb[split]] == \
            [(f.tolist(), t) for f, t in jb[split]]


def _moments(mod):
    return [mod.AnnotatedMoment(f"v{i}.mp4", 3 * i + 2, i % 5,
                                [1.0, 2.0, 3.0, 4.0] if i % 2 else None)
            for i in range(12)]


def test_dataset_sampler_and_assembly_bit_equal(tmp_path):
    jm, tm = _moments(j_data), _moments(data)
    jds, tds = j_data.XiaoduHiDataset(jm, 0.25, 7), data.XiaoduHiDataset(
        tm, 0.25, 7)
    assert [vars(m) for m in tds.train] == [vars(m) for m in jds.train]
    assert [vars(m) for m in tds.test] == [vars(m) for m in jds.test]
    jds.save(str(tmp_path / "j.json"))
    tds.save(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    back = data.XiaoduHiDataset.load(str(tmp_path / "j.json"))
    assert [vars(m) for m in back.train] == [vars(m) for m in tds.train]

    js, ts = j_data.WindowSampler(jm, 10, 1.5, 3), data.WindowSampler(
        tm, 10, 1.5, 3)
    for s in (js, ts):
        s.add_negatives([m for m in (jm if s is js else tm)][:4])
    for _ in range(50):
        assert ts.sample() == js.sample()

    r = np.random.RandomState(8)
    tokens = r.randn(10, 20, 562).astype(np.float32)
    valid = r.rand(10, 20) > 0.3
    for pos, tgt in ((True, 3), (True, None), (False, None)):
        a = data.assemble_training_sample(tokens, valid, 4, pos, tgt)
        b = j_data.assemble_training_sample(tokens, valid, 4, pos, tgt)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    lines = tmp_path / "anno.txt"
    lines.write_text("v.mp4 3 1 1 2 3 4\nbad\nw.mp4 9 2\n")
    assert [vars(m) for m in data.parse_annotation_file(str(lines))] == \
        [vars(m) for m in j_data.parse_annotation_file(str(lines))]


def test_video_augmentor_bit_equal():
    clip = np.random.RandomState(9).rand(4, 8, 8, 3).astype(np.float32)
    kw = dict(intensity_mul_probs=(0.5, 0.5), intensity_mul_values=(1.4, 0.7),
              seed=2)
    ja, ta, tt = (j_augment.VideoAugmentor(**kw), augment.VideoAugmentor(**kw),
                  augment.VideoAugmentor(**kw))
    changed = 0
    for _ in range(8):
        j = ja(clip)
        t = ta(clip)
        assert isinstance(t, np.ndarray)
        np.testing.assert_array_equal(t, j)
        out = tt(torch.as_tensor(clip))
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), j)
        changed += not np.array_equal(j, clip)
    assert changed
    assert augment.SALUTATION_TREE == j_augment.SALUTATION_TREE


def test_read_video_frames_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from paddlerobotics_torch.hri.video import VideoWriter

    path = str(tmp_path / "clip.mp4")
    w = VideoWriter(path, fps=30)
    r = np.random.RandomState(10)
    for i in range(12):
        w.write((r.rand(120, 160, 3) * 255).astype(np.uint8))
    w.close()
    idx = [0, 5, 11, 40]                    # the last is past the end: black
    j = j_data.read_video_frames(path, idx, size=64)
    t = data.read_video_frames(path, idx, size=64, device="cpu")
    assert t.shape == (4, 64, 64, 3) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6)


def test_prefetch_loader_batches_and_raises_worker_error():
    calls = []

    def sample():
        calls.append(1)
        if len(calls) > 6:
            raise ValueError("decode failed")
        return np.full(3, len(calls))

    loader = data.PrefetchLoader(sample, lambda b: np.stack(b), batch_size=2)
    got = []
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="decode failed"):
        for batch in loader:
            got.append(batch)
    assert time.perf_counter() - t0 < 1.0
    assert [b[:, 0].tolist() for b in got] == [[1, 2], [3, 4], [5, 6]]
    assert isinstance(loader.error, ValueError)
    loader.close()
    assert not loader._thread.is_alive()

    ok = data.PrefetchLoader(lambda: np.ones(2), lambda b: np.stack(b), 3,
                             prefetch=1)
    first = next(iter(ok))
    np.testing.assert_array_equal(first, np.ones((3, 2)))
    ok.close()
    assert not ok._thread.is_alive() and ok.error is None


def test_avatar_frames_bit_equal(tmp_path, monkeypatch):
    """Both renderers on the assets ``tests/test_hri_avatar.py`` writes: every
    composited frame equal, the files' decoded frames equal, and the render
    cache keyed alike."""
    pytest.importorskip("cv2")
    from test_hri_avatar import _read_frames, assets as make_assets

    from paddlerobotics_tpu.hri import avatar as j_avatar
    from paddlerobotics_tpu.hri import video as j_video
    from paddlerobotics_torch.hri import avatar as t_avatar
    from paddlerobotics_torch.hri import video as t_video

    class _Factory:
        def mktemp(self, name):
            p = tmp_path / name
            p.mkdir()
            return p

    root = make_assets.__wrapped__(_Factory())
    frames = {"j": [], "t": []}
    for name, mod in (("j", j_video), ("t", t_video)):
        def write(self, frame, orig=mod.VideoWriter.write, name=name):
            frames[name].append(frame.copy())
            return orig(self, frame)
        monkeypatch.setattr(mod.VideoWriter, "write", write)
    for args in (("hello there, a longer caption that wraps", "null", "smile",
                  "forward"), ("", "null", "null", "null")):
        for name, mod in (("j", j_avatar), ("t", t_avatar)):
            frames[name].clear()
            mod.RobotAvatar(root).render(*args, str(tmp_path / f"{name}.avi"))
        assert len(frames["t"]) == len(frames["j"]) > 0
        for a, b in zip(frames["t"], frames["j"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_read_frames(str(tmp_path / "t.avi")),
                        _read_frames(str(tmp_path / "j.avi"))):
            np.testing.assert_array_equal(a, b)
    assert t_avatar.get_macro_act_key("hi", "a", "b", "c") == \
        j_avatar.get_macro_act_key("hi", "a", "b", "c")
