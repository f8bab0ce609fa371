"""Port parity of the R(2+1)D baseline (``hri/r2plus1d``,
``hri/r2plus1d_train``) and its native clip server.

The same numpy inputs go through the JAX package's flax model and the
port's, on weights carried across by ``convert.r2plus1d_from_flax`` with
perturbed BatchNorm statistics: at the JAX test's CPU-sized stage plan and
at full width on a tiny clip, atol 1e-5 of the output's scale. Training
steps from the same weights on the same batches are held to JAX's step in
float64 at the bounds stated at the test. The clip loader is seeded from
the clip's label and time, not from ``hash``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri import native_pipeline as j_native
from paddlerobotics_tpu.hri import r2plus1d_train as jr2t
from paddlerobotics_tpu.hri.r2plus1d import R2Plus1D18 as JR2

from paddlerobotics_torch import convert
from paddlerobotics_torch.hri import native_pipeline as native
from paddlerobotics_torch.hri import r2plus1d_train as r2t
from paddlerobotics_torch.hri import stream_client
from paddlerobotics_torch.hri.r2plus1d import R2PLUS1D18_BLOCKS, R2Plus1D18
from paddlerobotics_torch.ops import build
from torch_parity import one_thread  # noqa: F401  (autouse)

TINY = ((32, (1, 1, 1)), (64, (2, 2, 2)))     # the JAX test's stage plan
TOL = 1e-5
LR = 5e-4


def _variables(model, x, seed):
    """flax variables with BN statistics and affine drawn from a seed."""
    v = jax.jit(lambda x: model.init(jax.random.key(seed), x, False))(x)
    rng = np.random.RandomState(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, v)


def _ncthw(x):
    return torch.as_tensor(x).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("plan", ["tiny", "full_width"])
def test_model_matches_flax(plan):
    """Inference on running statistics; at the tiny plan also a training
    forward (batch statistics) and the running statistics it leaves. The
    full-width plan ends at 1×1×1 on this clip, where batch statistics
    over two values are ill-conditioned, so it is held in inference only."""
    blocks, stem, hw = ((TINY, 3, 32) if plan == "tiny" else
                        (R2PLUS1D18_BLOCKS, 7, 16))
    x = np.random.RandomState(1).rand(2, 8, hw, hw, 3).astype(np.float32)
    jm = JR2(num_classes=5, blocks=blocks, stem_kernel=stem)
    v = _variables(jm, jnp.asarray(x), 0)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(v, x))
    net = convert.r2plus1d_from_flax(jax.tree.map(np.asarray, v), 5, blocks,
                                     stem, device="cpu").eval()
    with torch.no_grad():
        got = net(_ncthw(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max())
    if plan != "tiny":
        return
    ref_t, upd = jax.jit(lambda v, x: jm.apply(
        v, x, True, mutable=["batch_stats"]))(v, x)
    net.train()
    with torch.no_grad():
        got_t = net(_ncthw(x)).numpy()
    np.testing.assert_allclose(got_t, np.asarray(ref_t),
                               atol=TOL * np.abs(ref_t).max())
    after = convert.r2plus1d_from_flax(
        jax.tree.map(np.asarray, {"params": v["params"], **upd}), 5, blocks,
        stem, device="cpu")
    for (k, a), b in zip(net.state_dict().items(),
                         after.state_dict().values()):
        if "running" in k:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL)


def _manifest() -> set:
    """torchvision's r2plus1d_18 state_dict keys, as the JAX package's
    baselines test derives them by hand."""
    def bn_keys(p):
        return {f"{p}.weight", f"{p}.bias", f"{p}.running_mean",
                f"{p}.running_var", f"{p}.num_batches_tracked"}

    expected = {"stem.0.weight", "stem.3.weight", "fc.weight", "fc.bias"}
    expected |= bn_keys("stem.1") | bn_keys("stem.4")
    for L in range(1, 5):
        for i in range(2):
            b = f"layer{L}.{i}"
            for cv in ("conv1", "conv2"):
                expected |= {f"{b}.{cv}.0.0.weight", f"{b}.{cv}.0.3.weight"}
                expected |= bn_keys(f"{b}.{cv}.0.1")
                expected |= bn_keys(f"{b}.{cv}.1")
        if L > 1:
            expected |= {f"layer{L}.0.downsample.0.weight"}
            expected |= bn_keys(f"layer{L}.0.downsample.1")
    return expected


def test_torchvision_manifest_and_strict_load():
    """The port's keys are torchvision's; the JAX test's torchvision-layout
    module loads with strict=True and gives its forward."""
    from test_hri_baselines import _torch_r2plus1d_18

    net = R2Plus1D18(num_classes=5, device="cpu")
    assert set(net.state_dict()) == _manifest()
    torch.manual_seed(0)
    tm = _torch_r2plus1d_18(num_classes=5)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.3, 0.3)
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    tm.eval()
    net.load_state_dict(tm.state_dict(), strict=True)
    net.eval()
    x = torch.as_tensor(np.random.RandomState(1).rand(1, 3, 8, 32, 32),
                        dtype=torch.float32)
    with torch.no_grad():
        ref, got = tm(x).numpy(), net(x).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max())


def _loader(T=8, hw=32):
    """Clips whose mean intensity encodes the class, seeded from the clip's
    label and time (the JAX test's ``hash(video)`` changes per process)."""
    def load(video, t):
        label = int(video.split("_")[-1])
        rng = np.random.RandomState(1000 * label + t)
        return np.clip(0.15 + 0.3 * label + 0.05 * rng.randn(T, hw, hw, 3),
                       0, 1)
    return load


def _datasets():
    annos = [(f"pos_{i % 2 + 1}", t, i % 2 + 1)
             for i, t in enumerate(range(0, 4000, 250))]
    args = lambda m: ([m.ClipAnno(v, t, wae_id=w) for v, t, w in annos],
                      ["neg_0"] * 8, _loader())
    kw = dict(num_classes=3, group_by="WAE_id", test_frac=0.25, seed=0)
    return (jr2t.ClipDataset(*args(jr2t), **kw),
            r2t.ClipDataset(*args(r2t), **kw))


def _f64(tree):
    def up(a):
        floating = jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        return jnp.asarray(a, jnp.float64) if floating else a
    return jax.tree.map(up, tree)


def _port_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_trainer_steps_match_jax():
    """Three Adam steps from the same weights on the same batches, against
    the JAX trainer's step run in float64: XLA:CPU's float32 gradients of
    this network (batch-statistics BatchNorm over 4 clips) are up to 1.6% of
    a leaf's largest entry off their float64 values, where the port's
    float32 ones are within 2e-6 (ROADMAP Queue C). Bounds, each a few
    times what was measured: losses 1e-5 relative (3.4e-7); Adam's first
    moments 1e-4 of each leaf's largest entry (1.3e-5); weights 1e-4
    (1.9e-5, on weights whose gradient is near zero, which Adam's first
    step moves by up to lr); running statistics 1e-5 (1.2e-7)."""
    jd, td = _datasets()
    assert (jd.train, jd.test) == (td.train, td.test)
    jt = jr2t.R2Plus1DTrainer(num_classes=3, lr=LR, input_hw=32,
                              blocks=TINY, stem_kernel=3)
    tt = r2t.R2Plus1DTrainer(3, lr=LR, blocks=TINY, stem_kernel=3,
                             device="cpu")
    port = lambda p, b: convert.r2plus1d_from_flax(_port_tree(
        {"params": p, "batch_stats": b}), 3, TINY, 3, device="cpu")
    tt.model.load_state_dict(port(jt.params, jt.batch_stats).state_dict())
    batches = list(zip(jd.batches("train", 4), td.batches("train", 4)))[:3]
    with jax.enable_x64(True):
        p, b, opt = _f64(jt.params), _f64(jt.batch_stats), _f64(jt.opt_state)
        for (cj, lj), (ct, lt) in batches:
            np.testing.assert_array_equal(cj, ct)
            p, b, opt, loss_j, acc_j = jt._train_step(
                p, b, opt, jnp.asarray(cj, jnp.float64), lj)
            loss_t, acc_t = tt.train_step(ct, lt)
            assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * float(loss_j)
            assert float(acc_t) == float(acc_j)
            want = port(p, b).state_dict()
            for k, a in tt.model.state_dict().items():
                if not k.endswith("num_batches_tracked"):
                    tol = TOL if "running" in k else 1e-4
                    assert float((a - want[k]).abs().max()) <= tol, k
            mu = port(opt[0].mu, b).requires_grad_(False)
            for (k, w), m in zip(tt.model.named_parameters(),
                                 mu.parameters()):
                d = (tt.opt.state[w]["exp_avg"] - m).abs().max()
                assert float(d) <= 1e-4 * float(m.abs().max()), k


def test_fit_evaluate_and_sweep():
    """The JAX test's training run (25 epochs of the tiny plan) on the port:
    the last epoch's loss below chance, ln 3, and its accuracy above 1/3.
    The held-out accuracy is not held to the JAX test's 0.6: on these 4
    held-out clips it swings between 0.25 and 0.75 from one 5-epoch block
    to the next in both packages (measured), as the running statistics
    (momentum 0.99) trail the weights. The sweep equals JAX's on the same
    probabilities and its recall does not rise with the threshold."""
    _, td = _datasets()
    tr = r2t.R2Plus1DTrainer(3, lr=LR, blocks=TINY, stem_kernel=3,
                             device="cpu")
    hist = tr.fit(td, epochs=25, batch_size=4)
    assert hist["epoch"] == 24
    assert hist["loss"] < np.log(3.0) and hist["acc"] > 1 / 3
    res = tr.evaluate(td, batch_size=4)
    probs, labels = res["probs"], res["labels"]
    assert probs.shape == (4, 3) and labels.shape == (4,)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)
    assert res["accuracy"] == np.mean(probs.argmax(-1) == labels)
    rows = r2t.precision_recall_sweep(probs, labels)
    assert rows == jr2t.precision_recall_sweep(probs, labels)
    assert len(rows) == 19
    recalls = [r["recall"] for r in rows]
    assert all(a >= b - 1e-9 for a, b in zip(recalls, recalls[1:]))


def _tiny_pair(num_classes, hw, seed=2):
    jm = JR2(num_classes=num_classes, blocks=TINY, stem_kernel=3)
    v = _variables(jm, jnp.zeros((1, 8, hw, hw, 3)), seed)
    net = convert.r2plus1d_from_flax(jax.tree.map(np.asarray, v),
                                     num_classes, TINY, 3, device="cpu")
    return jm, v, net


def test_inference_fn_matches_jax():
    """Probabilities at 1e-5; the sampled ids equal JAX's given its Gumbel
    draw; never the null action."""
    jm, v, net = _tiny_pair(6, 32)
    clip = np.random.RandomState(3).rand(4, 8, 32, 32, 3).astype(np.float32)
    key = jax.random.key(7)
    probs_j, ids_j = jr2t.make_inference_fn(jm)(v, jnp.asarray(clip), 0.7, 3,
                                                key)
    noise = np.asarray(jax.random.gumbel(key, (4, 6)))
    probs_t, ids_t = r2t.make_inference_fn(net)(
        _ncthw(clip), 0.7, 3, noise=torch.as_tensor(noise))
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               atol=TOL)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert np.all(ids_t.numpy() != 0)


def test_clip_eval_server_matches_jax():
    """Both packages' clip servers on one library and the same weights: the
    clip C++ preprocessed is the same array on both sides, and the action
    distribution, null-action score and id agree; each wire
    response_score is the other side's distribution at its sampled id."""
    lib = build.build_native_runtime()[0]
    num_act = 6
    jm, v, net = _tiny_pair(num_act, native.CLIP_RES)
    fwd = jax.jit(lambda c: jax.nn.softmax(jm.apply(
        v, jnp.transpose(c, (0, 2, 3, 1))[None], False)[0]))
    seen_j, seen_t = [], []

    def score_j(clip):
        probs = np.asarray(fwd(jnp.asarray(clip)))
        seen_j.append((clip, probs))
        return probs, 1 + int(np.argmax(probs[1:]))

    scorer = r2t.ClipScorer(net, generator=torch.Generator().manual_seed(0))

    def score_t(clip):
        out = scorer(clip)
        seen_t.append((clip, out[0]))
        return out

    jserver = j_native.NativeClipEvalServer(score_j, num_act, lib_path=lib)
    server = native.NativeClipEvalServer(score_t, num_act, lib_path=lib)
    jclient = client = None
    try:
        jclient = stream_client.EvalStreamClient(port=jserver.port)
        client = stream_client.EvalStreamClient(port=server.port)
        frames = list(np.random.default_rng(4).random((10, 416, 416, 3),
                                                      np.float32))
        out_j, out_t = jclient.infer(frames), client.infer(frames)
        (clip_j, p_j), (clip_t, p_t) = seen_j[-1], seen_t[-1]
        assert clip_t.shape == (native.CLIP_LEN, 3, native.CLIP_RES,
                                native.CLIP_RES)
        np.testing.assert_array_equal(clip_t, clip_j)
        np.testing.assert_allclose(p_t, p_j, atol=TOL)
        assert abs(out_t["nullact_score"] - out_j["nullact_score"]) <= TOL
        assert out_t["nullact_id"] == out_j["nullact_id"]
        assert out_t["trigger_pred"] == out_j["trigger_pred"] == 0.0
        if out_t["nullact_id"] != 0:
            sid = out_t["response"]["action_id"]
            assert sid != 0
            assert abs(out_t["response_score"] - p_j[sid]) <= TOL
        else:
            assert out_t["response"] == out_j["response"] == {}
        server.check()
    finally:
        for c in (jclient, client):
            if c is not None:
                c.close()
        jserver.close()
        server.close()
