"""Port parity of MobileNetV2 and ResNet (``hri/perception/backbones``), of
the frozen-graph reader and writer (``hri/perception/tf_graph``) and of the
re-ID encoder's frozen-graph import (``reid.import_tf_consts``).

The backbones run on ``convert.mobilenet_from_flax`` /
``convert.resnet_from_flax`` weights with perturbed BatchNorm statistics,
inference mode, against flax at atol 1e-5 of each output's scale. The
graph writer's bytes equal JAX's; the port's import of a graph equals
JAX's import carried across by ``convert.reid_from_flax`` exactly, and its
features JAX's forward at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri.perception import backbones as jbb
from paddlerobotics_tpu.hri.perception import tf_graph as jtf
from paddlerobotics_tpu.hri.perception.reid import MarsSmall128 as JReid
from paddlerobotics_tpu.hri.perception.reid import \
    import_tf_consts as j_import

from paddlerobotics_torch import convert
from paddlerobotics_torch.hri.perception import reid, tf_graph
from torch_parity import one_thread  # noqa: F401  (autouse)

TOL = 1e-5


def _perturbed(model, x, seed):
    """flax variables with BN statistics and affine drawn from a seed."""
    v = jax.jit(lambda x: model.init(jax.random.key(seed), x))(x)
    rng = np.random.RandomState(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, v)


@pytest.mark.parametrize("width,hw", [(1.0, 32)])
def test_mobilenet_v2_matches_flax(width, hw):
    x = np.random.RandomState(1).rand(2, hw, hw, 3).astype(np.float32)
    jm = jbb.MobileNetV2(width=width)
    v = _perturbed(jm, jnp.asarray(x), 0)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    net = convert.mobilenet_from_flax(v, width, device="cpu")
    with torch.no_grad():
        got = net(torch.as_tensor(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, int(1280 * width))
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("depths,hw", [((3, 4, 6, 3), 32)])
def test_resnet_matches_flax(depths, hw):
    x = np.random.RandomState(2).rand(1, hw, hw, 3).astype(np.float32)
    jm = jbb.ResNet(depths=depths)
    v = _perturbed(jm, jnp.asarray(x), 1)
    refs = jax.jit(jm.apply)(v, jnp.asarray(x))
    net = convert.resnet_from_flax(v, depths, device="cpu")
    with torch.no_grad():
        gots = net(torch.as_tensor(x).permute(0, 3, 1, 2))
    for got, ref in zip(gots, refs):
        ref = np.asarray(ref)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max())


def test_graph_writer_bytes_and_round_trip():
    arrays = [("a/w", np.random.RandomState(0).randn(3, 3, 2, 4)
               .astype(np.float32)),
              ("b/idx", np.arange(6, dtype=np.int32).reshape(2, 3)),
              ("c/scalar", np.float32(2.5).reshape(()))]
    blob = tf_graph.encode_const_graph(arrays)
    assert blob == jtf.encode_const_graph(arrays)
    parsed = tf_graph.parse_graph_consts(blob)
    assert list(parsed) == ["a/w", "b/idx", "c/scalar"]
    for name, src in arrays:
        np.testing.assert_array_equal(parsed[name], src)
        assert parsed[name].dtype == src.dtype


def _encoder(seed) -> reid.MarsSmall128:
    """The port's encoder with drawn weights and BN statistics, no conv or
    fc biases (the frozen graph has none)."""
    g = torch.Generator().manual_seed(seed)
    enc = reid.MarsSmall128(device="cpu", generator=g)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = m.num_features
                m.weight.copy_(torch.as_tensor(rng.uniform(0.9, 1.1, n)))
                m.bias.copy_(torch.as_tensor(rng.normal(0, 0.1, n)))
                m.running_mean.copy_(torch.as_tensor(rng.normal(0, 0.1, n)))
                m.running_var.copy_(torch.as_tensor(rng.uniform(0.8, 1.2, n)))
    return enc


@pytest.mark.parametrize("names", ["slim", "positional"])
def test_import_tf_consts_matches_jax(names):
    """The port's exporter writes TF-slim names; the 'positional' graph
    renames each BatchNorm's consts to bare indices in their own scope and
    drops gamma where it is 1, so the importer's positional fallback (3 or
    4 consts) is taken on both sides."""
    enc = _encoder(3)
    consts = reid.export_tf_consts(enc)
    if names == "positional":
        with torch.no_grad():
            enc.BatchNorm_1.weight.fill_(1.0)
        consts = reid.export_tf_consts(enc)
        renamed, k = [], 0
        for name, a in consts:
            scope = name.rsplit("/", 1)[0]
            if name.endswith("conv1_2/BatchNorm/gamma"):
                continue                       # slim scale=False: 3 consts
            if a.ndim == 1:
                renamed.append((f"{scope}/c{k}", a))
                k += 1
            else:
                renamed.append((name, a))
        consts = renamed
    blob = tf_graph.encode_const_graph(consts)
    assert blob == jtf.encode_const_graph(consts)
    parsed = tf_graph.parse_graph_consts(blob)
    got = reid.import_tf_consts(parsed, device="cpu")
    want = convert.reid_from_flax(jax.tree.map(
        np.asarray, j_import(jtf.parse_graph_consts(blob))), device="cpu")
    sd_g, sd_w, sd_e = got.state_dict(), want.state_dict(), enc.state_dict()
    for k in sd_w:
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(sd_g[k], sd_w[k]), k
        assert torch.equal(sd_g[k], sd_e[k]), k
    crops = np.random.RandomState(9).rand(4, 128, 64, 3).astype(np.float32)
    with torch.no_grad():
        f = got(torch.as_tensor(crops)).numpy()
        assert np.array_equal(f, enc(torch.as_tensor(crops)).numpy())
    variables = j_import(jtf.parse_graph_consts(blob))
    ref = np.asarray(JReid().apply(variables, jnp.asarray(crops), False))
    assert np.abs(ref[0] - ref[1]).max() > 1e-3
    np.testing.assert_allclose(f, ref, atol=TOL)


def test_import_tf_consts_refuses_a_wrong_graph():
    consts = reid.export_tf_consts(_encoder(4))
    with pytest.raises(ValueError, match="expected kernel"):
        reid.import_tf_consts(dict(consts[1:]), device="cpu")
    with pytest.raises(ValueError, match="unconsumed"):
        reid.import_tf_consts(dict(consts + [("extra/w", np.ones(
            (2, 2), np.float32))]), device="cpu")
    enc = _encoder(5)
    with torch.no_grad():
        enc.Conv_0.bias.fill_(0.1)
    with pytest.raises(ValueError, match="bias"):
        reid.export_tf_consts(enc)
