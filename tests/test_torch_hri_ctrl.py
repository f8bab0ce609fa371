"""Port parity of the HRI attention controller (``hri/attention_ctrl.py``,
``hri/transformer.py``, ``hri/actions.py``).

The flax controller is initialised at D=32, 2 blocks, 2 heads, ffn 64,
F=3 frames × K=4 tokens, 17 actions; every parameter is then perturbed
from a numpy seed (so LayerNorm scales and biases, which flax starts at
1 and 0, carry information) and carried across with
``convert.ctrl_from_flax``. Inputs come from a numpy seed with two padding
holes. Tolerance: atol 1e-4 / rtol 1e-4 on every output (float32 matmuls
and tanh-GELU in another order, two post- or pre-norm blocks deep).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri import actions as j_actions
from paddlerobotics_tpu.hri.attention_ctrl import (AttentionController as
                                                   JController,
                                                   AttnCtrlConfig as JConfig,
                                                   top_k_sampling as j_top_k)

from paddlerobotics_torch import convert
from paddlerobotics_torch.hri import actions
from paddlerobotics_torch.hri.attention_ctrl import (AttnCtrlConfig,
                                                     top_k_sampling)

ATOL = RTOL = 1e-4
SMALL = dict(num_actions=17, num_frames=3, tokens_per_frame=4, model_dim=32,
             num_decoder_blocks=2, num_heads=2, ffn_dim=64, act_tr_dim=24)
OUTPUTS = ("trigger_logits", "obj_logits", "act_logits", "hid", "frame_hid",
           "present_kv_arr")


def _inputs(cfg, B=2, seed=0):
    T = cfg.num_frames * cfg.tokens_per_frame
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((B, T, cfg.visual_token_dim), np.float32)
    fids = np.repeat(np.arange(1, cfg.num_frames + 1),
                     cfg.tokens_per_frame)[None].repeat(B, 0)
    pad = np.ones((B, T), np.float32)
    pad[0, 2] = 0.0                     # two padding holes
    pad[-1, 5] = 0.0
    return tokens, fids, pad


def ctrl_variables(jcfg, seed: int = 0) -> dict:
    """Flax AttentionController variables (numpy): flax's initialisation,
    then every leaf perturbed by 0.1·N(0,1) from a numpy seed, so that
    biases and LayerNorm scales (flax starts them at 0 and 1) carry
    information across the conversion."""
    T = jcfg.num_frames * jcfg.tokens_per_frame
    params = JController(jcfg).init(
        jax.random.key(seed),
        {"visual_tokens": jnp.zeros((1, T, jcfg.visual_token_dim))},
        jnp.ones((1, T), jnp.int32), jnp.ones((1, T)))
    rng = np.random.default_rng(100 + seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(
            x.shape).astype(np.float32), params)


def _torch_out(ctrl, tokens, fids, pad, **kw):
    with torch.no_grad():
        return ctrl({"visual_tokens": torch.as_tensor(tokens)},
                    torch.as_tensor(fids), torch.as_tensor(pad), **kw)


@pytest.mark.parametrize("normalize_before,kernel_path",
                         [(False, False), (True, False), (False, True)],
                         ids=["post_norm", "pre_norm", "kernel_flag"])
def test_controller_matches_flax(normalize_before, kernel_path):
    jcfg = JConfig(**SMALL, normalize_before=normalize_before)
    params = ctrl_variables(jcfg)
    tokens, fids, pad = _inputs(jcfg)
    out_j = JController(jcfg).apply(params, {"visual_tokens": tokens},
                                    jnp.asarray(fids), jnp.asarray(pad))
    cfg = AttnCtrlConfig(**SMALL, normalize_before=normalize_before,
                         use_pallas_attention=kernel_path)
    ctrl = convert.ctrl_from_flax(params, cfg, device="cpu")
    out_t = _torch_out(ctrl, tokens, fids, pad)
    for k in OUTPUTS:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    w = out_t["attn_weights"]
    assert tuple(w.shape) == tuple(out_j["attn_weights"].shape)
    if kernel_path:         # the flash path's weights are a zero placeholder
        assert not w.any()
    else:
        np.testing.assert_allclose(w.numpy(), np.asarray(out_j["attn_weights"]),
                                   atol=ATOL, rtol=RTOL)


def test_incremental_decode_matches_full():
    """Frame-by-frame decoding with the past-KV cache equals the full pass
    (test_hri_core.py::test_incremental_inference_matches_full), and each
    step equals the JAX step on the same cache."""
    jcfg = JConfig(**SMALL)
    params = ctrl_variables(jcfg, seed=1)
    tokens, fids, pad = _inputs(jcfg, B=1)
    ctrl = convert.ctrl_from_flax(params, AttnCtrlConfig(**SMALL),
                                  device="cpu")
    jmodel = JController(jcfg)
    full = _torch_out(ctrl, tokens, fids, pad)
    tpf = jcfg.tokens_per_frame
    past_kv = past_pad = None
    for f in range(jcfg.num_frames):
        sl = slice(f * tpf, (f + 1) * tpf)
        kw = {} if past_kv is None else dict(
            past_kv_arr=torch.as_tensor(past_kv),
            past_padding_mask=torch.as_tensor(past_pad))
        out = _torch_out(ctrl, tokens[:, sl], fids[:, sl], pad[:, sl], **kw)
        jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
        out_j = jmodel.apply(params, {"visual_tokens": tokens[:, sl]},
                             jnp.asarray(fids[:, sl]),
                             jnp.asarray(pad[:, sl]), **jkw)
        for k in ("trigger_logits", "act_logits", "present_kv_arr"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(out_j[k]),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
        pkv = out["present_kv_arr"].numpy()
        past_kv = pkv if past_kv is None else np.concatenate([past_kv, pkv],
                                                             axis=-2)
        past_pad = pad[:, sl] if past_pad is None else np.concatenate(
            [past_pad, pad[:, sl]], axis=-1)
    np.testing.assert_allclose(out["trigger_logits"][0, -1].numpy(),
                               full["trigger_logits"][0, -1].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out["act_logits"][0, -1].numpy(),
                               full["act_logits"][0, -1].numpy(), atol=1e-3)


def test_top_k_sampling_matches_jax_with_its_gumbel_draw():
    logits = np.random.default_rng(3).standard_normal((4, 3, 17),
                                                      np.float32) * 2.0
    for seed in range(5):
        key = jax.random.key(seed)
        ids_j = np.asarray(j_top_k(key, jnp.asarray(logits), 0.7, 5))
        g = np.asarray(jax.random.gumbel(key, logits.shape))
        ids_t = top_k_sampling(torch.as_tensor(logits), 0.7, 5,
                               noise=torch.as_tensor(np.array(g))).numpy()
        np.testing.assert_array_equal(ids_t, ids_j)
    gen = torch.Generator().manual_seed(0)
    ids = top_k_sampling(torch.as_tensor(logits), 1.0, 5, generator=gen)
    top5 = np.argsort(np.where(np.arange(17) == 0, -np.inf, logits),
                      axis=-1)[..., -5:]
    assert (ids.numpy()[..., None] == top5).any(-1).all()
    assert (ids.numpy() != 0).all()


def test_config_and_action_tables_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(AttnCtrlConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JConfig)])
    for name in ("ACTION_TO_ID", "ACTION_TO_ID_V2", "EXPRESSION_TO_ID",
                 "EXPRESSION_TO_ID_V2", "MOVEMENT_TO_ID"):
        assert getattr(actions, name) == getattr(j_actions, name), name
    a = actions.MultimodalAction("wave", "smile", "hi", "turn_left")
    ja = j_actions.MultimodalAction("wave", "smile", "hi", "turn_left")
    np.testing.assert_array_equal(a.one_hot(), ja.one_hot())
    np.testing.assert_array_equal(
        actions.MultimodalAction("hug", "shy").one_hot("v2"),
        j_actions.MultimodalAction("hug", "shy").one_hot("v2"))
