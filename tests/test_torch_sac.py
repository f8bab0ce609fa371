"""Port parity of the SAC learner, its critic and the replay buffer.

Weights and optimiser states come across with ``convert.sac_from_flax`` /
``critic_from_flax``; every draw is JAX's, fed to the port pre-drawn.
Tolerances: the critic forward, ``sample`` and one or three ``learn``
steps (weights, targets, Adam μ/ν/count, losses, log_alpha) agree to 1e-5
(measured: ≤ 3e-7; optax puts Adam's ε outside the square root with both
moments bias-corrected, torch divides by √(bias correction) — the same in
exact arithmetic). With ``bf16=True`` both round the products' inputs to
bfloat16 and sum in float32: held at 1e-5 too (measured ≤ 1.2e-7, against
3e-3 between the bf16 and the float32 outputs). Replay writes and gathers
are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.algos import replay as jreplay
from paddlerobotics_tpu.algos.networks import Critic as JCritic
from paddlerobotics_tpu.algos.networks import \
    critic_apply_fused as j_critic_fused
from paddlerobotics_tpu.algos.sac import SAC as JSAC
from paddlerobotics_tpu.core.config import SACConfig as JSACConfig

from paddlerobotics_torch import convert
from paddlerobotics_torch.algos import replay, sac
from paddlerobotics_torch.algos.networks import critic_apply_fused
from paddlerobotics_torch.algos.sac import SAC
from paddlerobotics_torch.core.config import SACConfig

from torch_parity import assert_module_matches, assert_sac_matches

O, A, H, BS = 10, 3, 32, 16
ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((BS, O)).astype(np.float32),
            "act": np.tanh(rng.standard_normal((BS, A))).astype(np.float32),
            "rew": rng.standard_normal((BS, 1)).astype(np.float32),
            "next_obs": rng.standard_normal((BS, O)).astype(np.float32),
            "terminal": (rng.random((BS, 1)) > 0.2).astype(np.float32)}


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("layer_norm", [False, True])
def test_critic_and_fused_critic_match_flax(layer_norm):
    jc = JCritic(hidden=H, layer_norm=layer_norm)
    obs, act = _batch()["obs"], _batch()["act"]
    params = jc.init(jax.random.key(3), jnp.zeros((1, O)), jnp.zeros((1, A)))
    if layer_norm:          # LayerNorm scale and bias away from 1 and 0
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.3 * jax.random.normal(
                jax.random.key(len(str(p))), x.shape)
            if "LN" in str(p) else x, params)
    q_ref = jc.apply(params, obs, act)
    q_fused_ref = j_critic_fused(params, obs, act, layer_norm=layer_norm)
    tc = convert.critic_from_flax(_np(params), O, layer_norm=layer_norm,
                                  device="cpu")
    with torch.no_grad():
        q_mod = tc(_t(obs), _t(act))
        q_fused = critic_apply_fused(tc, _t(obs), _t(act))
    for ours, theirs in ((q_mod, q_ref), (q_fused, q_fused_ref),
                         (q_fused, q_ref)):
        for i in range(2):
            assert ours[i].shape == (BS, 1)
            np.testing.assert_allclose(ours[i].numpy(),
                                       np.asarray(theirs[i]), atol=ATOL)
    assert_module_matches(tc, params, 0.0)      # the round trip is exact


def test_fused_critic_bf16_sums_in_float32():
    jc = JCritic(hidden=H)
    b = _batch()
    params = jc.init(jax.random.key(3), jnp.zeros((1, O)), jnp.zeros((1, A)))
    q_ref = j_critic_fused(params, b["obs"], b["act"], bf16=True)
    tc = convert.critic_from_flax(_np(params), O, device="cpu")
    with torch.no_grad():
        q = critic_apply_fused(tc, _t(b["obs"]), _t(b["act"]), bf16=True)
        q32 = critic_apply_fused(tc, _t(b["obs"]), _t(b["act"]))
    for i in range(2):
        assert q[i].dtype == torch.float32
        np.testing.assert_allclose(q[i].numpy(), np.asarray(q_ref[i]),
                                   atol=ATOL)
    # the bf16 rounding is really applied
    assert float((q[0] - q32[0]).abs().max()) > 100 * ATOL


def test_sample_matches_jax_on_its_draw():
    js = JSAC(O, A, JSACConfig(hidden_dim=H))
    st = js.init(jax.random.key(0))
    obs = _batch()["obs"]
    key = jax.random.key(7)
    act_j, logp_j = js.sample(st.actor_params, obs, key)
    noise = np.asarray(jax.random.normal(key, (BS, A)))
    actor = convert.actor_from_flax(_np(st.actor_params), device="cpu")
    with torch.no_grad():
        act_t, logp_t = sac.sample(actor, _t(obs), _t(noise))
    np.testing.assert_allclose(act_t.numpy(), np.asarray(act_j), atol=ATOL)
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), atol=ATOL)


@pytest.mark.parametrize("n_learn", [1, 3])
@pytest.mark.parametrize("auto_alpha", [False, True])
def test_learn_matches_jax(n_learn, auto_alpha):
    kw = dict(hidden_dim=H, batch_size=BS, auto_alpha=auto_alpha)
    js = JSAC(O, A, JSACConfig(**kw))
    st = js.init(jax.random.key(0))
    log_alpha0 = float(st.log_alpha)
    cfg = SACConfig(**kw)
    ts = convert.sac_from_flax(_np(st), O, A, cfg, device="cpu")
    tsac = SAC(O, A, cfg, device="cpu")
    learn = jax.jit(js.learn)
    key = jax.random.key(5)
    for i in range(n_learn):
        batch = _batch(i)
        key, k = jax.random.split(key)
        k_next, k_pi = jax.random.split(k)       # sac.py:126
        noise = tuple(_t(jax.random.normal(kk, (BS, A)))
                      for kk in (k_next, k_pi))
        st, lj = learn(st, {n: jnp.asarray(v) for n, v in batch.items()}, k)
        lt = tsac.learn(ts, {n: _t(v) for n, v in batch.items()},
                            noise=noise)
        for name in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(lt[name]), float(lj[name]),
                                       atol=ATOL, err_msg=name)
    assert_sac_matches(ts, st, ATOL)
    moved = float(st.log_alpha) != log_alpha0
    assert moved == auto_alpha


def test_sac_from_flax_round_trip():
    """The converted state holds the JAX state's values exactly, Adam
    moments included (after one JAX update, so they are not zero)."""
    js = JSAC(O, A, JSACConfig(hidden_dim=H, batch_size=BS, auto_alpha=True,
                               ln_critic=True))
    st = js.init(jax.random.key(0))
    st, _ = js.learn(st, {n: jnp.asarray(v) for n, v in _batch().items()},
                     jax.random.key(1))
    ts = convert.sac_from_flax(
        _np(st), O, A, SACConfig(hidden_dim=H, batch_size=BS, auto_alpha=True,
                                 ln_critic=True), device="cpu")
    assert_sac_matches(ts, st, 0.0)
    assert ts.critic.LN_3.weight.shape == (H,)


def test_reset_critic_keeps_the_actor():
    tsac = SAC(O, A, SACConfig(hidden_dim=H), device="cpu")
    g = torch.Generator().manual_seed(0)
    st = tsac.init(g)
    tsac.learn(st, {n: _t(v) for n, v in _batch().items()}, generator=g)
    actor, actor_opt, critic = st.actor, st.actor_opt, st.critic
    actor_before = [p.detach().clone() for p in st.actor.parameters()]
    critic_before = [p.detach().clone() for p in st.critic.parameters()]
    tsac.reset_critic(st, torch.Generator().manual_seed(911))
    assert st.actor is actor and st.actor_opt is actor_opt
    assert st.critic is not critic
    for a, b in zip(st.actor.parameters(), actor_before):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(st.critic.parameters(), critic_before))
    for a, b in zip(st.critic.parameters(),
                    st.target_critic.parameters()):
        assert torch.equal(a, b)
    assert not st.critic_opt.state          # fresh Adam


def test_replay_ring_and_sample_many_match_jax():
    N, Bw, K = 12, 5, 3
    jb = jreplay.create(N, O, A)
    tb = replay.create(N, O, A, device="cpu")
    rng = np.random.default_rng(0)
    for step in range(4):                     # 20 rows into 12: wraps twice
        rows = (rng.standard_normal((Bw, O)).astype(np.float32),
                rng.standard_normal((Bw, A)).astype(np.float32),
                rng.standard_normal(Bw).astype(np.float32),
                rng.standard_normal((Bw, O)).astype(np.float32),
                (rng.random(Bw) > 0.5).astype(np.float32))
        jb = jreplay.add_batch(jb, *map(jnp.asarray, rows))
        replay.add_batch(tb, *map(_t, rows))
        assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size))
        for name, v in tb.fields().items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(jb, name)))
    key = jax.random.key(2)
    jbatch = jreplay.sample_many(jb, key, K, 4)
    idx = jax.random.randint(key, (K * 4,), 0, jnp.maximum(jb.size, 1))
    tbatch = replay.sample_many(tb, K, 4, idx=_t(idx))
    for name in replay.FIELDS:
        assert tbatch[name].shape == jbatch[name].shape
        np.testing.assert_array_equal(tbatch[name].numpy(),
                                      np.asarray(jbatch[name]))
    one = replay.sample(tb, 4, idx=_t(idx[:4]))
    np.testing.assert_array_equal(one["obs"].numpy(),
                                  np.asarray(jbatch["obs"][0]))
    drawn = replay.sample_many(tb, K, 4, generator=torch.Generator())
    assert drawn["rew"].shape == (K, 4, 1)


def test_gru_actor_matches_flax():
    """flax's GRUCell layout (ir/iz/in with bias, hr/hz without, hn with)
    on a flat (T·obs) stack and on a (T, obs) sequence: 1e-5."""
    from paddlerobotics_tpu.algos.networks import GRUActor as JGRUActor

    from paddlerobotics_torch.algos.networks import GRUActor

    T_, D = 4, O
    ja = JGRUActor(A, hidden=H, seq_len=T_, frame_dim=D)
    x = np.random.default_rng(0).standard_normal((BS, T_ * D)).astype(
        np.float32)
    params = ja.init(jax.random.key(0), jnp.zeros((1, T_ * D)))
    params = jax.tree.map(lambda p: p + 0.1, params)    # biases away from 0
    ta = GRUActor(D, A, hidden=H, seq_len=T_, device="cpu")
    convert.load_flax(ta, _np(params))
    with torch.no_grad():
        for inp in (x, x.reshape(BS, T_, D)):
            mean_t, ls_t = ta(_t(inp))
            mean_j, ls_j = ja.apply(params, jnp.asarray(inp))
            np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j),
                                       atol=ATOL)
            np.testing.assert_allclose(ls_t.numpy(), np.asarray(ls_j),
                                       atol=ATOL)
