"""Port parity of behaviour cloning: ``algos/bc.BC``, the paired BC buffer,
``train/bc_train``'s student view, collection and update schedule.

``BC.learn`` (hidden 32, batch 16), one and three updates from weights and
Adam states carried over by ``convert.bc_from_flax``, with the JAX draw
of the student's sample noise passed in: losses, weights and both Adam
states agree to 1e-5 (float32 products and Adam in two libraries), with
the plain and the LayerNorm expert critic. The BC buffer's ring writes and
gathers are exact. ``student_view`` with JAX's noise draws agrees to 1e-6.
One ``collect`` phase (B=8, 3 control steps, the student's sampled
actions, sensor noise on) fed the JAX phase's draws agrees with it to 1e-4, the env's per-step tolerance
(test_torch_env). ``train`` runs the power-of-two bucketed update counts
of bc_train.py:194-196.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.algos import replay as jreplay
from paddlerobotics_tpu.algos.bc import BC as JBC
from paddlerobotics_tpu.algos.sac import SAC as JSAC
from paddlerobotics_tpu.core.config import QuadrupedConfig as JConfig
from paddlerobotics_tpu.core.config import SACConfig as JSACConfig
from paddlerobotics_tpu.train import bc_train as jbc_train

from paddlerobotics_torch import convert
from paddlerobotics_torch.algos import replay
from paddlerobotics_torch.algos.bc import BC
from paddlerobotics_torch.core.config import QuadrupedConfig, SACConfig
from paddlerobotics_torch.train import bc_train

from torch_parity import assert_adam_matches, assert_module_matches

S, E, A, H, BS = 46, 49, 12, 32, 16
ATOL = 1e-5
ENV_ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _batch(i):
    rng = np.random.default_rng(10 + i)
    return {"obs": rng.standard_normal((BS, S)).astype(np.float32),
            "ref_obs": rng.standard_normal((BS, E)).astype(np.float32)}


def _expert(ln):
    cfg = dict(hidden_dim=H, ln_critic=ln)
    js = JSAC(E, A, JSACConfig(**cfg))
    st = js.init(jax.random.key(3))
    return js, st, convert.sac_from_flax(_np(st), E, A, SACConfig(**cfg),
                                         device="cpu")


@pytest.mark.parametrize("n_learn", [1, 3])
@pytest.mark.parametrize("ln", [False, True])
def test_learn_matches_jax(n_learn, ln):
    js, jexp, texp = _expert(ln)
    jbc = JBC(S, A, hidden=H)
    learn = jax.jit(lambda st, b, e, k: jbc.learn(st, b, js, e, k))
    st = jbc.init(jax.random.key(0))
    # one JAX update first, so the carried Adam moments are not zero
    st, _ = learn(st, {k: jnp.asarray(v) for k, v in _batch(9).items()},
                  jexp, jax.random.key(8))
    ts = convert.bc_from_flax(_np(st), S, A, hidden=H, device="cpu")
    tbc = BC(S, A, hidden=H, device="cpu")
    key = jax.random.key(5)
    for i in range(n_learn):
        batch = _batch(i)
        key, k = jax.random.split(key)
        noise = _t(jax.random.normal(jax.random.split(k)[1], (BS, A)))
        st, lj = learn(st, {n: jnp.asarray(v) for n, v in batch.items()},
                       jexp, k)
        lt = tbc.learn(ts, {n: _t(v) for n, v in batch.items()}, texp,
                       noise=noise)
        for name in ("actor_loss", "critic_loss"):
            np.testing.assert_allclose(float(lt[name]), float(lj[name]),
                                       rtol=ATOL, atol=ATOL, err_msg=name)
    assert_module_matches(ts.actor, st.actor_params, ATOL, "actor")
    assert_module_matches(ts.critic, st.critic_params, ATOL, "critic")
    assert_adam_matches(ts.actor_opt, ts.actor, st.actor_opt[0], ATOL,
                        "actor_opt")
    assert_adam_matches(ts.critic_opt, ts.critic, st.critic_opt[0], ATOL,
                        "critic_opt")


def test_bc_buffer_matches_jax():
    N = 12
    jb = jreplay.bc_create(N, S, E)
    tb = replay.bc_create(N, S, E, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):                       # 24 rows into 12: wraps twice
        o = rng.standard_normal((8, S)).astype(np.float32)
        r = rng.standard_normal((8, E)).astype(np.float32)
        jb = jreplay.bc_add_batch(jb, jnp.asarray(o), jnp.asarray(r))
        replay.bc_add_batch(tb, _t(o), _t(r))
    assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size)) == (0, N)
    fields = tb.split(tb.data)
    np.testing.assert_array_equal(fields["obs"].numpy(), np.asarray(jb.obs))
    np.testing.assert_array_equal(fields["ref_obs"].numpy(),
                                  np.asarray(jb.ref_obs))
    key = jax.random.key(4)
    js = jreplay.bc_sample(jb, key, 7)
    idx = torch.as_tensor(np.array(jax.random.randint(key, (7,), 0, N)))
    ts = replay.bc_sample(tb, 7, idx=idx)
    for k in ("obs", "ref_obs"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def _view_noise(key, shape):
    """The JAX student view's draws (bc_train.py:41-46) as one array."""
    return np.concatenate([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                     shape + (hi - lo,)))
        for i, (lo, hi, _) in enumerate(jbc_train._NOISE_SLICES)], axis=-1)


def test_student_view_matches_jax():
    obs = np.random.default_rng(1).standard_normal((5, E)).astype(np.float32)
    key = jax.random.key(2)
    np.testing.assert_array_equal(
        bc_train.student_view(_t(obs)).numpy(),
        np.asarray(jbc_train.student_view(jnp.asarray(obs))))
    np.testing.assert_allclose(
        bc_train.student_view(_t(obs), _t(_view_noise(key, (5,)))).numpy(),
        np.asarray(jbc_train.student_view(jnp.asarray(obs), key)), atol=1e-6)
    assert bc_train._NOISE_SLICES == jbc_train._NOISE_SLICES


def test_collect_matches_jax(tmp_path):
    # the student's own sampled actions (the warm-up's are uniform draws)
    B, steps, warmup = 8, 3, False
    js, jexp, texp = _expert(False)
    jtr = jbc_train.BCTrainer(JConfig(), js, jexp, num_envs=B,
                              outdir=str(tmp_path / "j"), sensor_noise=True)
    ttr = bc_train.BCTrainer(QuadrupedConfig(), texp, num_envs=B,
                             outdir=str(tmp_path / "t"), sensor_noise=True,
                             device="cpu")
    st_j = jtr.bc.init(jax.random.key(6))
    st_j = st_j._replace(actor_params=jax.tree.map(lambda x: 0.5 * x,
                                                   st_j.actor_params))
    st_t = convert.bc_from_flax(_np(st_j), ttr.student_obs_dim, A,
                                device="cpu")
    env_j, obs_j = jtr._reset(jax.random.key(1))
    env_t, obs_t = ttr.reset(torch.Generator().manual_seed(1))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=1e-5)
    rng = jax.random.key(7)
    draws, r = [], rng
    for _ in range(steps):                   # bc_train.py:103-113
        r, k_a, k_n = jax.random.split(r, 3)
        draws.append({"act": _t(jax.random.normal(k_a, (B, A))),
                      "noise": _t(_view_noise(k_n, (B,)))})
    _, obs_j, _, (s_j, e_j) = jtr.collect(st_j, env_j, obs_j, rng, steps,
                                          warmup)
    _, obs_t, (s_t, e_t) = ttr.collect(st_t, env_t, obs_t, steps, warmup,
                                       draws=draws)
    for ours, theirs, name in ((s_t, s_j, "student"), (e_t, e_j, "expert"),
                               (obs_t, obs_j, "obs")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=ENV_ATOL, rtol=ENV_ATOL, err_msg=name)
    assert s_t.shape == (steps * B, ttr.student_obs_dim)


def test_train_runs_the_bucketed_update_counts(tmp_path, monkeypatch):
    # bc_train.py:194-196: 10 epochs × the buffer's 1024-batches, bucketed
    # to a power of two and capped at 64
    assert [bc_train.distill_updates(s, 10 ** 6, 10) for s in
            (256, 1024, 2048, 3072, 5120, 65_536, 100_000)] == \
        [10, 10, 20, 40, 80, 640, 640]
    assert bc_train.distill_updates(5120, 4096, 10) == 40   # the capacity
    _, _, texp = _expert(False)
    tr = bc_train.BCTrainer(QuadrupedConfig(), texp, num_envs=256,
                            outdir=str(tmp_path), device="cpu")
    tr.bc = BC(tr.student_obs_dim, A, hidden=H, device="cpu")
    counts = []
    distill = tr.distill

    def spy(state, buf, n, *a, **k):
        counts.append((n, buf.size))
        return distill(state, buf, n, *a, batch_size=BS, **k)

    monkeypatch.setattr(tr, "distill", spy)
    state, losses = tr.train(total_steps=3072, distill_epochs=2,
                             final_epochs=1)
    # three phases of 4 control steps at B=256, then 1 × 3 final sweeps
    assert counts == [(2, 1024), (4, 2048), (8, 3072), (3, 3072)]
    assert all(np.isfinite(v) for v in losses.values())


def test_predict_matches_jax():
    """``BC.predict`` (JAX algos/bc.py:48): tanh of the student's mean on
    converted weights."""
    jbc = JBC(S, A, hidden=H)
    st = jbc.init(jax.random.key(1))
    ts = convert.bc_from_flax(_np(st), S, A, hidden=H, device="cpu")
    obs = _batch(0)["obs"]
    got = BC(S, A, hidden=H, device="cpu").predict(ts.actor, _t(obs))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jbc.predict(st.actor_params, obs)),
                               atol=1e-6)
