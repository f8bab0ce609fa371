"""Port parity of the ETG-RL trainer: the slice as a whole.

A warm and a cold ``rollout_chunk`` (2 control steps, B=8, K=2, hidden 32,
batch 16, a 12-row replay that wraps) run from the same start as the JAX
``ETGRLTrainer.rollout_chunk``, the port fed the JAX chunk's draws (its key
splits repeated here: etg_rl.py:242, :256-266, :291-303, sac.py:126).
Obs, reward, the chunk's outputs and the replay rows agree to 1e-4, the
env's per-step tolerance (test_torch_env); the weights and Adam states
after the chunk to 1e-5 (measured ≤ 3e-6: the learner sees inputs that
differ in the last bits only). The policy is the initial actor scaled by
0.25: at its full scale some means reach 5 on these observations, tanh
saturates, and log(1 − a² + 1e-6) turns the last-bit difference between
XLA's and ATen's tanh into a 0.5% difference of the log prob (ROADMAP
Queue C). The trainer's real starting policy, at full scale, is held over
one warm step at the bounds that conditioning leaves (see
``test_warm_step_at_full_actor_scale``). ``es_eval`` (B=8, P=2, 10 steps) agrees on
fitness to 1e-4, on episode length exactly, and writes the same replay
rows (1e-4). The ADR controller is exact, the CLI runs on the CPU and
refuses a mesh (it and the bench refuse the plain physics on the card),
and the recurrent modes are wired. The whole ``train()`` loop is held in
test_torch_train_loop.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.algos import replay as jreplay
from paddlerobotics_tpu.core import config as jconfig
from paddlerobotics_tpu.train import etg_rl as jetg_rl

from paddlerobotics_torch import convert
from paddlerobotics_torch.cli import train_bench, train_quadruped
from paddlerobotics_torch.core import config
from paddlerobotics_torch.train import etg_rl

from torch_parity import assert_sac_matches

B, K, HID, BS, N = 8, 2, 32, 16, 12
STEPS = 2
ATOL = 1e-4


def _cfg(mod, **sac):
    return mod.QuadrupedConfig(sac=mod.SACConfig(
        hidden_dim=HID, batch_size=BS, memory_size=N, **sac))


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_draws(rng, warm, a_dim, steps=STEPS):
    """The per-step draws of the JAX chunk, from its carry key."""
    out = []
    size = 0
    for _ in range(steps):
        rng, k_act, k_learn = jax.random.split(rng, 3)
        size = min(size + B, N)
        if warm:
            d = {"act": _t(jax.random.normal(k_act, (B, a_dim)))}
            k_b, k_learn = jax.random.split(k_learn)
            d["idx"] = _t(jax.random.randint(k_b, (K * BS,), 0, size))
            d["learn"] = []
            for k_u in jax.random.split(k_learn, K):
                k_next, k_pi = jax.random.split(k_u)
                d["learn"].append(tuple(_t(jax.random.normal(k, (BS, a_dim)))
                                        for k in (k_next, k_pi)))
        else:
            k_act, k_gait = jax.random.split(k_act)
            d = {"uniform": _t(jax.random.uniform(
                     k_act, (B, a_dim), minval=-1.0, maxval=1.0)),
                 "gait": _t(jax.random.normal(k_gait, (B, a_dim)))}
        out.append(d)
    return out


def _start(tmp_path, actor_scale=0.25, **sac):
    jtr = jetg_rl.ETGRLTrainer(_cfg(jconfig, **sac), num_envs=B,
                               outdir=str(tmp_path / "j"),
                               updates_per_step=K)
    sac_state = jtr.sac.init(jax.random.key(1))
    # 0.25: actions away from zero, tanh away from saturation (see above)
    sac_state = sac_state._replace(actor_params=jax.tree.map(
        lambda x: actor_scale * x, sac_state.actor_params))
    w, b = jtr.fit_etg(jnp.zeros(12))
    env_state, obs = jtr.env.reset(jax.random.key(2),
                                   *jtr._broadcast_etg(w, b))
    buf = jreplay.create(N, jtr.env.obs_dim, jtr.env.action_dim)
    jcarry = jetg_rl.TrainCarry(env_state, obs, sac_state, buf,
                                jax.random.key(3))

    ttr = etg_rl.ETGRLTrainer(_cfg(config, **sac), num_envs=B,
                              outdir=str(tmp_path / "t"), updates_per_step=K,
                              device="cpu")
    tcarry, _, _ = ttr.init_carry(0)
    tcarry.sac_state = convert.sac_from_flax(
        jax.tree.map(np.asarray, sac_state), ttr.env.obs_dim,
        ttr.env.action_dim, ttr.cfg.sac, device="cpu")
    np.testing.assert_allclose(tcarry.obs.numpy(), np.asarray(obs),
                               atol=1e-5)
    return jtr, jcarry, ttr, tcarry


@pytest.mark.parametrize("warm", [True, False])
def test_rollout_chunk_matches_jax(tmp_path, warm):
    jtr, jcarry, ttr, tcarry = _start(tmp_path)
    draws = _jax_draws(jcarry.rng, warm, ttr.env.action_dim)
    jcarry, jout = jtr.rollout_chunk(jcarry, 400, STEPS, warm)
    tout = ttr.rollout_chunk(tcarry, 400, STEPS, warm, draws=draws)

    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]),
                                   atol=ATOL, rtol=ATOL, err_msg=k)
    np.testing.assert_allclose(tcarry.obs.numpy(), np.asarray(jcarry.obs),
                               atol=ATOL, rtol=ATOL)
    assert (tcarry.buffer.ptr, tcarry.buffer.size) == \
        (int(jcarry.buffer.ptr), int(jcarry.buffer.size)) == (4, N)
    for name, v in tcarry.buffer.fields().items():
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(getattr(jcarry.buffer, name)),
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    assert_sac_matches(tcarry.sac_state, jcarry.sac_state, 1e-5)
    if warm:
        assert float(tout["critic_loss"]) > 0
    else:
        assert float(tout["critic_loss"]) == 0.0


# A warm step from the full-scale initial actor. The env side (obs,
# reward, info means, the replay rows) rolls the same weights and holds
# ATOL. The learner's side runs through the saturated log prob, whose 0.5%
# conditioning (see above) the losses carry as measured 0.65% (critic) and
# 0.11% (actor) relative differences: held at FULL_LOSS_RTOL. Adam's
# moments, per leaf in relative norm, measured 0.69% (μ) and 1.8% (ν, the
# squared gradient, about twice μ's): held at 2e-2 and 4e-2. The weights
# after Adam's normalised steps, measured 1.3e-5 apart: held at ATOL.
FULL_LOSS_RTOL = 1e-2
FULL_MU_RTOL, FULL_NU_RTOL = 2e-2, 4e-2


def test_warm_step_at_full_actor_scale(tmp_path):
    from torch_parity import _flax_leaf, assert_module_matches

    jtr, jcarry, ttr, tcarry = _start(tmp_path, actor_scale=1.0)
    draws = _jax_draws(jcarry.rng, True, ttr.env.action_dim, steps=1)
    jcarry, jout = jtr.rollout_chunk(jcarry, 400, 1, True)
    tout = ttr.rollout_chunk(tcarry, 400, 1, True, draws=draws)

    losses = ("critic_loss", "actor_loss")
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(
            float(tout[k]), float(jout[k]), atol=ATOL,
            rtol=FULL_LOSS_RTOL if k in losses else ATOL, err_msg=k)
    np.testing.assert_allclose(tcarry.obs.numpy(), np.asarray(jcarry.obs),
                               atol=ATOL, rtol=ATOL)
    for name, v in tcarry.buffer.fields().items():
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(getattr(jcarry.buffer, name)),
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    ts, js = tcarry.sac_state, jcarry.sac_state
    for mod, params in ((ts.actor, js.actor_params),
                        (ts.critic, js.critic_params),
                        (ts.target_critic, js.target_critic_params)):
        assert_module_matches(mod, params, ATOL)
    for opt, mod, adam in ((ts.actor_opt, ts.actor, js.actor_opt[0]),
                           (ts.critic_opt, ts.critic, js.critic_opt[0])):
        for prm, path, transposed in convert.flax_leaves(mod):
            st = opt.state[prm]
            assert float(st["step"]) == int(adam.count) == K
            for ours, theirs, rtol in (("exp_avg", adam.mu, FULL_MU_RTOL),
                                       ("exp_avg_sq", adam.nu, FULL_NU_RTOL)):
                t = st[ours].numpy()
                j = _flax_leaf(theirs, path)
                rel = (np.linalg.norm((t.T if transposed else t) - j)
                       / np.linalg.norm(j))
                assert rel <= rtol, (ours, path, rel)
    assert float(ts.log_alpha.detach()) == float(js.log_alpha)


def test_es_eval_matches_jax(tmp_path):
    jtr, jcarry, ttr, tcarry = _start(tmp_path)
    P, steps = 2, 10
    sols = 0.02 * np.random.default_rng(0).standard_normal((P, 12))
    ws, bs = jtr.fit_etg_population(jnp.asarray(sols, jnp.float32))
    fit_j, len_j, buf_j = jtr.es_eval(jcarry.sac_state.actor_params, ws, bs,
                                      jax.random.key(4), steps, P,
                                      jcarry.buffer)
    tws, tbs = ttr.fit_etg_population(_t(sols).float())
    np.testing.assert_allclose(tws.numpy(), np.asarray(ws), atol=1e-5)
    buf_t = tcarry.buffer
    fit_t, len_t = ttr.es_eval(tcarry.sac_state.actor, tws, tbs,
                               torch.Generator(), steps, P, buf_t)
    np.testing.assert_allclose(fit_t.numpy(), np.asarray(fit_j), atol=ATOL)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert (buf_t.ptr, buf_t.size) == (int(buf_j.ptr), int(buf_j.size))
    for name, v in buf_t.fields().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(buf_j, name)),
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    assert not np.allclose(fit_t[0].item(), fit_t[1].item())


def test_adaptive_dr_controller_matches_jax():
    kw = dict(random_dynamics=True, dynamics_scale=1.0, dr_scale_start=0.3,
              dr_adaptive=True, dr_success_lo=0.3, dr_success_hi=0.5,
              dr_step_up=0.1, dr_step_down=0.05)
    jc = jetg_rl.AdaptiveDRController(jconfig.RandomConfig(**kw))
    tc = etg_rl.AdaptiveDRController(config.RandomConfig(**kw))
    seq = np.random.default_rng(0).random(60)
    seq[:20] = 0.9
    for s in seq:
        assert tc.update(float(s)) == jc.update(float(s))


def _tiny(mod):
    # the configuration of tests/test_trainer.py
    return mod.QuadrupedConfig(
        sac=mod.SACConfig(memory_size=5000, warmup_steps=100, batch_size=64),
        es=mod.ESConfig(popsize=4, es_every_steps=800, es_train_steps=1,
                        es_episode_len=15),
        train=mod.TrainConfig(eval_every_steps=400, e_step=50,
                              eval_episode_len=15, num_envs=8))


def _tags(outdir):
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        return {json.loads(line)["tag"] for line in f}


def test_cli_runs_on_the_cpu_and_refuses_a_mesh(tmp_path, capsys):
    argv = ["--device", "cpu", "--num_envs", "8", "--task_mode", "ground",
            "--max_steps", "240", "--chunk_steps", "10", "--warmup_steps",
            "80", "--popsize", "4", "--ES_every", "10000", "--outdir",
            str(tmp_path), "--suffix", "cli"]
    train_quadruped.main(argv)
    assert "train/critic_loss" in _tags(str(tmp_path / "cli"))
    # a CPU mesh runs as gloo ranks (tests/test_torch_parallel.py), given
    # as NxM: "every card" means nothing there
    with pytest.raises(SystemExit, match="mesh 1 on the CPU"):
        train_quadruped.main(argv + ["--mesh", "1"])
    args = train_quadruped.build_parser().parse_args(
        ["--device", "cuda", "--use_pallas", "0"])
    with pytest.raises(SystemExit, match="use_pallas"):
        train_quadruped.check_args(args)
    # the bench takes the JAX bench's flag and refuses 0 the same way
    with pytest.raises(SystemExit, match="use_pallas"):
        train_bench.main(["--use_pallas", "0"])
    # the shipped seed of a task is found by --ETG_path auto
    with pytest.raises(SystemExit, match="requires --load"):
        train_quadruped.main(argv + ["--eval", "1"])


def test_rnn_modes_are_wired(tmp_path):
    for mode in ("stack", "GRU"):
        cfg = dataclasses.replace(_tiny(config), sensors=config.SensorConfig(
            rnn_time_steps=3, rnn_time_interval=1, rnn_mode=mode))
        tr = etg_rl.ETGRLTrainer(cfg, num_envs=8, outdir=str(tmp_path / mode),
                                 device="cpu")
        assert tr.env.obs_dim == tr.sac.obs_dim == 49 * 4
        carry, _ = tr.train(max_steps=240, chunk_steps=10, checkpoint=False)
        assert carry.buffer.size > 0
        assert all(torch.isfinite(p).all()
                   for p in carry.sac_state.actor.parameters())
    with pytest.raises(ValueError):
        etg_rl.ETGRLTrainer(dataclasses.replace(
            _tiny(config), sensors=config.SensorConfig(rnn_mode="bogus")),
            num_envs=8, outdir=str(tmp_path / "x"), device="cpu")


def test_obs_history_wrapper_matches_jax():
    """Both port modes against the JAX wrapper's (T+1, obs) sequence: the
    'GRU' output is the sequence, the 'stack' output its flattening."""
    from paddlerobotics_tpu.envs.batched_env import \
        BatchedQuadrupedEnv as JEnv
    from paddlerobotics_tpu.envs.wrappers import ObsHistoryWrapper as JWrap

    from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
    from paddlerobotics_torch.envs.wrappers import ObsHistoryWrapper

    jw = JWrap(JEnv(jconfig.QuadrupedConfig(), B), 3, 2, "GRU")
    tws = {m: ObsHistoryWrapper(BatchedQuadrupedEnv(
        config.QuadrupedConfig(), B, device="cpu"), 3, 2, m)
        for m in ("GRU", "stack")}
    assert tws["stack"].obs_dim == 4 * tws["GRU"].obs_dim == 4 * jw.obs_dim
    js, jo = jw.reset(jax.random.key(0))
    ts = {m: w.reset() for m, w in tws.items()}
    act = 0.3 * np.random.default_rng(0).standard_normal((B, 12)).astype(
        np.float32)
    jstep = jax.jit(jw.step)
    # env 0 is done after the second step: its history starts afresh
    for i in range(4):
        f = (np.arange(B) == 0) & (i == 1)
        if i:
            js, jo, *_ = jstep(js, jnp.asarray(act), jnp.asarray(f))
            ts = {m: w.step(ts[m][0], _t(act), _t(f))[:2]
                  for m, w in tws.items()}
        seq = np.asarray(jo)
        for m, want in (("GRU", seq), ("stack", seq.reshape(B, -1))):
            np.testing.assert_allclose(ts[m][1].numpy(), want, atol=ATOL,
                                       rtol=ATOL, err_msg=f"{m} step {i}")
        hist = ts["GRU"][0].history
        np.testing.assert_allclose(hist.numpy(), np.asarray(js.history),
                                   atol=ATOL, rtol=ATOL)
        if i == 1:      # env 0's history restarted, env 1's goes on
            assert float(hist[0, :-1].abs().max()) == 0.0
            assert float(hist[1, :-1].abs().max()) > 0.0
