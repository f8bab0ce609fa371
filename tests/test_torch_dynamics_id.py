"""Port parity of dynamics identification (``train/dynamics_id``).

``trace_loss`` (population std, as ``jnp.std``) agrees with JAX's to 1e-6
on the same traces. ``generate_trace`` (B=2, T=10, a hidden draw of the 48
parameters at 0.2 of their range, JAX's measurement noise passed in)
agrees to 1e-4 absolute and relative, the env's per-step tolerance
(test_torch_env; measured 7e-6 on q, 1.1e-4 on a gyro of ~1 rad/s). The
draws are mild, as in test_torch_env: XLA's and ATen's last-bit
differences grow through contacts, and at half the range the gyro traces
part by 9e-4 within 10 steps (ROADMAP Queue C). ``_fitness`` of 4
candidates over the same traces, and ``score`` of 3 candidates tiled up to
the population, agree to 1e-4 relative (measured 4.2e-6; the loss divides
the squared error by the traces' variance over 10 steps). On the card the kernel and the
plain physics are bit-equal at full-range draws
(``tests/test_torch_card_kernels.py``, case ``dynid_pop``;
``tests/test_torch_card_etgrl.py``, ``_fitness``). The CLI runs on the CPU on npy logs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.core import config as jconfig
from paddlerobotics_tpu.envs import randomize as jrandomize
from paddlerobotics_tpu.envs.batched_env import BatchedQuadrupedEnv as JEnv
from paddlerobotics_tpu.etg import fit as jfit
from paddlerobotics_tpu.etg import model as jmodel
from paddlerobotics_tpu.sim.sbatch import BDynParams as JDyn
from paddlerobotics_tpu.train import dynamics_id as jdyn

from paddlerobotics_torch.cli import dynamics_id as dynamics_id_cli
from paddlerobotics_torch.core import config
from paddlerobotics_torch.envs import randomize
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.train import dynamics_id

P, T, BT = 4, 10, 2
ENV_ATOL = 1e-4
FIT_RTOL = 1e-4


def _cfg(mod):
    base = mod.QuadrupedConfig()
    return dataclasses.replace(base, sim=dataclasses.replace(
        base.sim, obs_latency_taps=base.sim.latency_buffer_len))


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _jdyn(params):
    return JDyn.from_leading(jax.vmap(jrandomize.param2dynamic)(
        jnp.asarray(params)))


@pytest.fixture(scope="module")
def traces():
    """JAX traces under a hidden draw: (gait, q, gyro, hidden params)."""
    rng = np.random.default_rng(0)
    hidden = (0.2 * rng.uniform(-1, 1, (BT, 48))).astype(np.float32)
    jcfg = jconfig.QuadrupedConfig()
    gait = np.array(jmodel.gait_table(*jfit.opt_with_points(jcfg.etg),
                                      jcfg.etg, T))
    env = JEnv(_cfg(jconfig), BT)
    q, g = jdyn.generate_trace(env, jnp.asarray(gait), _jdyn(hidden),
                               jax.random.key(1), noise_q=0.01,
                               noise_gyro=0.05)
    return gait, np.array(q), np.array(g), hidden


def test_generate_trace_and_trace_loss_match_jax(traces):
    gait, q_j, g_j, hidden = traces
    key = jax.random.fold_in(jax.random.key(1), 91)   # dynamics_id.py:56
    kq, kg = jax.random.split(key)
    noise = {"q": _t(jax.random.normal(kq, q_j.shape)),
             "gyro": _t(jax.random.normal(kg, g_j.shape))}
    env = BatchedQuadrupedEnv(_cfg(config), BT, device="cpu")
    q_t, g_t = dynamics_id.generate_trace(
        env, _t(gait), randomize.param2dynamic(_t(hidden).T),
        torch.Generator().manual_seed(1), noise_q=0.01, noise_gyro=0.05,
        noise=noise)
    np.testing.assert_allclose(q_t.numpy(), q_j, atol=ENV_ATOL,
                               rtol=ENV_ATOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=ENV_ATOL,
                               rtol=ENV_ATOL)
    sim_q, sim_g = q_j[:, 0], g_j[:, 0]
    real_q, real_g = q_j[:, 1], g_j[:, 1]
    np.testing.assert_allclose(
        float(dynamics_id.trace_loss(_t(sim_q), _t(sim_g), _t(real_q),
                                     _t(real_g))),
        float(jdyn.trace_loss(sim_q, sim_g, real_q, real_g)), rtol=1e-6)


def test_fitness_and_score_match_jax(tmp_path, traces):
    gait, q_j, g_j, hidden = traces
    jid = jdyn.DynamicsIdentifier(jconfig.QuadrupedConfig(), gait, q_j[:, 0], g_j[:, 0],
                                  popsize=P, outdir=str(tmp_path / "j"))
    tid = dynamics_id.DynamicsIdentifier(
        config.QuadrupedConfig(), gait, q_j[:, 0], g_j[:, 0], popsize=P,
        outdir=str(tmp_path / "t"), device="cpu")
    assert tid.env._hist_len == 40          # latency_buffer_len, rounded up
    sols = (0.1 * np.random.default_rng(2).standard_normal((P, 48))
            ).astype(np.float32)
    sols[0] = hidden[0]
    fit_j = np.asarray(jid._fitness(jnp.asarray(sols), jax.random.key(3)))
    fit_t = tid._fitness(_t(sols), torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_allclose(fit_t, fit_j, rtol=FIT_RTOL)
    assert np.argmax(fit_t) == 0            # the hidden draw fits best
    three = np.stack([sols[1], np.zeros(48, np.float32), hidden[0]])
    s_j = np.asarray(jid.score(jnp.asarray(three)))
    s_t = tid.score(_t(three)).numpy()
    assert s_t.shape == (3,)
    np.testing.assert_allclose(s_t, s_j, rtol=FIT_RTOL)
    np.testing.assert_allclose(s_t[2], -fit_t[0], rtol=1e-6)


def test_cli_writes_the_identified_params(tmp_path, traces):
    gait, q_j, g_j, _ = traces
    for name, arr in (("gait", gait), ("q", q_j[:, 0]), ("gyro", g_j[:, 0])):
        np.save(tmp_path / f"{name}.npy", arr)
    save = tmp_path / "dynamic_param.npy"
    dynamics_id_cli.main([
        "--gait", str(tmp_path / "gait.npy"), "--real_q",
        str(tmp_path / "q.npy"), "--real_gyro", str(tmp_path / "gyro.npy"),
        "--popsize", str(P), "--epochs", "1", "--outdir", str(tmp_path),
        "--save", str(save), "--device", "cpu"])
    best = np.load(save)
    assert best.shape == (48,) and np.isfinite(best).all()
