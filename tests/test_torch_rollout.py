"""Port parity of the slice as a whole: the deterministic-policy rollout.

The JAX SAC actor is initialised and carried over with
``convert.actor_from_flax``; the port's ``train.etg_rl.evaluate`` and
``ETGRLTrainer.evaluate`` then run 5 control steps of 8 envs from the same
start. Return and length agree to 1e-4 (the env agrees to 1e-4 per step,
test_torch_env; the return sums 5 rewards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddlerobotics_tpu.algos.networks import Actor as JActor
from paddlerobotics_tpu.core.config import QuadrupedConfig as JConfig
from paddlerobotics_tpu.train.etg_rl import ETGRLTrainer

from paddlerobotics_torch import convert
from paddlerobotics_torch.algos import sac
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.train import etg_rl

B = 8
STEPS = 5


def _params_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_actor_from_flax_round_trip():
    actor_j = JActor(12, hidden=256)
    params = actor_j.init(jax.random.key(4), jnp.zeros((1, 49)))
    actor_t = convert.actor_from_flax(_params_np(params), device="cpu")
    obs = np.random.default_rng(0).standard_normal((16, 49)).astype(np.float32)
    mean_j, log_std_j = actor_j.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        mean_t, log_std_t = actor_t(torch.as_tensor(obs))
        act_t = sac.predict(actor_t, torch.as_tensor(obs))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(log_std_t.numpy(), np.asarray(log_std_j),
                               atol=1e-5)
    np.testing.assert_allclose(act_t.numpy(), np.tanh(np.asarray(mean_j)),
                               atol=1e-5)
    assert actor_t.dense[0].weight.shape == (256, 49)


def test_evaluate_matches_trainer_evaluate(tmp_path):
    trainer = ETGRLTrainer(JConfig(), num_envs=B, outdir=str(tmp_path))
    state = trainer.sac.init(jax.random.key(1))
    # a policy whose actions are not all near zero
    params = jax.tree.map(lambda x: 4.0 * x, state.actor_params)
    ret_j, len_j, infos_j = trainer.evaluate(params, trainer._w0,
                                             trainer._b0, STEPS)

    env = BatchedQuadrupedEnv(QuadrupedConfig(), B, device="cpu")
    actor = convert.actor_from_flax(_params_np(params), device="cpu")
    w0 = torch.as_tensor(np.array(trainer._w0))
    b0 = torch.as_tensor(np.array(trainer._b0))
    ret_t, len_t, infos_t = etg_rl.evaluate(env, actor, w0, b0, STEPS)

    np.testing.assert_allclose(float(ret_t), float(ret_j), atol=1e-4)
    np.testing.assert_allclose(float(len_t), float(len_j), atol=1e-4)
    assert set(infos_t) == set(etg_rl.INFO_CHANNELS)
    for k in etg_rl.INFO_CHANNELS:
        np.testing.assert_allclose(float(infos_t[k]), float(infos_j[k]),
                                   atol=1e-4, err_msg=k)
    assert float(infos_t["velx"]) != 0.0
