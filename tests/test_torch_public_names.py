"""Port parity of public names the rest of the port does not call (the
JAX package's own callers are its per-env/batched bridges and its tests):
``BDynParams.from_leading``, ``smallalg``'s packing helpers and ``vneg``,
``MetricsLogger.add_scalars``, ``randomize.sample_push_force``,
``oscillator.feature_table``, ``reward.REWARD_CHANNELS`` and the
``SAC.predict`` / ``SAC.sample`` methods. ``BC.predict``
and ``SceneSensor.get_feature_map`` / ``get_instances`` are held in
test_torch_bc.py and test_torch_perception.py beside their fixtures."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddlerobotics_tpu.algos.sac import SAC as JSAC
from paddlerobotics_tpu.core.config import ETGConfig as JETGConfig
from paddlerobotics_tpu.core.config import SACConfig as JSACConfig
from paddlerobotics_tpu.envs import randomize as jrandomize
from paddlerobotics_tpu.envs import reward as jreward
from paddlerobotics_tpu.etg import oscillator as josc
from paddlerobotics_tpu.ops import smallalg as jsa
from paddlerobotics_tpu.sim import sbatch as jsb
from paddlerobotics_tpu.train import metrics as jmetrics

from paddlerobotics_torch import convert
from paddlerobotics_torch.algos import sac as sac_mod
from paddlerobotics_torch.core.config import ETGConfig, RewardConfig, SACConfig
from paddlerobotics_torch.envs import randomize, reward
from paddlerobotics_torch.etg import oscillator
from paddlerobotics_torch.ops import smallalg as sa
from paddlerobotics_torch.sim import sbatch
from paddlerobotics_torch.sim.dynamics import DynamicsParams
from paddlerobotics_torch.train import metrics


def test_bdynparams_from_leading_matches_jax():
    """Per-env draws of a vmap (leaves (B, ...)) to batch-last, equal."""
    keys = jax.random.split(jax.random.key(11), 5)
    lead = jax.vmap(lambda k: jrandomize.sample_dynamics(k, scale=0.5))(keys)
    want = jsb.BDynParams.from_leading(lead)
    got = sbatch.BDynParams.from_leading(DynamicsParams(
        *[torch.as_tensor(np.array(getattr(lead, f)))
          for f in DynamicsParams._fields]))
    for f in jsb.BDynParams._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_smallalg_packing_matches_jax():
    arr = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    j = jsa.from_leading(jnp.asarray(arr), 3)
    t = sa.from_leading(torch.as_tensor(arr), 3)
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(sa.to_leading(t).numpy(),
                                  np.asarray(jsa.to_leading(j)))
    mixed_t, mixed_j = [1.5, t[0], 0.0], [1.5, j[0], 0.0]
    lit_t = sa.broadcast_lits(mixed_t, t[1])
    lit_j = jsa.broadcast_lits(mixed_j, j[1])
    np.testing.assert_array_equal(sa.to_leading(lit_t).numpy(),
                                  np.asarray(jsa.to_leading(lit_j)))
    for a, b in zip(sa.vneg(mixed_t), jsa.vneg(mixed_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_metrics_add_scalars_matches_jax(tmp_path):
    rows = {}
    for name, mod in (("jax", jmetrics), ("torch", metrics)):
        log = mod.MetricsLogger(str(tmp_path / name), use_tensorboard=False)
        log.add_scalars("eval", {"reward": 1.25, "steps": 7}, 3)
        log.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            rows[name] = [{k: v for k, v in json.loads(line).items()
                           if k != "t"} for line in f]
    assert rows["torch"] == rows["jax"]
    assert [r["tag"] for r in rows["torch"]] == ["eval/reward", "eval/steps"]


def test_sample_push_force_matches_jax():
    """On JAX's own draws (one key for both, as the JAX function)."""
    for seed in range(3):
        k = jax.random.key(seed)
        want = jrandomize.sample_push_force(k, 40.0)
        got = randomize.sample_push_force(
            None, 40.0, normal=np.array(jax.random.normal(k, (2,))),
            uniform=np.array(jax.random.uniform(k, ())))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert float(got[2]) == 0.0
    g = torch.Generator().manual_seed(0)
    force = randomize.sample_push_force(g, 40.0)
    assert force.shape == (3,) and float(torch.linalg.norm(force)) <= 40.0


def test_feature_table_matches_jax():
    got = oscillator.feature_table(ETGConfig(), 60)
    want = josc.feature_table(JETGConfig(), 60)
    assert got.shape == (60, ETGConfig().H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_reward_channels_match_jax():
    assert reward.REWARD_CHANNELS == jreward.REWARD_CHANNELS
    z = torch.zeros(2)
    _, info = reward.compute_reward(
        RewardConfig(), z, z, torch.ones(2), torch.zeros(3, 2),
        torch.zeros(12, 2), torch.zeros(4, 2), torch.zeros(4, 2),
        torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.bool),
        torch.zeros(4, 2, dtype=torch.bool), torch.zeros(2, dtype=torch.bool))
    assert tuple(info) == reward.REWARD_CHANNELS


def test_sac_predict_and_sample_methods_match_jax():
    """The methods on the actor module in place of ``actor_params``; the
    sample on JAX's own normal draw, injected as ``noise``."""
    jsac = JSAC(49, 12, JSACConfig(hidden_dim=16))
    params = jsac.init(jax.random.key(0)).actor_params
    sac = sac_mod.SAC(49, 12, SACConfig(hidden_dim=16), device="cpu")
    actor = convert.actor_from_flax(jax.tree.map(np.array, params),
                                    device="cpu")
    obs = np.random.default_rng(3).standard_normal((5, 49)).astype(
        np.float32)
    tobs = torch.as_tensor(obs)
    with torch.no_grad():
        got = sac.predict(actor, tobs)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jsac.predict(params, jnp.asarray(obs))), atol=1e-6)
        key = jax.random.key(7)
        ja, jlp = jsac.sample(params, jnp.asarray(obs), key)
        noise = torch.as_tensor(np.array(jax.random.normal(key, (5, 12))))
        ta, tlp = sac.sample(actor, tobs, noise=noise)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4,
                                   rtol=1e-5)
        # a generator draws as the module function does
        a1, lp1 = sac.sample(actor, tobs,
                             generator=torch.Generator().manual_seed(2))
        a2, lp2 = sac_mod.sample(actor, tobs,
                                 generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(lp1, lp2, rtol=0, atol=0)
