"""Port parity of ETG pretraining (``train/pretrain.ETGPretrainer``).

One generation's population fitness (popsize 4, B=8, 10 control steps, the
policy at 0) on the same injected solutions agrees with the JAX
``_rollout_population`` to 1e-4, the env's per-step tolerance
(test_torch_env) carried through a 10-step sum; the port sums each
candidate's contiguous envs by a reshape where JAX uses ``segment_sum``.
A two-generation ``train`` and the CLI run on the CPU; both packages
refuse a batch that is not a multiple of the popsize, as the JAX CLI's
default (4096 envs, popsize 40) is not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.core.config import ESConfig as JES
from paddlerobotics_tpu.core.config import QuadrupedConfig as JConfig
from paddlerobotics_tpu.train import pretrain as jpretrain

from paddlerobotics_torch.cli import pretrain_etg
from paddlerobotics_torch.core.config import ESConfig, QuadrupedConfig
from paddlerobotics_torch.train import pretrain

P, B, STEPS = 4, 8, 10
ATOL = 1e-4


def test_population_fitness_matches_jax(tmp_path):
    sols = 0.05 * np.random.default_rng(0).standard_normal((P, 12))
    sols = sols.astype(np.float32)
    jt = jpretrain.ETGPretrainer(JConfig(es=JES(popsize=P)), num_envs=B,
                                 outdir=str(tmp_path / "j"))
    fit_j = jt._rollout_population(jnp.asarray(sols), jax.random.key(1),
                                   STEPS)
    tt = pretrain.ETGPretrainer(QuadrupedConfig(es=ESConfig(popsize=P)),
                                num_envs=B, outdir=str(tmp_path / "t"),
                                device="cpu")
    fit_t = tt._rollout_population(torch.as_tensor(sols),
                                   torch.Generator().manual_seed(1), STEPS)
    np.testing.assert_allclose(fit_t.numpy(), np.asarray(fit_j), atol=ATOL)
    assert fit_t.shape == (P,) and len(set(fit_t.tolist())) == P


def test_train_and_cli_on_the_cpu(tmp_path, monkeypatch):
    tr = pretrain.ETGPretrainer(QuadrupedConfig(es=ESConfig(popsize=P)),
                                num_envs=B, outdir=str(tmp_path / "tr"),
                                device="cpu")
    best, best_r, (w, b) = tr.train(generations=2, episode_len=STEPS)
    assert best.shape == (12,) and np.isfinite(best_r)
    assert w.shape == (3, 20) and b.shape == (3,)

    monkeypatch.setattr(pretrain.ETGPretrainer, "train", functools.partialmethod(
        pretrain.ETGPretrainer.train, episode_len=STEPS))
    out = tmp_path / "etg.npz"
    pretrain_etg.main(["--device", "cpu", "--popsize", str(P), "--num_envs",
                       str(B), "--generations", "2", "--outdir",
                       str(tmp_path / "cli"), "--save_path", str(out)])
    art = np.load(out)
    assert {k: art[k].shape for k in art.files} == {
        "w": (3, 20), "b": (3,), "param": (12,)}
    with pytest.raises(SystemExit, match="use_pallas"):
        pretrain_etg.main(["--use_pallas", "0"])


def test_batch_must_hold_whole_candidates(tmp_path):
    with pytest.raises(AssertionError):
        jpretrain.ETGPretrainer(JConfig(), num_envs=4096,
                                outdir=str(tmp_path))
    with pytest.raises(ValueError, match="multiple of the popsize"):
        pretrain.ETGPretrainer(QuadrupedConfig(), num_envs=4096,
                               outdir=str(tmp_path), device="cpu")
