"""Port parity of the ETG-RL trainer's whole ``train()`` loop.

The configuration of tests/test_trainer.py trains 880 env steps (B=8):
warm-up, SAC chunks, an eval window with a checkpoint and an ES phase. The
port writes the same metric tags as the JAX trainer on the same
configuration; its ``torch.save`` checkpoint restores the SAC state, Adam
states and ETG parameters exactly, and a trainer armed with it
(``restore``) starts from it.
"""

import json
import os

import torch

from paddlerobotics_tpu.core import config as jconfig
from paddlerobotics_tpu.train import etg_rl as jetg_rl

from paddlerobotics_torch.core import config
from paddlerobotics_torch.train import checkpoints, etg_rl


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


def test_train_writes_the_jax_tags_and_restores(tmp_path):
    jtr = jetg_rl.ETGRLTrainer(_tiny(jconfig), num_envs=8,
                               outdir=str(tmp_path / "j"))
    jtr.train(max_steps=880, chunk_steps=10, checkpoint=False)
    ttr = etg_rl.ETGRLTrainer(_tiny(config), num_envs=8,
                              outdir=str(tmp_path / "t"), device="cpu")
    carry, (w, b, param) = ttr.train(max_steps=880, chunk_steps=10)
    tags = _tags(str(tmp_path / "t"))
    assert tags == _tags(str(tmp_path / "j"))
    assert {"ES/episode_reward", "eval/episode_reward",
            "train/critic_loss"} <= tags
    assert w.shape == (3, 20) and param.shape == (12,)
    assert carry.buffer.size > 800
    assert checkpoints.latest_step(str(tmp_path / "t")) == 800
    target = checkpoints.save(str(tmp_path / "t"), carry.sac_state, w, b,
                              param, 880)
    restored = checkpoints.restore(target)
    st = ttr.sac.init(torch.Generator())
    checkpoints.load_sac_state(st, restored["sac"])
    for a, c in ((st.actor, carry.sac_state.actor),
                 (st.critic, carry.sac_state.critic),
                 (st.target_critic, carry.sac_state.target_critic)):
        for x, y in zip(a.state_dict().values(), c.state_dict().values()):
            assert torch.equal(x, y)
    for a, c in ((st.actor_opt, carry.sac_state.actor_opt),
                 (st.critic_opt, carry.sac_state.critic_opt)):
        for x, y in zip(a.state_dict()["state"].values(),
                        c.state_dict()["state"].values()):
            assert all(torch.equal(x[k], y[k]) for k in x)
    assert torch.equal(restored["etg_param"], param)
    # a trainer armed with the checkpoint starts from it and trains on
    t2 = etg_rl.ETGRLTrainer(_tiny(config), num_envs=8,
                             outdir=str(tmp_path / "t2"), device="cpu")
    carry2, (_, _, param2) = t2.restore(target).train(
        max_steps=80, chunk_steps=10, checkpoint=False)
    assert torch.equal(param2, param)
    assert all(torch.isfinite(p).all()
               for p in carry2.sac_state.actor.parameters())


