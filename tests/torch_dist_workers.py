"""Rank programs of ``tests/test_torch_parallel.py``: each runs on every
rank of a gloo process group (``parallel/launch.spawn``), imports only torch
and the port (``spawn`` re-imports this module in every rank, so it must not
import JAX), and returns numpy results gathered to the one-process layout.
The same configurations, built here, give the parent's one-process
references.

``world2`` and ``world4`` run a list of checks in one group each, so the
ranks pay for one torch import; a check that raises records its traceback
and the next check runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from paddlerobotics_torch.algos import replay
from paddlerobotics_torch.algos.sac import SAC
from paddlerobotics_torch.cli import train_attention
from paddlerobotics_torch.core.config import (ESConfig, QuadrupedConfig,
                                              RandomConfig, SACConfig,
                                              TrainConfig)
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.hri.attention_ctrl import AttnCtrlConfig
from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                      synthetic_batch)
from paddlerobotics_torch.parallel import dryrun, sharding
from paddlerobotics_torch.train import checkpoints
from paddlerobotics_torch.train.bc_train import BCTrainer
from paddlerobotics_torch.train.dynamics_id import DynamicsIdentifier
from paddlerobotics_torch.train.etg_rl import ETGRLTrainer

CPU = torch.device("cpu")
ENV_B = 16              # the JAX test's sharded env batch
ROLL_B = 8
ROLL_STEPS = 5
ES_P = 4
BC_B = 16
DYN_P, DYN_T = 8, 4
HRI_B, HRI_STEPS = 4, 3
TRAIN_B = 16            # the JAX test's mesh trainer
TINY_CTRL = dict(num_actions=5, num_frames=3, tokens_per_frame=4,
                 model_dim=16, num_decoder_blocks=1, num_heads=2, ffn_dim=16)
ATTN_CLI = ["--synthetic", "2", "--epochs", "1", "--batch_size", "4",
            "--num_actions", "5", "--num_frames", "3", "--tokens_per_frame",
            "4", "--model_dim", "16", "--num_decoder_blocks", "1",
            "--num_heads", "2", "--ffn_dim", "16", "--device", "cpu"]


def _np(x):
    return x.detach().cpu().numpy()


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def rollout_config() -> QuadrupedConfig:
    """Every draw site of the env on: per-episode DR (with jitter), pushes,
    reset jitter, sensor noise and the spawn curriculum."""
    base = QuadrupedConfig()
    return dataclasses.replace(
        base,
        random=RandomConfig(random_dynamics=True, random_force=True,
                            dynamics_scale=0.2, dr_scale_jitter=True),
        sensors=dataclasses.replace(base.sensors, noise=True),
        train=dataclasses.replace(base.train, x_noise=True, spawn_x_max=0.5,
                                  spawn_x_frac=0.5, spawn_y=0.05,
                                  spawn_yaw=0.1))


def es_config() -> QuadrupedConfig:
    return QuadrupedConfig(es=ESConfig(popsize=ES_P, es_episode_len=5),
                           train=TrainConfig(num_envs=ENV_B))


def trainer_config() -> QuadrupedConfig:
    """The JAX mesh trainer test's configuration (test_parallel.py)."""
    B = TRAIN_B
    return QuadrupedConfig(
        sac=SACConfig(warmup_steps=0, batch_size=32, memory_size=2048),
        es=ESConfig(popsize=4, es_every_steps=B * 5, es_train_steps=1,
                    es_episode_len=5, es_num_envs=8),
        train=TrainConfig(num_envs=B, eval_every_steps=10 ** 9, e_step=50))


def dyn_traces():
    rng = np.random.RandomState(0)
    return (rng.randn(DYN_T, 12).astype(np.float32) * 0.05,
            rng.randn(DYN_T, 12).astype(np.float32) * 0.1,
            rng.randn(DYN_T, 3).astype(np.float32) * 0.1)


def hri_batches():
    cfg = AttnCtrlConfig(**TINY_CTRL)
    rng = np.random.RandomState(0)
    return cfg, [synthetic_batch(cfg, rng, HRI_B, CPU)
                 for _ in range(HRI_STEPS)]


def _state_np(module) -> dict:
    return {k: _np(v) for k, v in sharding.full_state_dict(module).items()}


# -- checks (each runs on every rank; a mesh argument is built per check) ---

def env_step(mesh, salt: int, actions: np.ndarray) -> dict:
    """The sharded env's reset and one step, gathered; and the same step
    from ``shard_env_state`` of the one-process reset."""
    env = BatchedQuadrupedEnv(QuadrupedConfig(), ENV_B, device=CPU, mesh=mesh)
    cols = env.cols
    st, obs0 = env.reset(gen(3), push_salt=salt)
    act = cols.cut(torch.as_tensor(actions), 0)
    _, obs, rew, done, _ = env.step(st, act)
    whole = BatchedQuadrupedEnv(QuadrupedConfig(), ENV_B, device=CPU)
    st1, _ = whole.reset(gen(3), push_salt=salt)
    local, off, width = sharding.shard_env_state(mesh, st1)
    _, obs_s, rew_s, _, _ = env.step(local, act)
    return {"obs0": _np(cols.gather(obs0)), "obs": _np(cols.gather(obs)),
            "rew": _np(cols.gather(rew)), "done": _np(cols.gather(done)),
            "obs_from_shard": _np(cols.gather(obs_s)),
            "rew_from_shard": _np(cols.gather(rew_s)),
            "off": off, "width": width, "local_q": tuple(local.robot.s.q.shape)}


def rollout(mesh, actions: np.ndarray) -> dict:
    """``ROLL_STEPS`` steps with autoreset (forced on even columns at step
    2) under every draw site; per step obs, reward, done, gathered."""
    env = BatchedQuadrupedEnv(rollout_config(), ROLL_B, device=CPU, mesh=mesh)
    cols = env.cols
    st, obs = env.reset(gen(7))
    out = {"obs": [_np(cols.gather(obs))], "rew": [], "done": []}
    for i in range(ROLL_STEPS):
        donef = torch.zeros(ROLL_B, dtype=torch.bool)
        if i == 2:
            donef[::2] = True
        st, obs, rew, done, _ = env.step(
            st, cols.cut(torch.as_tensor(actions[i]), 0), cols.cut(donef, 0))
        out["obs"].append(_np(cols.gather(obs)))
        out["rew"].append(_np(cols.gather(rew)))
        out["done"].append(_np(cols.gather(done)))
    out = {k: np.stack(v) for k, v in out.items()}
    out["q"] = _np(cols.gather(st.robot.s.q, -1))
    out["kp"] = _np(cols.gather(st.dyn.motor_kp, -1))
    return out


def es_eval(mesh, sols: np.ndarray, tmp: str) -> dict:
    tr = ETGRLTrainer(es_config(), num_envs=ENV_B,
                      outdir=os.path.join(tmp, "es"), mesh=mesh, device=CPU)
    ws, bs = tr.fit_etg_population(torch.as_tensor(sols))
    actor = tr.sac.init(gen(0)).actor
    buf = replay.create(5 * ES_P, tr.env.obs_dim, tr.env.action_dim,
                        device=CPU, mesh=mesh)
    fit, steps = tr.es_eval(actor, ws, bs, gen(1), 5, ES_P, buf)
    rows = (buf.data if mesh is None
            else sharding.all_gather(buf.data, mesh.get_group("env")))
    return {"fitness": _np(fit), "steps": _np(steps), "rows": _np(rows),
            "size": buf.size}


def replay_exchange(mesh) -> dict:
    """A ring of 24 rows over ``mesh``: 40 seeded rows written in steps of
    8 (wrapping), then K=2 batches of 6 sampled; the one-process ring on
    every rank gets the same writes and draws. Returns this rank's block,
    the one-process ring cut by ``shard_replay`` and both samples."""
    rng = torch.Generator().manual_seed(11)
    data = torch.randn(40, 2 * 3 + 2 + 2, generator=rng)
    bufs = [replay.create(24, 3, 2, device=CPU, mesh=m) for m in (mesh, None)]
    for i in range(0, 40, 8):
        for buf in bufs:
            replay.add_rows(buf, data[i:i + 8])
    got, one = (replay.sample_many(buf, 2, 6, generator=gen(12))
                for buf in bufs)
    cut = sharding.shard_replay(mesh, bufs[1])
    return {"block": _np(bufs[0].data), "cut": _np(cut.data),
            "lo": (bufs[0].lo, cut.lo), "counters": (bufs[0].ptr,
                                                     bufs[0].size),
            "sample": {k: _np(v) for k, v in got.items()},
            "one": {k: _np(v) for k, v in one.items()}}


def bc(mesh, tmp: str) -> dict:
    cfg = QuadrupedConfig()
    obs_dim = BatchedQuadrupedEnv(cfg, 1, device=CPU).obs_dim
    expert = SAC(obs_dim, 12, cfg.sac, device=CPU).init(gen(3))
    tr = BCTrainer(cfg, expert, num_envs=BC_B, outdir=os.path.join(tmp, "bc"),
                   sensor_noise=True, device=CPU, mesh=mesh)
    g = gen(1)
    state, obs = tr.reset(gen(0))
    bc_state = tr.bc.init(gen(4))
    state, obs, (s1, e1) = tr.collect(bc_state, state, obs, 2, True, g)
    state, obs, (s2, e2) = tr.collect(bc_state, state, obs, 2, False, g)
    buf = replay.bc_create(256, tr.student_obs_dim, tr.env.obs_dim,
                           device=CPU)
    replay.bc_add_batch(buf, torch.cat([s1, s2]), torch.cat([e1, e2]))
    losses = tr.distill(bc_state, buf, 2, batch_size=32, generator=gen(5))
    ret = tr.evaluate(bc_state.actor, "student", n_steps=3)
    return {"student": _np(torch.cat([s1, s2])),
            "expert": _np(torch.cat([e1, e2])),
            "losses": {k: float(v) for k, v in losses.items()},
            "actor": _state_np(bc_state.actor),
            "eval": [float(x) for x in ret]}


def dynamics_id(mesh, tmp: str) -> dict:
    gait, real_q, real_g = dyn_traces()
    ident = DynamicsIdentifier(QuadrupedConfig(), gait, real_q, real_g,
                               popsize=DYN_P,
                               outdir=os.path.join(tmp, "dynamics_id"),
                               device=CPU, mesh=mesh)
    st = ident.solver.init(torch.zeros(48), device=CPU)
    sols, st = ident.solver.ask(st, gen(1))
    fit = ident._fitness(sols, gen(2))
    st = ident.solver.tell(st, fit)
    return {"fitness": _np(fit), "best": _np(ident.solver.result(st)[0])}


def hri_train(mesh) -> dict:
    cfg, batches = hri_batches()
    tr = AttentionTrainer(cfg, mesh=mesh, device=CPU)
    state = tr.init(gen(0))
    aux = [{k: float(v) for k, v in tr.train_step(
        state, tr.shard_batch(b)).items()} for b in batches]
    rows = tr.shard_batch(batches[0])["frame_ids"].shape[0]
    moments = {n: _np(state.opt.state[p]["exp_avg"])
               for n, p in state.model.named_parameters()}
    return {"aux": aux, "rows": rows, "model": _state_np(state.model),
            "moments": moments}


def attention_cli(tmp: str) -> dict:
    out = os.path.join(tmp, "attn_cli")
    train_attention.main(ATTN_CLI + ["--outdir", out, "--distributed", "1"])
    dist.barrier()
    ck = checkpoints.restore(os.path.join(out, "itr_2"))
    return {"model": {k: _np(v) for k, v in ck["attn"]["model"].items()},
            "files": sorted(os.listdir(out))}


def mesh_train(mesh, tmp: str) -> dict:
    """The JAX mesh trainer test's run: a warm-up chunk, a learn chunk and
    an ES phase on ``mesh``; without a mesh also the SAC state it starts
    from (``init``)."""
    tr = ETGRLTrainer(trainer_config(), num_envs=TRAIN_B,
                      outdir=os.path.join(tmp, "train"), updates_per_step=1,
                      mesh=mesh, device=CPU)
    init = {}
    if mesh is None:
        s0 = tr.init_carry(0)[0].sac_state
        init = {"actor": _state_np(s0.actor), "critic": _state_np(s0.critic)}
        init["target"] = init["critic"]
    carry, (w, b, p) = tr.train(max_steps=TRAIN_B * 10, chunk_steps=5,
                                checkpoint=False)
    tr.logger.close()
    losses = []
    if sharding.is_writer():
        with open(os.path.join(tmp, "train", "metrics.jsonl")) as f:
            losses = [(m["tag"], m["step"], m["value"])
                      for m in map(json.loads, f) if "loss" in m["tag"]]
    ss = carry.sac_state
    return {"actor": _state_np(ss.actor), "critic": _state_np(ss.critic),
            "target": _state_np(ss.target_critic), "etg_param": _np(p),
            "init": init, "losses": losses,
            "local_q": tuple(carry.env_state.robot.s.q.shape),
            "local_w0": tuple(ss.actor.dense[0].weight.shape),
            "tp_layers": sum(getattr(m, "tp", None) is not None
                             for m in ss.actor.modules()),
            "replay_rows": tuple(carry.buffer.data.shape),
            "replay_size": carry.buffer.size,
            "finite": bool(torch.isfinite(carry.obs).all())}


def _learn_once(sac, state, seed: int):
    """One ``SAC.learn`` on a seeded batch (on a mesh every rank is given
    the whole batch and learns on its env rank's half)."""
    g = gen(seed)
    b = 16
    batch = {"obs": torch.randn(b, sac.obs_dim, generator=g),
             "act": torch.rand(b, 12, generator=g) * 2 - 1,
             "rew": torch.randn(b, 1, generator=g),
             "next_obs": torch.randn(b, sac.obs_dim, generator=g),
             "terminal": torch.ones(b, 1)}
    return sac.learn(state, batch, generator=g)


def checkpoint_roundtrip(mesh, tmp: str) -> dict:
    """A mesh state saved and restored in one process; a one-process state
    saved and restored onto the mesh."""
    sac_mesh = SAC(49, 12, SACConfig(), device=CPU, mesh=mesh)
    sac_one = SAC(49, 12, SACConfig(), device=CPU)
    state = sac_mesh.init(gen(0))
    _learn_once(sac_mesh, state, 1)
    path = checkpoints.save(os.path.join(tmp, "mesh_ck"), state,
                            torch.zeros(3, 20), torch.zeros(3),
                            torch.zeros(12), 7)
    dist.barrier()
    one = sac_one.init(None)
    checkpoints.load_sac_state(one, checkpoints.restore(path)["sac"])
    saved = checkpoints.sac_state_dict(state)
    restored = checkpoints.sac_state_dict(one)
    # the reverse: a one-process state (trained one step) onto the mesh
    src = sac_one.init(gen(5))
    _learn_once(sac_one, src, 6)
    back = sac_mesh.init(None)
    checkpoints.load_sac_state(back, checkpoints.sac_state_dict(src))
    to_np = lambda sd: {k: _np(v) for k, v in sd.items()}
    moments = lambda sd: [_np(st["exp_avg"]) for st in sd["state"].values()]
    return {
        "saved_actor": to_np(saved["actor"]),
        "restored_actor": to_np(restored["actor"]),
        "saved_critic_m": moments(saved["critic_opt"]),
        "restored_critic_m": moments(restored["critic_opt"]),
        "src_actor": to_np(checkpoints.sac_state_dict(src)["actor"]),
        "back_actor": to_np(checkpoints.sac_state_dict(back)["actor"]),
        "src_critic_m": moments(checkpoints.sac_state_dict(src)["critic_opt"]),
        "back_critic_m": moments(
            checkpoints.sac_state_dict(back)["critic_opt"]),
        "local_w0": tuple(back.actor.dense[0].weight.shape),
        "local_m0": tuple(back.critic_opt.state_dict()["state"][0]
                          ["exp_avg"].shape)}


# -- groups ------------------------------------------------------------------

def _run(checks) -> dict:
    out = {}
    for name, fn in checks:
        try:
            out[name] = fn()
        except Exception:                 # noqa: BLE001 — reported per check
            out[name] = {"error": traceback.format_exc()}
    return out


def world2(rank: int, inputs: dict, tmp: str) -> dict:
    m21 = lambda: sharding.make_mesh(2, 1)
    m12 = lambda: sharding.make_mesh(1, 2)

    def shapes():
        default = sharding.make_mesh()
        return {"default": (default["env"].size(), default["model"].size()),
                "1x2": (m12()["env"].size(), m12()["model"].size()),
                "names": tuple(default.mesh_dim_names)}

    return _run([
        ("mesh", shapes),
        ("env_step", lambda: env_step(m21(), inputs["salt"],
                                      inputs["actions"])),
        ("rollout", lambda: rollout(m21(), inputs["roll_actions"])),
        ("es_eval", lambda: es_eval(m21(), inputs["es_sols"], tmp)),
        ("replay", lambda: replay_exchange(m21())),
        ("bc", lambda: bc(m21(), tmp)),
        ("dynamics_id", lambda: dynamics_id(m21(), tmp)),
        ("hri_train", lambda: hri_train(m21())),
        ("attention_cli", lambda: attention_cli(tmp)),
        ("dryrun", lambda: dryrun.dryrun_multichip("cpu")),
    ])


def world4(rank: int, tmp: str) -> dict:
    m22 = lambda: sharding.make_mesh(2, 2)

    def shapes():
        m = m22()
        return {"2x2": (m["env"].size(), m["model"].size()),
                "coords": (m.get_local_rank("env"),
                           m.get_local_rank("model"))}

    return _run([
        ("mesh", shapes),
        ("train", lambda: mesh_train(m22(), tmp)),
        ("checkpoint", lambda: checkpoint_roundtrip(m22(), tmp)),
    ])
