"""Multi-process training over ``torch.distributed`` on gloo CPU ranks: the
port's counterpart of ``tests/test_parallel.py`` (the JAX package on its
8-device virtual CPU mesh), case by case.

Two groups of ranks run the checks (``tests/torch_dist_workers.py``): two
ranks for the meshes 2×1 and 1×2, four for 2×2; the CLI test starts its own
two. Each group joins with a deadline and each collective has a timeout,
so a deadlock fails its tests, not the suite.

The module that carries the physics kernel, the sharded env step, is held
to the JAX package's sharded step at the physics tolerance (rtol/atol
1e-4). Everything else is held to the port's own run without a mesh (itself
held to JAX by the other ``test_torch_*`` files), at bounds measured here:

- the sharded env: every draw is made at the global shape, so the DR draws
  are equal; ATen's vectorised transcendentals (acos, atan2 in the gait's
  IK) round a narrower slice's columns differently in the last bit, so a
  reset and a step agree to ``STEP_TOL`` (4.8e-7 read) and 5 steps through
  contacts to ``ROLL_TOL`` (4.1e-5 read);
- the trainer on 2×2 and the dryrun's meshes: ``TRAIN_TOL``, the
  dryrun's own bound 2e-4 (the 2×2 trainer reads 9.6e-6 for the actor,
  4.3e-6 for the critic, 3.4e-8 for the target; the dryrun 6.7e-8 to
  4.7e-5 over 2×1, 1×2, 4×1, 2×2 and 1×4); and each of the trainer's
  actor, critic and target within ``MOVE_RTOL`` of the change training
  made to it from init (3.2e-3, 1.4e-3 and 4.2e-4 of it read);
- ES fitness, BC losses and weights, dynamics-ID fitness, HRI losses and
  Adam moments: ``LEARN_TOL`` (sums over the ranks in another order); the
  rows of ES replay and BC collection, which roll the env: ``ROLL_TOL``;
  HRI weights by ``_assert_adam_weights``;
- checkpoints: exact.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from paddlerobotics_torch.cli import train_attention, train_quadruped
from paddlerobotics_torch.parallel import dryrun, launch, sharding
from paddlerobotics_torch.train.checkpoints import restore

from torch_parity import one_thread  # noqa: F401

DEADLINE_S = 180.0      # a group's join
COLLECTIVE_S = 90.0     # a collective's timeout inside it
JAX_TOL = 1e-4          # the physics parity tolerance (test_torch_env)
STEP_TOL = 1e-6         # a sharded reset and step against one process
ROLL_TOL = 1e-4         # 5 steps under DR and contacts
TRAIN_TOL = dryrun.ACTOR_TOL   # a trained actor or critic, one process
MOVE_RTOL = 0.02        # the same, over the change training made from init
LEARN_TOL = 1e-5
HRI_LR = 1e-4           # AttentionTrainer's and the CLI's


def _spawn(fn, world, *args):
    return launch.spawn(fn, world, args, device="cpu", deadline_s=DEADLINE_S,
                        threads=1, timeout_s=COLLECTIVE_S)


def _check(results, name):
    out = results[name]
    if isinstance(out, dict) and "error" in out:
        pytest.fail(out["error"])
    return out


def _max_diff(a, b):
    if isinstance(a, dict):
        return max(_max_diff(a[k], b[k]) for k in a)
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return max(_max_diff(x, y) for x, y in zip(a, b, strict=True))
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _jax_reset():
    from paddlerobotics_tpu.core.config import QuadrupedConfig as JConfig
    from paddlerobotics_tpu.envs.batched_env import \
        BatchedQuadrupedEnv as JEnv

    jenv = JEnv(JConfig(), W.ENV_B)
    js, jobs = jenv.reset(jax.random.key(3))
    return jenv, js, jobs


def _jax_step(jenv, js, actions):
    """The JAX package's env step sharded over its 8-device CPU mesh."""
    from paddlerobotics_tpu.parallel import sharding as jsh

    mesh = jsh.make_mesh(n_env=8, n_model=1)
    with jax.set_mesh(mesh):
        _, obs, rew, done, _ = jax.jit(jenv.step)(
            jsh.shard_env_state(mesh, js), jnp.asarray(actions))
    return {"obs": np.asarray(obs), "rew": np.asarray(rew),
            "done": np.asarray(done)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups run in the background while this process computes
    JAX's sharded step and the port's one-process references (one thread,
    as the ranks)."""
    jenv, js, jobs = _jax_reset()
    rng = np.random.default_rng(5)
    bound = jenv.act_bound
    inputs = {
        "salt": int(js.push_salt),
        "actions": (0.2 * rng.uniform(-1, 1, (W.ENV_B, 12))
                    * bound).astype(np.float32),
        "roll_actions": (0.3 * rng.uniform(
            -1, 1, (W.ROLL_STEPS, W.ROLL_B, 12)) * bound).astype(np.float32),
        "es_sols": (0.05 * rng.standard_normal((W.ES_P, 12))
                    ).astype(np.float32)}
    tmp = tmp_path_factory.mktemp("ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(2) as ex:
            w2 = ex.submit(_spawn, W.world2, 2, inputs, str(tmp / "w2"))
            w4 = ex.submit(_spawn, W.world4, 4, str(tmp / "w4"))
            one = {"jax": {"obs0": np.asarray(jobs),
                           **_jax_step(jenv, js, inputs["actions"])},
                   "env_step": W.env_step(None, inputs["salt"],
                                          inputs["actions"]),
                   "rollout": W.rollout(None, inputs["roll_actions"]),
                   "es_eval": W.es_eval(None, inputs["es_sols"],
                                        str(tmp / "one")),
                   "bc": W.bc(None, str(tmp / "one")),
                   "dynamics_id": W.dynamics_id(None, str(tmp / "one")),
                   "hri_train": W.hri_train(None),
                   "train": W.mesh_train(None, str(tmp / "one"))}
            train_attention.main(W.ATTN_CLI + ["--outdir",
                                               str(tmp / "attn_one")])
            one["attention_cli"] = {k: v.numpy() for k, v in restore(
                str(tmp / "attn_one" / "itr_2"))["attn"]["model"].items()}
            return {"one": one, "w2": w2.result(), "w4": w4.result()}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world2(runs):
    return runs["w2"]


@pytest.fixture(scope="module")
def world4(runs):
    return runs["w4"]


@pytest.fixture(scope="module")
def one(runs):
    return runs["one"]


def test_mesh_shapes(world2, world4):
    for rank in world2:
        m = _check(rank, "mesh")
        assert m["default"] == (2, 1) and m["1x2"] == (1, 2)
        assert m["names"] == ("env", "model")
    coords = {_check(rank, "mesh")["coords"] for rank in world4}
    assert all(_check(r, "mesh")["2x2"] == (2, 2) for r in world4)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh(2, 1)


def test_env_state_sharded_step_matches_jax(world2, one):
    """The port's env step sharded over 2 gloo ranks against the JAX
    package's sharded over its 8-device mesh, and against the port's own
    one-process step."""
    out = [_check(r, "env_step") for r in world2]
    for r, o in enumerate(out):
        assert (o["off"], o["width"]) == (r * W.ENV_B // 2, W.ENV_B // 2)
        assert o["local_q"] == (12, W.ENV_B // 2)
        # shard_env_state of the one-process reset is the sharded reset
        np.testing.assert_array_equal(o["obs_from_shard"], o["obs"])
        np.testing.assert_array_equal(o["rew_from_shard"], o["rew"])
    got, jx = out[0], one["jax"]
    np.testing.assert_allclose(got["obs0"], jx["obs0"], atol=JAX_TOL)
    np.testing.assert_allclose(got["rew"], jx["rew"], atol=JAX_TOL)
    np.testing.assert_allclose(got["obs"], jx["obs"], atol=JAX_TOL,
                               rtol=JAX_TOL)
    np.testing.assert_array_equal(got["done"], jx["done"])
    ref = one["env_step"]
    for k in ("obs0", "obs", "rew"):
        assert _max_diff(got[k], ref[k]) <= STEP_TOL, k
    np.testing.assert_array_equal(got["done"], ref["done"])


def test_sharded_rollout_chunk(world2, one):
    """5 steps with every draw site on (DR with jitter, pushes, reset
    jitter, sensor noise, the spawn curriculum) and a forced autoreset: the
    gathered columns are the one-process env's."""
    got, ref = _check(world2[0], "rollout"), one["rollout"]
    assert got["rew"].shape == (W.ROLL_STEPS, W.ROLL_B)
    assert np.all(np.isfinite(got["obs"]))
    np.testing.assert_array_equal(got["done"], ref["done"])
    assert got["done"][2][::2].all()
    np.testing.assert_array_equal(got["kp"], ref["kp"])   # the DR draws
    assert _max_diff(got["obs"][0], ref["obs"][0]) <= STEP_TOL
    for k in ("obs", "rew", "q"):
        assert _max_diff(got[k], ref[k]) <= ROLL_TOL, k


def test_es_population_sharded_eval(world2, one):
    got, ref = _check(world2[0], "es_eval"), one["es_eval"]
    assert got["fitness"].shape == (W.ES_P,)
    assert np.all(np.isfinite(got["fitness"]))
    assert got["size"] == ref["size"] == 5 * W.ES_P
    assert _max_diff(got["fitness"], ref["fitness"]) <= LEARN_TOL * max(
        1.0, np.abs(ref["fitness"]).max())
    np.testing.assert_array_equal(got["steps"], ref["steps"])
    np.testing.assert_allclose(got["rows"], ref["rows"], rtol=ROLL_TOL,
                               atol=ROLL_TOL)


def test_replay_row_blocks_and_sample_exchange(world2):
    """A ring of 24 rows in blocks of 12 over 2 env ranks after 40 writes
    (it wraps): each rank's block is ``shard_replay`` of the one-process
    ring, and a sample, its rows exchanged by the all-reduce, is the
    one-process sample exactly."""
    for r, rank in enumerate(world2):
        o = _check(rank, "replay")
        assert o["lo"] == (12 * r, 12 * r)
        assert o["counters"] == (40 % 24, 24)
        np.testing.assert_array_equal(o["block"], o["cut"])
        assert set(o["sample"]) == set(o["one"])
        for k, v in o["one"].items():
            np.testing.assert_array_equal(o["sample"][k], v)


def test_trainer_full_mesh_training(world4, one):
    """ETGRLTrainer on a 2×2 mesh (env data parallelism × column-parallel
    MLPs): a warm-up chunk, a learn chunk and an ES phase, held to the same
    training without a mesh."""
    runs, ref = [_check(r, "train") for r in world4], one["train"]
    for o in runs:
        assert o["finite"]
        assert o["local_q"] == (12, W.TRAIN_B // 2)       # env columns
        assert o["local_w0"] == (128, 49)                  # model rows
        assert o["tp_layers"] == 4
        assert o["replay_rows"][0] == 1024                 # row block
        assert o["replay_size"] == ref["replay_size"]
        for part in ("actor", "critic", "target"):
            assert _max_diff(o[part], runs[0][part]) == 0.0, part
    for part in ("actor", "critic", "target"):
        err = _max_diff(runs[0][part], ref[part])
        move = _max_diff(ref[part], ref["init"][part])
        assert err <= TRAIN_TOL, (part, err)
        assert err <= MOVE_RTOL * move, (part, err, move)
    np.testing.assert_allclose(runs[0]["etg_param"], ref["etg_param"],
                               atol=TRAIN_TOL)
    # the logged losses (rank 0's) are the global batch's
    got, want = runs[0]["losses"], ref["losses"]
    assert [g[:2] for g in got] == [w[:2] for w in want] and want
    for (tag, step, g), (_, _, w) in zip(got, want):
        assert abs(g - w) <= LEARN_TOL * max(1.0, abs(w)), (tag, step, g, w)


def test_bc_distillation_on_mesh(world2, one):
    got, ref = _check(world2[0], "bc"), one["bc"]
    for k in ("student", "expert"):
        assert _max_diff(got[k], ref[k]) <= ROLL_TOL, k
    for k, v in ref["losses"].items():
        assert abs(got["losses"][k] - v) <= LEARN_TOL * max(1.0, abs(v)), k
    assert _max_diff(got["actor"], ref["actor"]) <= LEARN_TOL
    assert _max_diff(got["eval"], ref["eval"]) <= LEARN_TOL * max(
        1.0, np.abs(ref["eval"]).max())


def test_dynamics_id_generation_on_mesh(world2, one):
    got, ref = _check(world2[0], "dynamics_id"), one["dynamics_id"]
    assert got["fitness"].shape == (W.DYN_P,)
    np.testing.assert_allclose(got["fitness"], ref["fitness"],
                               rtol=LEARN_TOL, atol=LEARN_TOL)
    np.testing.assert_allclose(got["best"], ref["best"], atol=LEARN_TOL)


def test_checkpoint_roundtrip_of_sharded_carry(world4):
    """A 2×2 state (column-parallel actor and critics, Adam moments after a
    data-parallel step) saved by rank 0 in the one-process layout restores
    in one process, and a one-process state restores onto the mesh."""
    for r in world4:
        o = _check(r, "checkpoint")
        assert _max_diff(o["saved_actor"], o["restored_actor"]) == 0.0
        assert _max_diff(o["saved_critic_m"], o["restored_critic_m"]) == 0.0
        assert _max_diff(o["src_actor"], o["back_actor"]) == 0.0
        assert _max_diff(o["src_critic_m"], o["back_critic_m"]) == 0.0
        assert o["local_w0"] == (128, 49) and o["local_m0"] == (128, 61)
        assert o["saved_actor"]["dense.0.weight"].shape == (256, 49)


def test_dryrun_over_2x1_and_1x2(world2):
    for r in world2:
        errs = _check(r, "dryrun")
        assert set(errs) == {"2x1", "1x2"}
        assert max(errs.values()) <= TRAIN_TOL, errs


def _assert_adam_weights(got, ref, steps):
    """Weights after ``steps`` Adam steps of lr 1e-4 on gradients that
    agree to float rounding: at most 1e-3 of the entries more than 1e-6
    apart, none more than 2·lr per step (an entry whose gradient is ~0, as
    ``wae_proj.bias``'s, which the softmax cancels, steps ±lr either way;
    test_torch_hri_train.py holds the port to JAX by the same rule)."""
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert (d > 1e-6).mean() <= 1e-3, (d > 1e-6).sum()
    assert d.max() <= 2 * HRI_LR * steps * 1.001, d.max()


def test_hri_train_step_on_two_ranks(world2, one):
    """AttentionTrainer on a 2×1 mesh: each rank trains on its rows, the
    gradients all-reduced; three steps against one process: losses and Adam
    moments to float rounding, weights by ``_assert_adam_weights``."""
    got, ref = [_check(r, "hri_train") for r in world2], one["hri_train"]
    assert [g["rows"] for g in got] == [W.HRI_B // 2] * 2
    assert ref["rows"] == W.HRI_B
    assert _max_diff(got[0]["model"], got[1]["model"]) == 0.0
    _assert_adam_weights(got[0]["model"], ref["model"], W.HRI_STEPS)
    scale = max(np.abs(m).max() for m in ref["moments"].values())
    assert _max_diff(got[0]["moments"], ref["moments"]) <= LEARN_TOL * scale
    for g, o in zip(got[0]["aux"], ref["aux"]):
        for k, v in o.items():
            assert abs(g[k] - v) <= LEARN_TOL * max(1.0, abs(v)), k


def test_train_attention_cli_distributed(world2, one, tmp_path):
    """``cli/train_attention --distributed 1`` joined by the ranks of a
    process group: rank 0 writes the checkpoint, the one-process CLI's by
    ``_assert_adam_weights``; on the CPU without a group the ranks must be
    counted."""
    got = _check(world2[0], "attention_cli")
    assert {"itr_2.pt", "metrics.jsonl"} <= set(got["files"])
    _assert_adam_weights(got["model"], one["attention_cli"], 2)
    with pytest.raises(SystemExit, match="gloo ranks' count"):
        train_attention.main(W.ATTN_CLI + ["--outdir", str(tmp_path),
                                           "--distributed", "1"])


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_quadruped_cli_mesh_on_cpu(tmp_path):
    """``--mesh 2x1 --device cpu`` started plainly: the CLI starts its own
    two gloo ranks; rank 0 alone writes the metrics, which match the run
    without a mesh. A mesh larger than the cards is refused."""
    argv = ["--device", "cpu", "--num_envs", "8", "--task_mode", "ground",
            "--max_steps", "160", "--chunk_steps", "10", "--warmup_steps",
            "80", "--popsize", "4", "--ES_every", "10000", "--outdir",
            str(tmp_path)]
    with ThreadPoolExecutor(1) as ex:
        mesh = ex.submit(train_quadruped.main,
                         argv + ["--suffix", "mesh", "--mesh", "2x1"],
                         DEADLINE_S)
        train_quadruped.main(argv + ["--suffix", "one"])
        mesh.result()
    got = _metrics(tmp_path / "mesh" / "metrics.jsonl")
    ref = _metrics(tmp_path / "one" / "metrics.jsonl")
    assert [(m["tag"], m["step"]) for m in got] == \
        [(m["tag"], m["step"]) for m in ref]
    assert "train/critic_loss" in {m["tag"] for m in got}
    for g, o in zip(got, ref):
        assert abs(g["value"] - o["value"]) <= LEARN_TOL * max(
            1.0, abs(o["value"])), g["tag"]
    with pytest.raises(SystemExit, match=r"needs 2 card\(s\)"):
        train_quadruped.main(argv + ["--device", "cuda", "--mesh", "2x1"])
