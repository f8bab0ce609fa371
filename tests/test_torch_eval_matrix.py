"""Port parity of the task-matrix CLI and the deployment loop.

``build_task_config`` gives, field by field, the JAX package's config for
every task mode (presets and the plain ones). ``run_task`` trains,
checkpoints (``itr_<step>.pt``), restores and evaluates on the CPU
(following tests/test_eval_matrix.py); the restored deterministic eval
reproduces the trained one exactly, and ``cli.bc_train`` distils that
checkpoint into a student. ``to_markdown`` gives the JAX text,
and ``main`` records a task that fails as an error row. ``run_control_loop``
through ``SimRobotIO`` (B=1, 5 ticks, the exported policy of an actor
converted from flax) logs the JAX loop's observations and targets to 1e-4,
the env's per-step tolerance (test_torch_env).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.algos.sac import SAC as JSAC
from paddlerobotics_tpu.cli import eval_matrix as jeval_matrix
from paddlerobotics_tpu.core.config import QuadrupedConfig as JConfig
from paddlerobotics_tpu.deploy import policy_export as jexport
from paddlerobotics_tpu.deploy import realtime as jrealtime
from paddlerobotics_tpu.envs.batched_env import BatchedQuadrupedEnv as JEnv
from paddlerobotics_tpu.etg import fit as jfit
from paddlerobotics_tpu.sim.terrain import TASK_MODES

from paddlerobotics_torch import convert
from paddlerobotics_torch.cli import bc_train, eval_matrix
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.deploy import policy_export, realtime
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

TINY = dict(num_envs=8, warmup_steps=40, updates_per_step=1)
ENV_ATOL = 1e-4


@pytest.mark.parametrize("mode", TASK_MODES)
def test_build_task_config_matches_jax(mode):
    for kw in ({}, {"overrides": TINY, "eval_steps": 10,
                    "use_pallas": False}):
        ours = eval_matrix.build_task_config(mode, **kw)
        theirs = jeval_matrix.build_task_config(mode, **kw)
        assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
        assert ours[1:] == theirs[1:]


def test_train_checkpoint_restore_eval_round_trip(tmp_path):
    root = str(tmp_path)
    row = eval_matrix.run_task("ground", root, train=True, budget=8 * 30,
                               eval_steps=10, overrides=TINY, device="cpu")
    assert row["task"] == "ground" and row["schedule"] == "B=8/K=1"
    assert "train_velx" in row and "eval_velx" in row
    assert os.listdir(os.path.join(root, "ground")).count("itr_240.pt") == 1
    row2 = eval_matrix.run_task("ground", root, train=False, budget=0,
                                eval_steps=10, overrides=TINY, device="cpu")
    for k in ("eval_velx", "eval_success", "eval_return", "eval_steps"):
        assert row2[k] == row[k], k
    # the BC CLI restores the matrix expert and refits its gait
    out = tmp_path / "bc"
    bc = bc_train.main(["--expert_dir", os.path.join(root, "ground"),
                        "--num_envs", "64", "--bc_steps", "1024",
                        "--distill_epochs", "1", "--final_epochs", "1",
                        "--eval_steps", "5", "--outdir", str(out),
                        "--device", "cpu"])
    with open(out / "bc_result.json") as f:
        assert json.load(f) == bc
    assert np.isfinite(bc["actor_loss"]) and bc["expert_steps"] <= 5
    assert (out / "itr_1024.pt").exists()


def test_markdown_and_main_error_rows(tmp_path):
    rows = [{"task": "ground", "schedule": "B=8/K=1", "eval_velx": 1.0,
             "eval_success": 0.99, "eval_steps": 600},
            {"task": "broken", "error": "x"}]
    assert eval_matrix.to_markdown(rows) == jeval_matrix.to_markdown(rows)
    # no checkpoint under the root: the task is an error row, not a crash
    out = eval_matrix.main(["--root", str(tmp_path), "--tasks", "up_slope",
                            "--device", "cpu"])
    assert out[0]["task"] == "up_slope" and "FileNotFoundError" in \
        out[0]["error"]
    with open(tmp_path / "matrix.json") as f:
        assert json.load(f) == out


def test_control_loop_matches_jax():
    jcfg = JConfig()
    jcfg = dataclasses.replace(jcfg, etg=dataclasses.replace(jcfg.etg,
                                                             step_y=0.0))
    cfg = QuadrupedConfig()
    cfg = dataclasses.replace(cfg, etg=dataclasses.replace(cfg.etg,
                                                           step_y=0.0))
    table = np.array(jexport.export_gait_table(
        JConfig(), *jfit.opt_with_points(JConfig().etg), 8))
    sac_j = JSAC(49, 12, jcfg.sac)
    st = sac_j.init(jax.random.key(0))
    bound = np.full(12, 0.3, np.float32)
    pol_j = jexport.export_policy_fn(sac_j, st, table, bound)
    actor = convert.actor_from_flax(jax.tree.map(np.asarray,
                                                 st.actor_params),
                                    device="cpu")
    pol_t = policy_export.export_policy_fn(actor, table, bound, device="cpu")
    obs_j, act_j = jrealtime.run_control_loop(
        pol_j, jrealtime.SimRobotIO(JEnv(jcfg, 1)), dt=0.001,
        max_time=0.0055)
    io = realtime.SimRobotIO(BatchedQuadrupedEnv(cfg, 1, device="cpu"))
    obs_t, act_t = realtime.run_control_loop(pol_t, io, dt=0.001,
                                             max_time=0.0055)
    assert obs_t.shape == (5, 49) and act_t.shape == (5, 12)
    np.testing.assert_allclose(obs_t, obs_j, atol=ENV_ATOL, rtol=ENV_ATOL)
    np.testing.assert_allclose(act_t, act_j, atol=ENV_ATOL, rtol=ENV_ATOL)
    assert torch.is_tensor(io.read_state()["obs"])
