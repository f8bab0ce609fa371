"""The ETG-RL stack's entry points on the card, each with its physics
launches counted and its rollout held against the plain physics (every test
marked ``cuda``, skipped without one; run with ``python -m pytest
--noconftest -m cuda tests/test_torch_card_etgrl.py``).

Widths are the published ones; depth is cut as each test says. Each entry
point launches the physics kernel once per control step: the
deterministic-policy rollout at B=4096, the bench command's rollout in both
regimes (in process and as ``python -m ...cli.env_bench``), one step of
``graft_entry.entry()``, ``ETGRLTrainer.train`` through every phase, a
1×1 NCCL mesh, ``cli.train_bench``'s schedules, ETG pretraining, the task
matrix, gait export, the deployment loop, behaviour cloning, dynamics
identification, the A1 UDP bridge and the per-env env vmapped. Where a
path also runs through ``plain_physics()`` the two agree bit for bit, or
within the learner's or the atomics' rounding where the test says so.
"""

import contextlib
import dataclasses
import datetime
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddlerobotics_torch.algos import replay
from paddlerobotics_torch.algos.networks import Actor
from paddlerobotics_torch.algos.sac import SAC
from paddlerobotics_torch.cli import (bc_train, dynamics_id, env_bench,
                                      eval_matrix, export_gait, pretrain_etg,
                                      train_bench)
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.deploy import policy_export, realtime
from paddlerobotics_torch.envs import randomize
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.etg import fit
from paddlerobotics_torch.ops import physics_step
from paddlerobotics_torch.ops.kernel_time import device_ms
from paddlerobotics_torch.train import (bc_train as bc_mod, checkpoints,
                                        dynamics_id as dynid_mod, etg_rl,
                                        pretrain)
from torch_card import cuda, launched, plain_physics  # noqa: F401

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 4096
EVAL_STEPS = 200
BASE = QuadrupedConfig()
# the training path: depth cut, widths kept (QuadrupedConfig's defaults)
TRAIN_K = 4                             # updates per control step
TRAIN_CHUNK = 10                        # control steps per chunk
TRAIN_EPISODE = 100                     # eval and ES episode length
TRAIN_ES_GENS = 1                       # ES generations per ES phase
VS_PLAIN_STEPS = 5
# es_eval steps, kernel vs plain (each plain step costs ~0.4 s of host
# dispatch)
ES_VS_PLAIN_STEPS = 10
# es_eval's fitness is a segment sum by index_add_, whose float atomics
# add an ES candidate's envs in any order: kernel and plain runs may differ
# by that rounding alone (the replay rows it writes are compared exactly)
ES_FIT_RTOL = 1e-5
# kernel vs plain physics after VS_PLAIN_STEPS warm steps: the kernel is
# bit-equal to its plain version, so the weights may differ only by the
# learner's own run-to-run rounding
TRAIN_PARAM_TOL = 1e-4
# the trained actor on a one-rank NCCL mesh against the run without a mesh,
# from the same seeds. On one rank every collective is a copy and the
# learner's share of the batch is all of it, so the two runs compute the
# same floats (0.0 read on the card); the bound is the learner's
# run-to-run rounding that TRAIN_PARAM_TOL allows
MESH_ACTOR_TOL = TRAIN_PARAM_TOL
PRETRAIN_ENVS = 4080                    # 102 envs per candidate of 40
PRETRAIN_GENS, PRETRAIN_STEPS = 2, 50   # defaults 100 x 400
PRETRAIN_VS_PLAIN_STEPS = 10
MATRIX_CHUNK = 50                       # run_task's chunk_steps
MATRIX_EVAL = 600                       # the reference's eval episode
MATRIX_RTOL = 1e-5                      # restored eval vs the trained one
GAIT_STEPS = 600
DEPLOY_TICKS = 100
DEPLOY_DT = 0.026                       # the reference's control period
BC_ENVS, BC_STEPS, BC_EVAL = 256, 4096, 100
BC_COLLECT = 1024 // BC_ENVS            # control steps of a collect phase
DYNID_POP, DYNID_T, DYNID_EPOCHS = 40, 100, 3
DYNID_VS_PLAIN_T = 10
UDP_BLEND = 100                         # run_exercise: blend commands
UDP_STEPS = 200                         # then the hip sinusoid
UDP_VS_PLAIN = 20                       # commands again, plain physics
PER_ENV_B = 64
PER_ENV_STEPS = 5
# the per-env env, card vs CPU: rtol and atol (the observation divides
# angles by 0.1, as in the CPU parity tests)
PER_ENV_CPU_TOL = 1e-4


# --- the rollout and the bench -------------------------------------------------

@pytest.fixture(scope="module")
def actor(cuda):
    env = BatchedQuadrupedEnv(BASE, B, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    actor = Actor(env.obs_dim, env.action_dim, BASE.sac.hidden_dim,
                  device=cuda, generator=gen)
    w0, b0 = fit.opt_with_points(BASE.etg, device=cuda)
    return env, actor, w0, b0, gen


def test_evaluate_launches_once_per_step(actor):
    """``etg_rl.evaluate`` at B=4096 for 200 steps: 200 launches, every
    observation and the return finite."""
    env, act, w0, b0, gen = actor
    finite, step = [], env.step

    def checked_step(*a, **k):
        out = step(*a, **k)
        finite.append(torch.isfinite(out[1]).all())
        return out

    env.step = checked_step
    try:
        etg_rl.evaluate(env, act, w0, b0, 2)        # warm-up
        finite.clear()
        (ret, _, _), launches = launched(lambda: etg_rl.evaluate(
            env, act, w0, b0, EVAL_STEPS, generator=gen))
    finally:
        env.step = step
    assert launches == EVAL_STEPS
    assert len(finite) == EVAL_STEPS and torch.stack(finite).all()
    assert np.isfinite(ret.item())


def test_evaluate_matches_plain(cuda, actor):
    """16 steps at B=512 through the kernel and the plain physics: the
    returns within 1e-3 (rounding only), the lengths equal."""
    _, act, w0, b0, _ = actor
    env_s = BatchedQuadrupedEnv(BASE, 512, device=cuda)
    r_k = etg_rl.evaluate(env_s, act, w0, b0, 16)
    with plain_physics():
        r_p = etg_rl.evaluate(env_s, act, w0, b0, 16)
    assert abs(r_k[0].item() - r_p[0].item()) <= 1e-3 * max(
        1.0, abs(r_p[0].item()))
    assert abs(r_k[1].item() - r_p[1].item()) <= 0.5


@pytest.mark.parametrize("regime,ring", [("no_dr", 2), ("dr_long_ring", 40)])
def test_bench_env_launches_once_per_step(cuda, regime, ring):
    """``cli.env_bench.bench_env``'s zero-action autoreset rollout at
    B=4096: one launch per control step of the warm-up and the timed
    reps."""
    r, launches = launched(lambda: env_bench.bench_env(regime, B, device=cuda))
    assert launches == r["steps"] * r["reps"] + r["steps"]
    assert r["ring_len"] == ring
    assert torch.isfinite(r["final"][1]).all()


def test_env_bench_cli_prints_its_four_lines(cuda):
    run = subprocess.run([sys.executable, "-m",
                          "paddlerobotics_torch.cli.env_bench",
                          "--regime", "both"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-2000:]
    lines = [json.loads(x) for x in run.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 4
    no_dr, dr, ratio, metric = lines
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = [x.strip() for x in card.rsplit(",", 1)]
    assert no_dr["ring_len"] == 2 and dr["ring_len"] == 40
    assert metric["metric"] == "a1_env_steps_per_sec_per_chip_4096envs"
    assert metric["value"] == no_dr["env_steps_per_s"] > 0
    assert metric["device"] == {"name": name, "power_limit": limit}
    assert "vs_baseline" not in metric
    assert ratio["dr_over_nodr"] > 0


def test_graft_entry_one_launch_bit_equal_to_plain(cuda):
    from paddlerobotics_torch import graft_entry

    fn, (st, actor, obs) = graft_entry.entry(256)

    def entry_step():
        rng = torch.Generator(device=cuda)
        rng.set_state(st.rng.get_state())
        return fn(st.replace(rng=rng), actor, obs)

    out_k, launches = launched(entry_step)
    with plain_physics():
        out_p = entry_step()
    assert launches == 1
    assert all(torch.equal(a, b) for a, b in zip(out_k, out_p))


# --- training ----------------------------------------------------------------------

def train_config():
    """``QuadrupedConfig()`` with depth alone cut: warm-up one chunk, the
    eval window after the second chunk, the ES phase after the third."""
    chunk_env = TRAIN_CHUNK * B
    return dataclasses.replace(
        BASE,
        sac=dataclasses.replace(BASE.sac, warmup_steps=chunk_env),
        es=dataclasses.replace(BASE.es, es_train_steps=TRAIN_ES_GENS,
                               es_episode_len=TRAIN_EPISODE,
                               es_every_steps=3 * chunk_env),
        train=dataclasses.replace(BASE.train, eval_every_steps=2 * chunk_env,
                                  eval_episode_len=TRAIN_EPISODE))


@pytest.fixture(scope="module")
def trained(cuda, tmp_path_factory):
    """``ETGRLTrainer.train`` at B=4096, K=4, full widths, 1M replay, through
    a cold chunk, two warm chunks, an eval window with its checkpoint and an
    ES phase on the 320 ES envs; per phase the calls, the control steps and
    the physics launches."""
    cfg = train_config()
    outdir = tmp_path_factory.mktemp("train")
    tr = etg_rl.ETGRLTrainer(cfg, num_envs=B, outdir=str(outdir),
                             updates_per_step=TRAIN_K, device=cuda)
    phases: dict = {}                   # [launches, control steps, calls]
    stack: list = []

    def recorded(obj, name, phase_of=None, steps_of=None):
        fn = getattr(obj, name)

        def run(*a, **k):
            stack.append(name)
            torch.cuda.synchronize()
            l0 = physics_step.control_step.launches
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                stack.pop()
            if phase_of is not None:
                ph = phases.setdefault(phase_of(a), [0, 0, 0])
                ph[0] += physics_step.control_step.launches - l0
                ph[1] += steps_of(a)
                ph[2] += 1
            return out
        setattr(obj, name, run)

    recorded(tr, "rollout_chunk", lambda a: "warm" if a[3] else "cold",
             lambda a: a[2])
    recorded(tr, "_es_baseline")
    recorded(tr, "evaluate",
             lambda a: "es" if "_es_baseline" in stack else "eval",
             lambda a: a[3])
    recorded(tr, "es_eval", lambda a: "es", lambda a: a[4])
    save = checkpoints.save
    recorded(checkpoints, "save", lambda a: "checkpoint", lambda a: 0)
    try:
        (carry, _), launches = launched(lambda: tr.train(
            max_steps=3 * TRAIN_CHUNK * B, chunk_steps=TRAIN_CHUNK))
    finally:
        checkpoints.save = save
    tags: dict = {}
    with open(outdir / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["value"])
    return cfg, tr.env.obs_dim, outdir, phases, launches, carry, tags


def test_train_runs_every_phase_one_launch_per_control_step(trained):
    _, _, _, phases, launches, _, _ = trained
    want = {"cold": (1, TRAIN_CHUNK), "warm": (2, 2 * TRAIN_CHUNK),
            "eval": (1, TRAIN_EPISODE), "checkpoint": (1, 0),
            "es": (1 + TRAIN_ES_GENS, (1 + TRAIN_ES_GENS) * TRAIN_EPISODE)}
    assert {n: (v[2], v[1]) for n, v in phases.items()} == want
    assert all(v[0] == v[1] for v in phases.values())
    assert launches == sum(v[1] for v in phases.values())


def test_train_outputs_are_finite_and_checkpointed(trained):
    cfg, obs_dim, outdir, _, _, carry, tags = trained
    critic_loss = tags["train/critic_loss"][-1]
    assert np.isfinite(critic_loss) and critic_loss != 0.0
    assert carry.buffer.size == (3 * TRAIN_CHUNK * B + TRAIN_ES_GENS
                                 * TRAIN_EPISODE * cfg.es.popsize)
    assert all(np.isfinite(tags[k][-1]) for k in (
        "eval/episode_reward", "ES/episode_reward", "ES/episode_maxre"))
    assert all(torch.isfinite(p).all()
               for p in carry.sac_state.actor.parameters())
    restored = checkpoints.restore(str(outdir / f"itr_{2 * TRAIN_CHUNK * B}"))
    assert restored["sac"]["actor"]["dense.0.weight"].shape == (
        cfg.sac.hidden_dim, obs_dim)


def test_warm_chunk_and_es_rollout_match_plain(cuda, tmp_path):
    """A 5-step warm chunk at B=4096, K=4: the first step's replay rows
    bit-equal, the weights within the learner's rounding; a 10-step
    ``es_eval`` on the 320 ES envs: replay rows and lengths bit-equal, the
    fitness within the atomics' rounding."""
    dev = cuda
    trv = etg_rl.ETGRLTrainer(BASE, num_envs=B, outdir=str(tmp_path),
                              updates_per_step=TRAIN_K, device=dev)
    P = BASE.es.popsize
    es_sols, _ = trv.solver.ask(trv.solver.init(
        torch.zeros(BASE.es.num_params, device=dev), device=dev),
        torch.Generator(device=dev).manual_seed(5))
    es_w, es_b = trv.fit_etg_population(es_sols)

    def chunk():
        c, _, _ = trv.init_carry(7)
        trv.rollout_chunk(c, BASE.train.e_step, VS_PLAIN_STEPS, True)
        return c

    def es_run(actor):
        es_buf = replay.create(ES_VS_PLAIN_STEPS * P, trv.env.obs_dim,
                               trv.env.action_dim, device=dev)
        es = trv.es_eval(actor, es_w, es_b,
                         torch.Generator(device=dev).manual_seed(9),
                         ES_VS_PLAIN_STEPS, P, es_buf)
        return es, es_buf

    ck, launches_k = launched(chunk)
    es_actor = ck.sac_state.actor           # both ES runs roll this policy
    (es_k, es_buf_k), launches_es = launched(lambda: es_run(es_actor))
    with plain_physics():
        cp = chunk()
        es_p, es_buf_p = es_run(es_actor)
    assert (launches_k, launches_es) == (VS_PLAIN_STEPS, ES_VS_PLAIN_STEPS)
    assert torch.equal(ck.buffer.data[:B], cp.buffer.data[:B])
    assert max((a - c).abs().max().item()
               for m_k, m_p in ((ck.sac_state.actor, cp.sac_state.actor),
                                (ck.sac_state.critic, cp.sac_state.critic))
               for a, c in zip(m_k.parameters(), m_p.parameters())
               ) <= TRAIN_PARAM_TOL
    assert torch.equal(es_buf_k.data, es_buf_p.data)
    assert torch.equal(es_k[1], es_p[1])
    assert (es_k[0] - es_p[0]).abs().max().item() <= ES_FIT_RTOL * max(
        1.0, es_p[0].abs().max().item())
    assert es_buf_k.size == ES_VS_PLAIN_STEPS * P
    assert torch.isfinite(es_k[0]).all()


def test_mesh_train_on_one_nccl_rank_matches_no_mesh(cuda, tmp_path):
    """``ETGRLTrainer(mesh=)`` over a 1×1 mesh of one NCCL rank (a
    ``FileStore``) at the training configuration, through ``train()``,
    beside the same run without a mesh from the same seeds: every
    collective of the mesh path on NCCL, one launch per control step in
    each, the actor and its checkpoint within MESH_ACTOR_TOL."""
    import torch.distributed as dist

    from paddlerobotics_torch.parallel import sharding

    cfg = train_config()
    steps = 3 * TRAIN_CHUNK + TRAIN_EPISODE + (1 + TRAIN_ES_GENS) * \
        TRAIN_EPISODE                            # the rank's control steps
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    runs = {}
    try:
        mesh = sharding.make_mesh(1, 1)
        for name, m in (("mesh", mesh), ("no_mesh", None)):
            tr = etg_rl.ETGRLTrainer(cfg, num_envs=B,
                                     outdir=str(tmp_path / name),
                                     updates_per_step=TRAIN_K, mesh=m,
                                     device=cuda)
            (carry, _), launches = launched(lambda: tr.train(
                max_steps=3 * TRAIN_CHUNK * B, chunk_steps=TRAIN_CHUNK))
            runs[name] = {
                "launches": launches,
                "actor": sharding.full_state_dict(carry.sac_state.actor),
                "replay": carry.buffer.size,
                "blocked": carry.buffer.blocked,
                "ckpt": checkpoints.restore(str(
                    tmp_path / name / f"itr_{2 * TRAIN_CHUNK * B}"))["sac"]}
            del carry, tr
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    a, b = runs["mesh"], runs["no_mesh"]
    diff = lambda x, y: max((x[k] - y[k]).abs().max().item() for k in x)
    assert backend == "nccl"
    assert a["launches"] == b["launches"] == steps
    assert a["blocked"] and a["replay"] == b["replay"]
    assert diff(a["actor"], b["actor"]) <= MESH_ACTOR_TOL
    assert diff(a["ckpt"]["actor"], b["ckpt"]["actor"]) <= MESH_ACTOR_TOL
    assert all(torch.isfinite(v).all() for v in a["actor"].values())


@pytest.mark.parametrize("tag,Bs,Ks", train_bench.SCHEDULES)
def test_train_bench_schedule_launches_the_physics_once_a_control_step(
        cuda, tmp_path, tag, Bs, Ks):
    """One control step of ``cli.train_bench``'s trainer for each schedule,
    under ``torch.profiler``: one physics kernel on the device."""
    trb = train_bench.make_trainer(Bs, Ks, str(tmp_path), device=cuda)
    c = trb.init_carry(0)[0]
    trb.rollout_chunk(c, 600, 1, True)
    assert device_ms(lambda: trb.rollout_chunk(c, 600, 1, True), 3,
                     "control_step_kernel")[1] == 1.0


# --- the rest of the stack -------------------------------------------------------

def test_pretrain_cli_launches_once_per_control_step(cuda, tmp_path,
                                                     monkeypatch):
    """``cli.pretrain_etg`` at popsize 40 on 4,080 envs, 2 generations of
    50 steps (defaults 100 × 400)."""
    orig = pretrain.ETGPretrainer.train
    monkeypatch.setattr(pretrain.ETGPretrainer, "train",
                        lambda self, **kw: orig(
                            self, episode_len=PRETRAIN_STEPS, **kw))
    (_, best_r), n = launched(lambda: pretrain_etg.main([
        "--popsize", str(BASE.es.popsize), "--num_envs", str(PRETRAIN_ENVS),
        "--generations", str(PRETRAIN_GENS), "--outdir",
        str(tmp_path / "pretrain"), "--save_path",
        str(tmp_path / "etg_pretrained.npz"), "--device", "cuda"]))
    assert n == PRETRAIN_GENS * PRETRAIN_STEPS
    assert np.isfinite(best_r)
    assert sorted(np.load(tmp_path / "etg_pretrained.npz").files) == [
        "b", "param", "w"]


def test_pretrain_fitness_matches_plain(cuda, tmp_path):
    """One 10-step generation's fitness, bit-equal and not constant."""
    pt = pretrain.ETGPretrainer(BASE, num_envs=PRETRAIN_ENVS,
                                outdir=str(tmp_path), device=cuda)
    sols, _ = pt.solver.ask(pt.solver.init(device=cuda),
                            torch.Generator(device=cuda).manual_seed(3))

    def population():
        return pt._rollout_population(
            sols, torch.Generator(device=cuda).manual_seed(4),
            PRETRAIN_VS_PLAIN_STEPS)

    fit_k, n = launched(population)
    with plain_physics():
        fit_p = population()
    assert n == PRETRAIN_VS_PLAIN_STEPS
    assert torch.equal(fit_k, fit_p)
    assert (fit_k.max() - fit_k.min()).item() > 0.0
    assert torch.isfinite(fit_k).all()


@pytest.fixture(scope="module")
def matrix(cuda, tmp_path_factory):
    """``eval_matrix.run_task("ground")`` at the preset's width (B=4096,
    K=4): train one cold and one warm chunk of 50 steps then the 600-step
    eval, and again restoring the checkpoint; the two evals, the launches
    of each, and the restored expert."""
    root = tmp_path_factory.mktemp("matrix")
    chunk = MATRIX_CHUNK * B
    over = {"warmup_steps": chunk, "num_envs": B}
    evals, orig_eval = [], etg_rl.ETGRLTrainer.evaluate

    def kept_eval(self, *a, **k):
        out = orig_eval(self, *a, **k)
        evals.append([float(out[0]), float(out[1]),
                      float(out[2]["velx"]), float(out[2]["success"])])
        return out

    etg_rl.ETGRLTrainer.evaluate = kept_eval
    try:
        _, n_tr = launched(lambda: eval_matrix.run_task(
            "ground", str(root), True, 2 * chunk, MATRIX_EVAL,
            overrides=over, device=cuda))
        _, n_ev = launched(lambda: eval_matrix.run_task(
            "ground", str(root), False, 0, MATRIX_EVAL, overrides=over,
            device=cuda))
    finally:
        etg_rl.ETGRLTrainer.evaluate = orig_eval
    cfg_m, _, _ = eval_matrix.build_task_config("ground", overrides=over)
    restored = checkpoints.restore(str(root / "ground" / f"itr_{2 * chunk}"),
                                   device=cuda)
    expert = SAC(BASE.sensors.base_obs_dim, 12, cfg_m.sac,
                 device=cuda).init(None)
    checkpoints.load_sac_state(expert, restored["sac"])
    return root, evals, n_tr, n_ev, cfg_m, expert


def test_eval_matrix_restored_eval_reproduces_the_trained_one(matrix):
    root, evals, n_tr, n_ev, _, _ = matrix
    assert (n_tr, n_ev) == (2 * MATRIX_CHUNK + MATRIX_EVAL, MATRIX_EVAL)
    assert all(abs(a - b) <= MATRIX_RTOL * max(1.0, abs(a))
               for a, b in zip(evals[0], evals[1]))
    assert np.isfinite(evals[0][0])
    assert checkpoints.latest_step(str(root / "ground")) == \
        2 * MATRIX_CHUNK * B


@pytest.fixture(scope="module")
def gait(cuda, tmp_path_factory):
    """``cli.export_gait``'s 600-row table (written and returned)."""
    out = tmp_path_factory.mktemp("gait")
    with contextlib.chdir(out):
        table = export_gait.main(["--steps", str(GAIT_STEPS), "--suffix",
                                  "card", "--device", "cuda"])
    return np.load(out / "gait_action_list_ETG_card.npy"), table


def test_export_gait_is_the_env_residual(cuda, gait):
    saved, table = gait
    env1 = BatchedQuadrupedEnv(BASE, 1, device=cuda)
    w0, b0 = fit.opt_with_points(BASE.etg, device=cuda)
    rows = [env1._etg_residual(w0[..., None], b0[:, None], torch.full(
        (1,), t, dtype=torch.int32, device=cuda))[0][:, 0].cpu().numpy()
        for t in range(GAIT_STEPS)]
    assert saved.shape == (GAIT_STEPS, 12)
    assert np.array_equal(np.stack(rows), saved)
    assert np.array_equal(saved, table)


def test_deploy_loop_matches_plain_and_the_exported_policy(cuda, matrix,
                                                           gait):
    """100 ticks at B=1 paced at 26 ms with the task matrix's expert and the
    exported gait: one launch per tick, the logs bit-equal through the plain
    physics, the ``torch.export`` policy equal to the eager one."""
    expert = matrix[5]
    saved = gait[0]
    env1 = BatchedQuadrupedEnv(BASE, 1, device=cuda)
    policy = policy_export.export_policy_fn(expert.actor, saved,
                                            env1.act_bound, device=cuda)
    sil = dataclasses.replace(BASE, etg=dataclasses.replace(BASE.etg,
                                                            step_y=0.0))

    def loop():
        io = realtime.SimRobotIO(BatchedQuadrupedEnv(sil, 1, device=cuda))
        return realtime.run_control_loop(
            policy, io, dt=DEPLOY_DT, max_time=(DEPLOY_TICKS + 0.5)
            * DEPLOY_DT)

    (obs_k, act_k), n = launched(loop)
    with plain_physics():
        obs_p, act_p = loop()
    aot = policy_export.aot_compile_policy(policy, BASE.sensors.base_obs_dim)
    obs_t = torch.as_tensor(obs_k, device=cuda)
    assert n == DEPLOY_TICKS and len(act_k) == DEPLOY_TICKS
    assert np.array_equal(obs_k, obs_p) and np.array_equal(act_k, act_p)
    assert np.isfinite(act_k).all()
    assert all(torch.equal(aot(obs_t[i], torch.tensor(i, device=cuda)),
                           policy(obs_t[i], i)) for i in range(DEPLOY_TICKS))


def test_bc_cli_on_the_matrix_expert(cuda, matrix, tmp_path):
    """``cli.bc_train`` at B=256, 4,096 BC steps (default 200,000) and
    evals of 100 steps (default 600): one launch per collect and eval
    step."""
    root = matrix[0]
    bc_row, n = launched(lambda: bc_train.main([
        "--expert_dir", str(root / "ground"), "--num_envs", str(BC_ENVS),
        "--bc_steps", str(BC_STEPS), "--eval_steps", str(BC_EVAL),
        "--outdir", str(tmp_path), "--device", "cuda"]))
    assert n == BC_STEPS // BC_ENVS + 2 * BC_EVAL
    assert all(np.isfinite(bc_row[k]) for k in (
        "actor_loss", "critic_loss", "ref_ratio"))
    assert (tmp_path / f"itr_{BC_STEPS}.pt").exists()


def test_bc_collect_matches_plain(cuda, matrix, tmp_path):
    """One collect phase (4 steps at B=256): the buffer rows bit-equal."""
    _, _, _, _, cfg_m, expert = matrix
    w_e, b_e = fit.opt_with_points(BASE.etg, device=cuda)
    bct = bc_mod.BCTrainer(cfg_m, expert, w_e, b_e, num_envs=BC_ENVS,
                           outdir=str(tmp_path), device=cuda)

    def collect():
        gen = torch.Generator(device=cuda).manual_seed(11)
        env_state, obs = bct.reset(gen)
        student = bct.bc.init(torch.Generator(device=cuda).manual_seed(12))
        buf = replay.bc_create(BC_COLLECT * BC_ENVS, bct.student_obs_dim,
                               bct.env.obs_dim, device=cuda)
        _, _, (s_obs, e_obs) = bct.collect(student, env_state, obs,
                                           BC_COLLECT, False, gen)
        replay.bc_add_batch(buf, s_obs, e_obs)
        return buf

    buf_k, n = launched(collect)
    with plain_physics():
        buf_p = collect()
    assert n == BC_COLLECT
    assert buf_k.size == BC_COLLECT * BC_ENVS
    assert torch.equal(buf_k.data, buf_p.data)


@pytest.fixture(scope="module")
def dynid_trace(cuda, gait, tmp_path_factory):
    """100 steps of the exported gait under a hidden dynamics draw, with
    joint and gyro noise, saved as the CLI's inputs."""
    out = tmp_path_factory.mktemp("dynid")
    dcfg = dataclasses.replace(BASE, sim=dataclasses.replace(
        BASE.sim, obs_latency_taps=BASE.sim.latency_buffer_len))
    env_h = BatchedQuadrupedEnv(dcfg, 1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    hidden = (torch.rand((randomize.NUM_DYNAMIC_PARAMS, 1), generator=gen,
                         device=cuda) * 2.0 - 1.0) * 0.5
    g = torch.as_tensor(gait[0][:DYNID_T], device=cuda)
    q, gyro = dynid_mod.generate_trace(env_h, g,
                                       randomize.param2dynamic(hidden), gen,
                                       noise_q=0.01, noise_gyro=0.05)
    files = {k: str(out / f"{k}.npy") for k in ("gait", "real_q",
                                                 "real_gyro")}
    for k, v in (("gait", g), ("real_q", q[:, 0]), ("real_gyro", gyro[:, 0])):
        np.save(files[k], v.cpu().numpy())
    return g, q, gyro, hidden, files, out


def test_dynamics_id_cli_beats_the_nominal_dynamics(dynid_trace):
    """``cli.dynamics_id`` at popsize 40, 3 epochs (default 50) of the
    100-step trace: one launch per step of each epoch; the identified
    dynamics' loss below the nominal's."""
    _, _, _, hidden, files, out = dynid_trace
    (ident, best), n = launched(lambda: dynamics_id.main([
        *[a for k, f in files.items() for a in (f"--{k}", f)],
        "--popsize", str(DYNID_POP), "--epochs", str(DYNID_EPOCHS),
        "--outdir", str(out / "run"), "--save",
        str(out / "dynamic_param.npy"), "--device", "cuda"]))
    l_id, l_nom, _ = ident.score(torch.stack(
        [best, torch.zeros_like(best), hidden[:, 0]])).tolist()
    assert n == DYNID_EPOCHS * DYNID_T
    assert np.isfinite(l_id) and l_id < l_nom


def test_dynamics_id_fitness_matches_plain(cuda, dynid_trace, tmp_path):
    """One 10-step ``_fitness`` of 40 candidates, each env its own
    dynamics: bit-equal through the plain physics."""
    g, q, gyro = dynid_trace[:3]
    short = dynid_mod.DynamicsIdentifier(
        BASE, g[:DYNID_VS_PLAIN_T], q[:DYNID_VS_PLAIN_T, 0],
        gyro[:DYNID_VS_PLAIN_T, 0], popsize=DYNID_POP,
        outdir=str(tmp_path), device=cuda)
    sols, _ = short.solver.ask(short.solver.init(device=cuda),
                               torch.Generator(device=cuda).manual_seed(6))

    def fitness():
        return short._fitness(sols, torch.Generator(device=cuda).manual_seed(7))

    fit_k, n = launched(fitness)
    with plain_physics():
        fit_p = fitness()
    assert n == DYNID_VS_PLAIN_T
    assert torch.equal(fit_k, fit_p)
    assert torch.isfinite(fit_k).all()


def test_udp_bridge_one_launch_per_command_and_plain_states(cuda):
    """``run_exercise`` over ``A1UdpClient`` → ``A1EmulatorServer``: 300
    non-zero commands, one launch each, the robot upright; the first 20
    commands again through the plain physics, the state packets
    bit-equal."""
    from paddlerobotics_torch.cli.robot_exercise import run_exercise
    from paddlerobotics_torch.deploy.udp_bridge import (A1EmulatorServer,
                                                        A1UdpClient)

    def recording(client, log):
        send = client.send_command

        def rec(cmd):
            st = send(cmd)
            log.append((np.array(cmd), st))
            return st

        client.send_command = rec
        return client

    server = A1EmulatorServer(device=cuda)
    sent = []
    client = recording(A1UdpClient(server.addr, timeout=30.0, device=cuda),
                       sent)
    physics_step.control_step.launches = 0
    try:
        rec = run_exercise(client, steps=UDP_STEPS, blend_steps=UDP_BLEND)
        launches = physics_step.control_step.launches
        server.check()
    finally:
        client.close()
        server.close()
    nonzero = sum(bool(np.any(c != 0)) for c, _ in sent)
    q = np.asarray(rec.rows["motor_angle"])
    rpy = np.asarray(rec.rows["rpy"])
    assert launches == nonzero == UDP_STEPS + UDP_BLEND
    assert np.abs(rpy[:, :2]).max() < 0.35 and np.isfinite(q).all()

    with plain_physics():
        server = A1EmulatorServer(device=cuda)
        again = []
        client = recording(A1UdpClient(server.addr, timeout=60.0,
                                       device=cuda), again)
        try:
            for cmd, _ in sent[:UDP_VS_PLAIN]:
                client.send_command(cmd)
            server.check()
        finally:
            client.close()
            server.close()
    assert len(again) == UDP_VS_PLAIN
    for (_, a), (_, b) in zip(sent, again):
        for k, v in a.items():
            assert np.array_equal(np.asarray(v, np.float64),
                                  np.asarray(b[k], np.float64)), k


def test_per_env_vmapped_matches_the_batched_env_and_the_cpu(cuda):
    """``make_env("Quadrupedal")`` vmapped at B=64 for 5 control steps
    against ``BatchedQuadrupedEnv`` through the kernel (5 launches) at the
    JAX tests' bounds, and against the same vmapped env on the CPU."""
    from torch.func import vmap

    from paddlerobotics_torch.envs import make_env

    env = make_env("Quadrupedal", device=cuda)
    env_cpu = make_env("Quadrupedal", device="cpu")
    benv = BatchedQuadrupedEnv(BASE, PER_ENV_B, device=cuda)
    g = torch.Generator(cuda)
    g.manual_seed(40)
    draws = env.sample_draws(g, (PER_ENV_B,))
    draws_cpu = type(draws)(*[x.cpu() for x in draws])
    step, step_cpu = vmap(env.step), vmap(env_cpu.step)
    ps, pobs = vmap(lambda d: env.reset(draws=d))(draws)
    cs, _ = vmap(lambda d: env_cpu.reset(draws=d))(draws_cpu)
    bs, bobs = benv.reset(g)
    err = {"obs_reset": (pobs - bobs).abs().max().item()}
    idx = torch.full((PER_ENV_B,), 5, dtype=torch.int32, device=cuda)
    err["etg_residual"] = (vmap(env._etg_residual)(ps.etg_w, ps.etg_b, idx)[0]
                           - benv._etg_residual(bs.etg_w, bs.etg_b, idx)[0].T
                           ).abs().max().item()
    rng = np.random.default_rng(41)
    actions = [torch.as_tensor(0.05 * rng.standard_normal((PER_ENV_B, 12)),
                               dtype=torch.float32, device=cuda)
               for _ in range(PER_ENV_STEPS)]
    physics_step.control_step.launches = 0
    for a in actions:
        ps, pobs, _, pdone, _ = step(ps, a)
        bs, _, _, bdone, _ = benv.step(bs, a)
        cs, cobs, _, _, _ = step_cpu(cs, a.cpu())
        torch.testing.assert_close(pobs.cpu(), cobs, rtol=PER_ENV_CPU_TOL,
                                   atol=PER_ENV_CPU_TOL)
    torch.cuda.synchronize()
    s = bs.robot.s
    err["q"] = (ps.robot.state.q - s.q.T).abs().max().item()
    err["pos"] = (ps.robot.state.base_pos - s.pos.T).abs().max().item()
    err["quat"] = (ps.robot.state.base_quat - s.quat.T).abs().max().item()
    bound = {"obs_reset": 2e-3, "etg_residual": 1e-4, "q": 2e-3,
             "pos": 5e-3, "quat": 2e-3}
    assert all(err[k] <= bound[k] for k in bound), err
    assert physics_step.control_step.launches == PER_ENV_STEPS
    assert max((getattr(ps.robot.state, f).cpu()
                - getattr(cs.robot.state, f)).abs().max().item()
               for f in ("q", "base_pos", "base_quat")) <= PER_ENV_CPU_TOL
    assert not pdone.any() and not bdone.any()
