"""Each cell's run on the CPU at a small batch, with the harness's look for
a card skipped: sound it is correct; with the timed path broken underneath
(a step that leaves its state unchanged, an answer altered where it is
produced, half of the batch left out) it is not; and the control, the
reference in TF32 in the program's place, is judged not correct by the
same check."""

import json

import pytest
import torch

from benchmark import harness, manifest, run

ROLLOUT = ["a1_etg_flat.rollout_b4096", "a1_etg_dr.rollout_b4096"]
TRAIN = "a1_etg_flat.train_b4096_k4"
DEPLOY = "a1_etg_flat.deploy_b1_38hz"


def with_pending():
    """``BENCHMARK.json`` with the entries of the cells under ``pending/``,
    whose files are all in the folder."""
    bench = manifest.load()
    for path in sorted((manifest.HERE / "pending").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            bench[key] += entries
    return bench


def small(name):
    """The cell cut to what a test run holds: a few envs, a short gait
    table and replay, samples among the first steps."""
    cell = manifest.cell(name, with_pending())
    t = dict(cell.traffic)
    if t["driver"] == "rollout":
        t.update(num_envs=6, warmup_steps=1, trace_steps=1)
        cell.check = dict(cell.check, sample_below=2, samples=1)
    elif t["driver"] == "deploy":
        t.update(gait_steps=20, warmup_ticks=1, trace_ticks=1)
        cell.check = dict(cell.check, sample_below=2, samples=1)
    else:
        t.update(num_envs=6, warmup_env_steps=12, chunk_steps=1,
                 trace_steps=1)
        cell.check = dict(cell.check, sample_below=2, samples=1)
        cell.config = dict(cell.config, quadruped={
            **cell.config["quadruped"],
            "sac": {"memory_size": 512, "batch_size": 16}})
    cell.traffic = t
    return cell


def _run(name, stand_ins=(), seconds=0.1):
    return run.run_cell(small(name), 2 ** 31 + 7, seconds, False,
                        device="cpu", stand_ins=stand_ins)


@pytest.mark.parametrize("name", ROLLOUT + [TRAIN, DEPLOY])
def test_sound_run_is_correct(name):
    line, rr = _run(name)
    assert line["correct"], line["checks"]
    assert all(v["value"] == 0.0 for v in line["checks"].values())
    assert rr.attempted >= 1 and line["failed"] == 0


def _unchanged_state(monkeypatch):
    from paddlerobotics_torch.ops import physics_step

    monkeypatch.setattr(physics_step, "control_step",
                        lambda rb, *a, **k: rb)


def _altered_physics(monkeypatch):
    from paddlerobotics_torch.ops import physics_step

    real = physics_step.control_step

    def altered(*a, **k):
        rb = real(*a, **k)
        q = rb.s.q.clone()
        q[0, 0] += 0.05
        return rb.replace(s=rb.s.replace(q=q))

    monkeypatch.setattr(physics_step, "control_step", altered)


def _altered_action(monkeypatch):
    from paddlerobotics_torch.algos import sac

    real = sac.predict
    monkeypatch.setattr(sac, "predict", lambda *a: real(*a) + 0.05)


FAULTS = {"unchanged_state": _unchanged_state,
          "altered_physics": _altered_physics}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["altered_action"])
@pytest.mark.parametrize("name", ROLLOUT)
def test_rollout_fault_is_not_correct(name, fault, monkeypatch):
    {**FAULTS, "altered_action": _altered_action}[fault](monkeypatch)
    line, rr = _run(name)
    assert not line["correct"] and line["failed"] >= 1, line["checks"]


def _altered_target(monkeypatch):
    from paddlerobotics_torch.deploy import policy_export

    real = policy_export.DeployPolicy.forward
    monkeypatch.setattr(policy_export.DeployPolicy, "forward",
                        lambda self, obs, i: real(self, obs, i) + 0.05)


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["altered_target"])
def test_deploy_fault_is_not_correct(fault, monkeypatch):
    {**FAULTS, "altered_target": _altered_target}[fault](monkeypatch)
    line, _ = _run(DEPLOY)
    assert not line["correct"], line["checks"]


def _frozen_learner(monkeypatch):
    from paddlerobotics_torch.algos import sac

    def frozen(self, state, batch, *a, **k):
        z = torch.zeros(())
        return {"critic_loss": z, "actor_loss": z}

    monkeypatch.setattr(sac.SAC, "learn", frozen)


def _half_batch(monkeypatch):
    from paddlerobotics_torch.algos import sac

    real = sac.SAC.learn

    def half(self, state, batch, *a, **k):
        n = batch["obs"].shape[0] // 2
        k.pop("noise", None)
        return real(self, state, {f: v[:n] for f, v in batch.items()},
                    *a, **k)

    monkeypatch.setattr(sac.SAC, "learn", half)


def _altered_reward(monkeypatch):
    from paddlerobotics_torch.envs import batched_env

    real = batched_env.BatchedQuadrupedEnv.step

    def altered(self, *a, **k):
        out = list(real(self, *a, **k))
        out[2] = out[2].clone()
        out[2][0] += 1.0
        return tuple(out)

    monkeypatch.setattr(batched_env.BatchedQuadrupedEnv, "step", altered)


@pytest.mark.parametrize("fault", ["frozen_learner", "half_batch",
                                   "altered_reward", "unchanged_state"])
def test_train_fault_is_not_correct(fault, monkeypatch):
    {"frozen_learner": _frozen_learner, "half_batch": _half_batch,
     "altered_reward": _altered_reward,
     "unchanged_state": _unchanged_state}[fault](monkeypatch)
    line, _ = _run(TRAIN)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ROLLOUT + [TRAIN, DEPLOY])
def test_control_reads_over_a_limit(name):
    """The reference in TF32, put in the program's place on the inputs the
    program had, comes out not correct by the cell's own check."""
    line, rr = _run(name, stand_ins=("control",))
    control = run.stand_in_line(line, rr, "control")
    assert not control["correct"], control["checks"]
    assert set(control["checks"]) == set(small(name).check["limits"])
    assert line["correct"]


def test_train_faults_planted_in_the_reference_read_over_a_limit():
    faults = ("fault:half_batch", "fault:altered_reward")
    line, rr = _run(TRAIN, stand_ins=faults)
    for v in faults:
        assert not run.stand_in_line(line, rr, v)["correct"], v
    half = rr.stand_ins["fault:half_batch"]
    assert half.values["window_loss_gap"] > half.limits["window_loss_gap"]
    assert line["correct"]


@pytest.mark.parametrize("name", ROLLOUT + [TRAIN, DEPLOY])
def test_a_traced_run_keeps_the_window_spans_only(name):
    """The profiler's steps after the window add nothing to the window's
    spans: each span has one call per step or tick timed."""
    line, rr = run.run_cell(small(name), 2 ** 31 + 17, 0.1, True,
                            device="cpu")
    assert line["correct"] and rr.trace["steps"] >= 1
    per_step = {"rollout": ("policy", "env.step"), "train": ("env.step",),
                "deploy": ("sleep", "policy", "env.step", "obs.to_host")}
    for span in per_step[small(name).traffic["driver"]]:
        assert len(rr.spans[span]) == rr.steps, span
    if name == DEPLOY:     # every reader of the cell finds its number
        assert set(line["metrics"]) == {m["name"] for m in
                                         small(name).per_layer}


def test_deploy_tick_tool_splits_each_window_tick():
    """``tools/deploy_tick`` reads every part once per window tick, the
    parts add up to the tick, and it leaves the harness as it was."""
    from benchmark.tools import deploy_tick

    rec = deploy_tick.probe(small(DEPLOY), 2 ** 31 + 23, 0.1, device="cpu")
    assert rec["correct"] and rec["ticks"] >= 1
    p = rec["parts_ms"]
    assert sum(p[k]["mean"] for k in ("wake", "policy", "env_step",
                                      "to_host", "rest")) == \
        pytest.approx(p["tick"]["mean"])
    assert not harness.Spans().on
    assert harness.Pacer.wait.__name__ == "wait"
