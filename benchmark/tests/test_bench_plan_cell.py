"""The TD-MPC2 cell on the CPU, cut to a small size here (B=4, latent and
hidden widths 64, a 32-wide encoder, 32 samples, 8 elites, 4 policy
trajectories, 2 iterations, one warm-up and one traced step, the window's
first two steps compared): sound it is correct; the control, the reference in
TF32 in the program's place, reads over a limit; each of five faults
planted in the program reads over a limit; a traced run's four readers
return numbers. Env 0 starts every plan cold (its ``t0`` set, as after an
autoreset), so each compared plan holds an env that starts cold beside
envs that warm start."""

import types

import pytest
import torch

from benchmark import harness, manifest, run
from benchmark.reference import config as rconfig
from benchmark.reference import tdmpc2 as rtd
from benchmark.reference import tdmpc2_counts

NAME = "a1_tdmpc2_flat.mppi512_h3_b256"
SEED = 2 ** 31 + 11
SMALL = dict(enc_dim=32, mlp_dim=64, latent_dim=64, num_samples=32,
             num_elites=8, num_pi_trajs=4, iterations=2)


def small():
    cell = manifest.cell(NAME)
    cell.traffic = dict(cell.traffic, num_envs=4, warmup_steps=1,
                        trace_steps=1)
    cell.check = dict(cell.check, sample_below=2, samples=1)
    cell.config = dict(cell.config, tdmpc2=dict(cell.config["tdmpc2"],
                                                **SMALL))
    return cell


@pytest.fixture(autouse=True)
def forced_reset(monkeypatch):
    from paddlerobotics_torch.envs import wrappers

    real = wrappers.PlanRunner.step

    def step(self, state, donef=False):
        t0 = state.t0.clone()
        t0[0] = True
        return real(self, state._replace(t0=t0), donef)

    monkeypatch.setattr(wrappers.PlanRunner, "step", step)


def _run(stand_ins=(), trace=False, seed=SEED):
    return run.run_cell(small(), seed, 0.8, trace, device="cpu",
                        stand_ins=stand_ins)


def test_sound_run_is_correct_and_the_control_is_not():
    line, rr = _run(stand_ins=("control",))
    assert line["correct"], line["checks"]
    assert all(v["value"] <= 1e-6 for v in line["checks"].values()), \
        line["checks"]
    assert rr.attempted >= 2 and line["failed"] == 0
    assert rr.check.compared >= 2
    control = run.stand_in_line(line, rr, "control")
    assert not control["correct"], control["checks"]
    over = {k for k, v in control["checks"].items()
            if v["value"] > v["limit"]}
    assert {"encode_gap", "value_gap"} <= over, control["checks"]


def _terminal_q_left_out(monkeypatch):
    from paddlerobotics_torch.algos import tdmpc2

    monkeypatch.setattr(tdmpc2.WorldModel, "q_avg",
                        lambda self, z, a, pair: torch.zeros_like(z[:, :1]))


def _dynamics_without_simnorm(monkeypatch):
    from paddlerobotics_torch.algos import tdmpc2

    real = tdmpc2.WorldModel.__init__

    def init(self, cfg, device=None):
        real(self, cfg, device)
        self._dynamics[-1].act = "mish"

    monkeypatch.setattr(tdmpc2.WorldModel, "__init__", init)


def _warm_start_across_a_reset(monkeypatch):
    from paddlerobotics_torch.algos import tdmpc2

    real = tdmpc2.warm_start
    monkeypatch.setattr(tdmpc2, "warm_start",
                        lambda prev, t0: real(prev, t0 & False))


def _q_over_all_heads(monkeypatch):
    from paddlerobotics_torch.algos import tdmpc2

    def q_avg(self, z, a, pair):
        out = self._Qs(torch.cat([z, a], dim=-1))
        return self.two_hot_inv(out).mean(0)

    monkeypatch.setattr(tdmpc2.WorldModel, "q_avg", q_avg)


def _temperature_one(monkeypatch):
    from paddlerobotics_torch.algos import tdmpc2

    real = tdmpc2.refit
    monkeypatch.setattr(tdmpc2, "refit", lambda v, a, cfg: real(
        v, a, tdmpc2.dataclasses.replace(cfg, temperature=1.0)))


@pytest.mark.parametrize("fault,gap", [
    (_terminal_q_left_out, "value_gap"),
    (_dynamics_without_simnorm, "value_gap"),
    (_warm_start_across_a_reset, "warm_gap"),
    (_q_over_all_heads, "value_gap"),
    (_temperature_one, "refit_gap")],
    ids=["terminal_q_left_out", "dynamics_without_simnorm",
         "warm_start_across_a_reset", "q_over_all_heads", "temperature_one"])
def test_planted_fault_is_not_correct(fault, gap, monkeypatch):
    fault(monkeypatch)
    line, _ = _run()
    assert not line["correct"] and line["failed"] >= 1, line["checks"]
    assert line["checks"][gap]["value"] > line["checks"][gap]["limit"]


def test_a_traced_run_reads_the_program_spans_and_counters():
    """The traced step's spans and counters reach the readers: one plan,
    its two value estimates and refits, the runner's ``env.plan`` and its
    ``planner_resets`` count. The CPU launches no kernel: each span's
    device time is set here to stand for the card's, and one kernel of the
    row path is planted in the window, before the four readers read."""
    line, rr = _run(trace=True, seed=SEED + 10)
    assert line["correct"], line["checks"]
    tr = rr.trace
    c = tr["counters"]
    assert c["plans"] == 1 and c["value_rollouts"] == 2
    assert "planner_resets" in c and "norm_launches" not in c
    sd = tr["span_device"]
    for name, n in (("policy.tdmpc2", 1), ("policy.tdmpc2.encode", 1),
                    ("policy.tdmpc2.pi_trajs", 1), ("policy.tdmpc2.value", 2),
                    ("policy.tdmpc2.refit", 2), ("policy.tdmpc2.select", 1),
                    ("env.plan", 1)):
        assert sd[name]["calls"] == n, name
    for x in sd.values():
        x["device_s"] = 1e-3 * x["calls"]
    tr["kernel_us"] = tr["kernel_us"] + [
        ("void prt_gn::row_norm_kernel<4, 0>(prt_gn::RowArgs)", 500.0)]
    cell = small()
    ctx = types.SimpleNamespace(result=rr, cell=cell, cfg=harness
                                .quadruped_config(rconfig.QuadrupedConfig,
                                                  cell.config["quadruped"]))
    got = {m["name"]: manifest.metric_reader(m["name"]).read(ctx)
           for m in cell.per_layer}
    assert set(got) == {"plan_device_ms.mppi", "world_model_roofline.mppi",
                        "norm_roofline.mppi", "step_mfu.mppi"}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["plan_device_ms.mppi"] == pytest.approx(1.0)
    d = cell.config["tdmpc2"]
    assert got["world_model_roofline.mppi"] == pytest.approx(
        100 * tdmpc2_counts.value_flops(d, 4) / 67e12 / 1e-3)
    assert got["norm_roofline.mppi"] == pytest.approx(
        100 * tdmpc2_counts.norm_bytes(d, 4) / 3.35e12 / 500e-6)


def test_the_cell_finds_its_driver_and_readers():
    cell = manifest.cell(NAME)
    assert cell.traffic["driver"] == "plan"
    assert hasattr(manifest.driver("plan"), "run")
    assert {m["name"] for m in cell.end_to_end} == {"env_steps_per_s",
                                                    "setup_s"}
    for m in cell.per_layer:
        assert callable(manifest.metric_reader(m["name"]).read)
    d = cell.config["tdmpc2"]
    assert all(d[k] == v for k, v in cell.config["widths"].items()
               if k != "parameters")
    assert cell.config["reduced"] == []


def test_counts_equal_the_reference_operations():
    """``tdmpc2_counts`` from the widths against the multiply-adds of every
    linear layer the reference's value estimate and whole plan run,
    counted from their shapes as they run; the published value estimate
    is 7,571,456 multiply-adds a sample and the plan's tails 128
    launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        macs = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (aten.addmm.default, aten.mm.default,
                        aten.bmm.default):
                a = args[1] if func is aten.addmm.default else args[0]
                Count.macs += out.numel() * a.shape[-1]
            return out

    d = dict(small().config["tdmpc2"])
    w = rtd.make_weights(d, torch.Generator().manual_seed(0))
    B, H, S, A = 3, d["horizon"], d["num_samples"], d["action_dim"]
    g = torch.Generator().manual_seed(1)
    z = torch.randn(B, d["latent_dim"], generator=g)
    actions = torch.rand(H, B, S, A, generator=g) * 2 - 1
    eps = torch.randn(B, S, A, generator=g)
    pair = torch.tensor([[0, 1], [2, 3], [4, 0]])
    Count.macs = 0
    with Count():
        rtd.estimate_value(w, z, actions, eps, pair, d)
    assert 2 * Count.macs == tdmpc2_counts.value_flops(d, B)
    from paddlerobotics_torch.algos.tdmpc2 import TDMPC2Config, TDMPC2Planner
    pl = TDMPC2Planner(TDMPC2Config(**d), device="cpu")
    noise = pl.draw_noise(B, g)
    obs = torch.randn(B, d["obs_dim"], generator=g)
    Count.macs = 0
    with Count():
        rtd.plan(w, obs, torch.ones(B, dtype=torch.bool),
                 torch.zeros(B, H, A), noise, d)
    assert 2 * Count.macs == tdmpc2_counts.plan_flops(d, B)
    full = manifest.cell(NAME).config["tdmpc2"]
    assert tdmpc2_counts.value_macs_per_sample(full) == 7_571_456
    assert len(tdmpc2_counts.norm_launches(full, 256)) == 128
