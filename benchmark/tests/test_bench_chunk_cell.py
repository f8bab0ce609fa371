"""The Diffusion Policy cell on the CPU, cut to a small size here (B=6,
down_dims 16/32/64, a 16-wide step embedding, one warm-up and one traced
chunk, the compared chunk among the first): sound it is correct; the
control, the reference in TF32 in the program's place, reads over a limit;
each of four faults planted in the program reads over a limit; a traced
run's four readers return numbers. An env is forced to reset at step 2 of
every chunk (a ``donef``), so each compared chunk holds an env."""

import dataclasses
import types

import pytest
import torch

from benchmark import harness, manifest, program_trace, run
from benchmark.reference import config as rconfig
from benchmark.reference import diffusion_counts
from benchmark.reference import diffusion_policy as rdp

NAME = "a1_diffusion_unet_flat.chunk8_ddim10_b4096"
SEED = 2 ** 31 + 7


def small():
    cell = manifest.cell(NAME)
    cell.traffic = dict(cell.traffic, num_envs=6, warmup_chunks=1,
                        trace_chunks=1)
    cell.check = dict(cell.check, sample_below=2, samples=1)
    cell.config = dict(cell.config, diffusion=dict(
        cell.config["diffusion"], down_dims=[16, 32, 64], step_embed_dim=16))
    return cell


@pytest.fixture(autouse=True)
def forced_reset(monkeypatch):
    from paddlerobotics_torch.envs import wrappers

    real = wrappers.ChunkRunner.step

    def step(self, state, donef=False):
        if state.k == 2:
            donef = torch.arange(state.held.shape[0],
                                 device=state.held.device) == 0
        return real(self, state, donef)

    monkeypatch.setattr(wrappers.ChunkRunner, "step", step)


def _run(stand_ins=(), trace=False, seed=SEED):
    return run.run_cell(small(), seed, 0.1, trace, device="cpu",
                        stand_ins=stand_ins)


def test_sound_run_is_correct_and_the_control_is_not():
    line, rr = _run(stand_ins=("control",))
    assert line["correct"], line["checks"]
    assert all(v["value"] == 0.0 for v in line["checks"].values())
    assert rr.attempted >= 1 and line["failed"] == 0
    assert rr.steps == rr.attempted * 8
    control = run.stand_in_line(line, rr, "control")
    assert not control["correct"], control["checks"]
    over = {k for k, v in control["checks"].items()
            if v["value"] > v["limit"]}
    assert {"eps_gap", "chunk_gap"} <= over, control["checks"]


def _nine_ddim_steps(monkeypatch):
    from paddlerobotics_torch.algos import diffusion_policy as dp

    real = dp.ddim_schedule
    monkeypatch.setattr(dp, "ddim_schedule", lambda cfg: real(
        dataclasses.replace(cfg, num_inference_steps=9)))


def _film_without_scale(monkeypatch):
    from paddlerobotics_torch.algos import diffusion_policy as dp

    def forward(self, x, cond):
        h = self.blocks[0](x)
        embed = self.cond_encoder(cond).reshape(-1, 2, self.out_channels, 1)
        h = self.blocks[1](h + embed[:, 1])
        return h + self.residual_conv(x)

    monkeypatch.setattr(dp.ConditionalResidualBlock1D, "forward", forward)


def _old_chunk_after_reset(monkeypatch):
    from paddlerobotics_torch.envs import wrappers

    real = wrappers.select_action
    monkeypatch.setattr(wrappers, "select_action",
                        lambda plan, held, *a: real(plan, held & False, *a))


def _zero_padded_history(monkeypatch):
    from paddlerobotics_torch.envs import wrappers

    def next_history(history, obs, done):
        shifted = torch.cat([history[:, 1:], obs[:, None]], dim=1)
        fresh = torch.zeros_like(history)
        fresh[:, -1] = obs
        return torch.where(done[:, None, None], fresh, shifted)

    monkeypatch.setattr(wrappers, "next_history", next_history)


@pytest.mark.parametrize("fault,gap", [
    (_nine_ddim_steps, "chunk_gap"), (_film_without_scale, "eps_gap"),
    (_old_chunk_after_reset, "select_gap"),
    (_zero_padded_history, "select_gap")],
    ids=["nine_ddim_steps", "film_without_scale", "old_chunk_after_reset",
         "zero_padded_history"])
def test_planted_fault_is_not_correct(fault, gap, monkeypatch):
    fault(monkeypatch)
    line, _ = _run()
    assert not line["correct"] and line["failed"] >= 1, line["checks"]
    assert line["checks"][gap]["value"] > line["checks"][gap]["limit"]


def test_a_traced_run_reads_the_program_spans_and_counters():
    """The traced chunk's spans and counters reach the readers: one replan,
    ten U-Net calls, two ``env.chunk`` spans a step. The CPU launches no
    kernel, so each span's device time is set here to stand for the card's
    before the four readers read it."""
    line, rr = _run(trace=True, seed=SEED + 10)
    assert line["correct"], line["checks"]
    tr = rr.trace
    c = tr["counters"]
    assert c["replans"] == 1 and c["unet_calls"] == 10
    assert c["mid_chunk_resets"] >= 1 and c["held_env_steps"] >= 5
    sd = tr["span_device"]
    assert sd["policy.diffusion"]["calls"] == 1
    assert sd["policy.diffusion.unet"]["calls"] == 10
    assert sd["env.chunk"]["calls"] == 16
    assert len(tr["program_ms"]["policy.diffusion.ddim"]) == 10
    for x in sd.values():
        x["device_s"] = 1e-3 * x["calls"]
    cell = small()
    ctx = types.SimpleNamespace(result=rr, cell=cell, cfg=harness
                                .quadruped_config(rconfig.QuadrupedConfig,
                                                  cell.config["quadruped"]))
    got = {m["name"]: manifest.metric_reader(m["name"]).read(ctx)
           for m in cell.per_layer}
    assert set(got) == {"unet_roofline.chunk", "replan_device_ms.chunk",
                        "device_idle.chunk", "step_mfu.chunk"}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["replan_device_ms.chunk"] == pytest.approx(1.0)
    d = cell.config["diffusion"]
    assert got["unet_roofline.chunk"] == pytest.approx(
        100 * diffusion_counts.unet_flops(d, 6) / 67e12 / 1e-3)


def test_the_cell_finds_its_driver_and_readers():
    cell = manifest.cell(NAME)
    assert cell.traffic["driver"] == "chunk"
    assert hasattr(manifest.driver("chunk"), "run")
    assert {m["name"] for m in cell.end_to_end} == {"env_steps_per_s",
                                                    "setup_s"}
    for m in cell.per_layer:
        assert callable(manifest.metric_reader(m["name"]).read)
    d = cell.config["diffusion"]
    assert d["down_dims"] == cell.config["widths"]["down_dims"]
    assert cell.config["reduced"] == []


def test_unet_count_equals_the_reference_operations():
    """``diffusion_counts`` from the widths against the multiply-adds of
    every convolution and linear the reference runs, counted from their
    shapes as they run (a transposed convolution: each input element
    times its output channels and taps)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        macs = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.convolution.default:
                x, w = args[0], args[1]
                if args[6]:                       # transposed
                    Count.macs += x.numel() * w.shape[1] * w.shape[2]
                else:
                    Count.macs += out.numel() * w.shape[1] * w.shape[2]
            elif func is aten.addmm.default:
                Count.macs += out.numel() * args[1].shape[1]
            return out

    for dims, e in (([16, 32, 64], 16), ([24, 48], 32)):
        d = dict(small().config["diffusion"], down_dims=dims,
                 step_embed_dim=e)
        p = rdp.make_weights(d, torch.Generator().manual_seed(0))
        B = 3
        x = torch.randn(B, d["horizon"], d["action_dim"])
        cond = torch.randn(B, d["n_obs_steps"] * d["obs_dim"])
        Count.macs = 0
        with Count():
            rdp.unet(p, x, torch.full((B,), 50.0), cond, d)
        assert Count.macs == B * diffusion_counts.unet_macs_per_env(d)
    full = manifest.cell(NAME).config["diffusion"]
    assert diffusion_counts.unet_macs_per_env(full) == 296_398_848


def test_span_device_counts_each_kernel_once_by_its_launch():
    """Kernels are matched to the span around their launch through the
    correlation id, nested ranges of one name count a kernel once, and a
    kernel launched outside the span is not its."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": args}

    ev = [x("bench.window", "user_annotation", 0, 100),
          x("a", "user_annotation", 10, 30), x("a", "user_annotation", 12, 5),
          x("b", "user_annotation", 50, 10),
          x("cudaLaunchKernel", "cuda_runtime", 13, 1, correlation=1),
          x("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2),
          x("cudaLaunchKernel", "cuda_runtime", 45, 1, correlation=3),
          x("k1", "kernel", 20, 4, correlation=1),
          x("k2", "kernel", 60, 6, correlation=2),
          x("k3", "kernel", 70, 8, correlation=3)]
    got = program_trace.span_device(ev, ["a", "b", "c"])
    assert got == {"a": {"calls": 2, "kernels": 2,
                         "device_s": pytest.approx(10e-6)},
                   "b": {"calls": 1, "kernels": 0, "device_s": 0.0}}
