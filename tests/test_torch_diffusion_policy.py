"""Diffusion Policy (``algos/diffusion_policy.py``) and its chunk runner
(``envs/wrappers.ChunkRunner``) against the plain reference
``tests/diffusion_policy_ref.py`` (a byte copy of
``benchmark/reference/diffusion_policy.py``), on the CPU at a small size:
down_dims 16/32/64, 8 groups, a 16-wide step embedding, B=6, seeded
weights. The port has no JAX counterpart of these: the reference is the
published equations in plain torch.

On a card (marked ``cuda``, skipped without one; run with
``python -m pytest --noconftest -m cuda tests/test_torch_diffusion_policy.py``):
the hold mask leaves the graphed env step one key.
"""

import ast
import dataclasses
import math
import pathlib

import pytest
import torch

import diffusion_policy_ref as ref
from paddlerobotics_torch.algos import diffusion_policy as dp
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.envs.wrappers import ChunkRunner
from paddlerobotics_torch.utils import profiler
from torch_card import cuda  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 6
SMALL = dp.DiffusionConfig(down_dims=(16, 32, 64), step_embed_dim=16)
PUBLISHED = dp.DiffusionConfig()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (as ``torch_parity.one_thread``, which imports
    JAX; this file runs on the card without it): the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def small_policy(seed=0):
    pol = dp.DiffusionPolicy(SMALL, device="cpu")
    w = ref.make_weights(as_dict(SMALL), torch.Generator().manual_seed(seed))
    pol.load_state_dict(w, strict=True)
    return pol.requires_grad_(False), w


def inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, SMALL.n_obs_steps, SMALL.obs_dim, generator=g),
            torch.randn(B, SMALL.horizon, SMALL.action_dim, generator=g))


def test_unet_eps_matches_reference():
    """One U-Net call at each DDIM timestep: the same operations in the
    same order as the reference, so equal to float32 rounding (the CPU's
    convolution may pick another blocking for a tensor it copies; 1e-6 of
    the output's scale is a few roundings of the ~600-term sums)."""
    pol, w = small_policy()
    hist, noise = inputs()
    cond = pol.global_cond(hist)
    torch.testing.assert_close(cond, ref.global_cond(w, hist, as_dict(SMALL)),
                               rtol=0, atol=0)
    for t in (90.0, 40.0, 0.0):
        tt = torch.full((B,), t)
        with torch.no_grad():
            got = pol.model(noise, tt, cond)
            want = ref.unet(w, noise, tt, cond, as_dict(SMALL))
        scale = float(want.abs().max())
        assert scale > 0.1
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)


def test_ddim_sample_matches_reference():
    """The whole DDIM-10 sample from the same noise and history, at the
    float32 rounding level: ten calls, each divided by √ᾱ_t (≥ 0.14) before
    the clip, carry a call's 1e-6 to at most ~1e-5 of the plan's scale 1."""
    pol, w = small_policy()
    hist, noise = inputs()
    got = pol.predict_action(hist, noise)
    want = ref.ddim_sample(w, hist, noise, as_dict(SMALL))
    assert got.shape == (B, 16, 12) and float(got.abs().max()) <= 1.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    ts = [t for t, _, _ in pol.schedule]
    assert ts == list(range(90, -1, -10))
    assert pol.schedule[-1][2] == 1.0
    ac = ref.alphas_cumprod(100)
    assert [a for _, a, _ in pol.schedule] == [ac[t] for t in ts]


def test_parameters_at_the_published_widths():
    """Built on the meta device (no memory, no forward pass): every weight
    by its published name and shape, 66,632,716 in the U-Net: 60.9 M in
    convolutions, 5.07 M in the FiLM linears, 0.52 M in the step encoder."""
    pol = dp.DiffusionPolicy(PUBLISHED, device="meta")
    got = {k: tuple(v.shape) for k, v in pol.state_dict().items()}
    assert got == ref.param_shapes(as_dict(PUBLISHED))
    n = sum(p.numel() for p in pol.model.parameters())
    assert n == 66_632_716
    film = sum(p.numel() for k, p in pol.model.named_parameters()
               if ".cond_encoder." in k)
    step = sum(p.numel() for k, p in pol.model.named_parameters()
               if k.startswith("diffusion_step_encoder"))
    assert (film, step) == (5_089_280, 525_568)
    assert PUBLISHED.cond_dim == 354


@pytest.fixture(scope="module")
def env():
    return BatchedQuadrupedEnv(QuadrupedConfig(), B, device="cpu")


def _runner(env, pol):
    return ChunkRunner(env, pol, torch.Generator().manual_seed(5))


def test_chunk_runner_selection_padding_and_hold(env):
    """A chunk of 8 control steps with env 2 forced to reset (``donef``)
    at step 3, then the next chunk's first step: the plan's steps 1..8 are
    executed (× act_bound + act_offset), the history starts as the first
    observation repeated and restarts so after the reset, env 2 runs the
    zero residual from step 4 to the replan, and the replan plans from the
    history then and frees it. Action and plan to float32 rounding (the
    sample's bound, above); the masks and histories exactly."""
    pol, w = small_policy()
    runner = _runner(env, pol)
    bound = torch.as_tensor(env.act_bound)
    offset = torch.as_tensor(env.act_offset)
    d = as_dict(SMALL)
    state, obs = runner.reset(torch.Generator().manual_seed(3))
    torch.testing.assert_close(state.history, torch.stack([obs, obs], 1),
                               rtol=0, atol=0)
    g = torch.Generator().manual_seed(5)
    noises = [torch.randn(state.plan.shape, generator=g) for _ in range(2)]
    forced = torch.arange(B) == 2
    plan = None
    for k in range(9):
        before = state
        state, obs, _, done, info = runner.step(
            state, forced if k == 3 else False)
        if k % 8 == 0:
            plan = ref.ddim_sample(w, before.history, noises[k // 8], d)
        held0 = ref.held_at(before.held, k % 8)
        torch.testing.assert_close(state.plan, plan, rtol=0, atol=1e-5)
        want_a = ref.select(plan, before.held, k % 8, d, bound, offset)
        torch.testing.assert_close(info["action"], want_a, rtol=0, atol=1e-6)
        held1, hist1 = ref.hold_rule(before.held, k % 8, before.history, obs,
                                     done)
        assert torch.equal(state.held, held1)
        torch.testing.assert_close(state.history, hist1, rtol=0, atol=0)
        assert state.k == (k + 1) % 8
        if k == 3:
            assert bool(done[2])
            torch.testing.assert_close(state.history[2],
                                       torch.stack([obs[2], obs[2]]),
                                       rtol=0, atol=0)
        if 4 <= k < 8:
            assert bool(held0[2])
            torch.testing.assert_close(info["action"][2], offset, rtol=0,
                                       atol=0)
    assert not bool(held0[2])           # the replan freed env 2


def test_hold_mask_keeps_one_env_step_key(env, monkeypatch):
    """Whatever the mask holds, the runner calls the env step with one
    graph key (the action's shape and dtype, ``autoreset``, a bool
    ``donef``): held envs change the action's values only."""
    pol, _ = small_policy()
    runner = _runner(env, pol)
    keys = []
    real = env._graphs.step

    def record(state, actions, donef, autoreset):
        keys.append((tuple(actions.shape), actions.dtype, autoreset,
                     donef if isinstance(donef, bool) else None))
        return real(state, actions, donef, autoreset)

    monkeypatch.setattr(env._graphs, "step", record)
    state, _ = runner.reset(torch.Generator().manual_seed(4))
    for k in range(4):
        if k == 2:
            state = state._replace(held=torch.arange(B) % 2 == 0)
        state = runner.step(state)[0]
    assert set(keys) == {((B, 12), torch.float32, True, False)}


def test_spans_and_counters(env):
    """Off, nothing is recorded and nothing counted; on, a replan holds
    one ``policy.diffusion.cond`` and ten ``policy.diffusion.unet`` and
    ``policy.diffusion.ddim`` spans, each step two ``env.chunk`` spans,
    and the counters add up (a forced reset at step 1 holds one env for
    the chunk's last 6 steps)."""
    pol, _ = small_policy()
    runner = _runner(env, pol)
    state, _ = runner.reset(torch.Generator().manual_seed(6))
    profiler.collect_spans()
    profiler.collect_counters()
    state = runner.step(state)[0]
    assert profiler.collect_spans() == []
    assert profiler.collect_counters() == {}
    profiler.enable_spans(True)
    try:
        for k in range(1, 8):
            state = runner.step(state, (torch.arange(B) == 0) if k == 1
                                else False)[0]
        state = runner.step(state)[0]
    finally:
        profiler.enable_spans(False)
    names = [r.name for r in profiler.collect_spans()]
    counts = profiler.collect_counters()
    for name, n in (("policy.diffusion", 1), ("policy.diffusion.cond", 1),
                    ("policy.diffusion.unet", 10),
                    ("policy.diffusion.ddim", 10), ("env.chunk", 16)):
        assert names.count(name) == n, name
    assert counts["replans"] == 1 and counts["unet_calls"] == 10
    assert counts["mid_chunk_resets"] >= 1
    assert counts["held_env_steps"] >= 6


def test_counter_sums_device_counts_while_on():
    profiler.collect_counters()
    profiler.count("x", 2)
    assert profiler.collect_counters() == {}
    profiler.enable_spans(True)
    try:
        profiler.count("x", 2)
        profiler.count("x", torch.tensor([True, False, True]).sum())
        profiler.count("y")
    finally:
        profiler.enable_spans(False)
    assert profiler.collect_counters() == {"x": 4, "y": 1}
    assert profiler.collect_counters() == {}


def test_reference_copies_are_one_file_importing_no_port():
    """The tests' and the benchmark's reference are the same bytes and
    import nothing but torch and math (no JAX, nothing of either
    package)."""
    mine = ROOT / "tests" / "diffusion_policy_ref.py"
    bench = ROOT / "benchmark" / "reference" / "diffusion_policy.py"
    assert mine.read_bytes() == bench.read_bytes()
    roots = set()
    for node in ast.walk(ast.parse(mine.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "math", "torch"}


@pytest.mark.cuda
def test_hold_mask_adds_no_graph_on_the_card(cuda):
    """Two chunks at B=64 on flat ground, half the envs held from the
    third step on: one capture, every later step a replay."""
    env = BatchedQuadrupedEnv(QuadrupedConfig(), 64, device=cuda)
    pol = dp.DiffusionPolicy(SMALL, device=cuda)
    pol.load_state_dict(ref.make_weights(
        as_dict(SMALL), torch.Generator(device=cuda).manual_seed(0)))
    runner = ChunkRunner(env, pol, torch.Generator(device=cuda).manual_seed(1))
    state, _ = runner.reset(torch.Generator(device=cuda).manual_seed(2))
    for k in range(16):
        if k == 2:
            state = state._replace(held=torch.arange(64, device=cuda) % 2 == 0)
        state = runner.step(state)[0]
    torch.cuda.synchronize()
    st = env.graph_stats
    assert st["captures"] == 1
    assert st["replays"] == 15 and dict(st["eager"]) == {"warmup": 1}
