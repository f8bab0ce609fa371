"""TD-MPC2 (``algos/tdmpc2.py``) and its plan runner
(``envs/wrappers.PlanRunner``) against the plain reference
``tests/tdmpc2_ref.py`` (a byte copy of ``benchmark/reference/tdmpc2.py``),
on the CPU at a small size: latent and hidden widths 64, a 32-wide encoder,
32 samples, 8 elites, 4 policy trajectories, 2 iterations, horizon 3, B=4,
seeded weights. The port has no JAX counterpart of these: the reference is
the published equations in plain torch.

On a card (marked ``cuda``, skipped without one; run with
``python -m pytest --noconftest -m cuda tests/test_torch_tdmpc2.py``): the
published planner at B=32 against the reference, 128 row-kernel launches a
plan; the runner keeps the graphed env step one key.
"""

import ast
import dataclasses
import pathlib

import pytest
import torch

import tdmpc2_ref as ref
from paddlerobotics_torch.algos import tdmpc2 as td
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.envs.wrappers import PlanRunner
from paddlerobotics_torch.ops import groupnorm_mish as gn
from paddlerobotics_torch.utils import profiler
from torch_card import cuda  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 4
SMALL = td.TDMPC2Config(enc_dim=32, mlp_dim=64, latent_dim=64,
                        num_samples=32, num_elites=8, num_pi_trajs=4,
                        iterations=2)
PUBLISHED = td.TDMPC2Config()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def small_planner(seed=0, cfg=SMALL, device="cpu"):
    pl = td.TDMPC2Planner(cfg, device=device)
    w = ref.make_weights(as_dict(cfg), torch.Generator(device=device)
                         .manual_seed(seed))
    pl.model.load_state_dict(w, strict=True)
    return pl, w


def plan_inputs(pl, seed=1, n=B):
    dev = pl.device
    g = torch.Generator(device=dev).manual_seed(seed)
    obs = torch.randn(n, pl.cfg.obs_dim, generator=g, device=dev)
    t0 = torch.arange(n, device=dev) % 3 == 0
    prev = torch.rand(n, pl.cfg.horizon, pl.cfg.action_dim, generator=g,
                      device=dev) * 2 - 1
    return obs, t0, prev, pl.draw_noise(n, g)


def scaled_gap(got, want):
    return float((got - want).abs().max() / max(float(want.abs().max()), 1.0))


def test_each_network_matches_reference():
    """Encoder, dynamics, reward, policy and every Q head on the same
    weights and inputs as the reference, and the bins' decoding: the same
    operations in the same order, within 1e-6 of each output's scale."""
    pl, w = small_planner()
    m, d = pl.model, as_dict(SMALL)
    g = torch.Generator().manual_seed(2)
    obs = torch.randn(B, 49, generator=g)
    z = ref.encode(w, obs, d)
    a = torch.rand(B, 12, generator=g) * 2 - 1
    eps = torch.randn(B, 12, generator=g)
    pairs = [
        (m.encode(obs), z),
        (m.next(z, a), ref.next_latent(w, z, a, d)),
        (m.reward(z, a), ref.reward_logits(w, z, a)),
        (m._Qs(torch.cat([z, a], -1)), ref.q_logits(w, z, a, d)),
        (m.two_hot_inv(m.reward(z, a)),
         ref.two_hot_inv(ref.reward_logits(w, z, a), d))]
    pairs += list(zip(m.pi(z, eps), ref.pi(w, z, eps)))
    for got, want in pairs:
        assert got.shape == want.shape
        assert scaled_gap(got, want) <= 1e-6
    # SimNorm: each group of 8 sums to 1
    torch.testing.assert_close(z.view(B, -1, 8).sum(-1),
                               torch.ones(B, 8), rtol=0, atol=1e-6)
    assert SMALL.discount == PUBLISHED.discount == pytest.approx(119 / 120)


def test_value_and_refit_match_reference():
    """One value estimate (B, S) on the same latent, actions, policy noise
    and per-env Q pairs, then the refit on its values: elites, weights,
    mean and std as the reference's one-env code computes them."""
    pl, w = small_planner()
    d = as_dict(SMALL)
    obs, _, _, noise = plan_inputs(pl)
    z = pl.model.encode(obs)
    S = SMALL.num_samples
    g = torch.Generator().manual_seed(3)
    actions = torch.rand(3, B, S, 12, generator=g) * 2 - 1
    got = pl.estimate_value(z.repeat_interleave(S, 0), actions,
                            noise.pi_value[0], noise.q_pair[0])
    want = ref.estimate_value(w, z, actions, noise.pi_value[0],
                              noise.q_pair[0], d)
    assert got.shape == (B, S) and float(want.std()) > 0.1
    assert scaled_gap(got, want) <= 1e-6
    fit = td.refit(want, actions, SMALL)
    rfit = ref.refit(want, actions, d)
    for k in ("elite_value", "elite_actions", "score", "mean", "std"):
        torch.testing.assert_close(getattr(fit, k), rfit[k], rtol=0,
                                   atol=1e-6)
    assert bool((fit.std >= SMALL.min_std).all())
    # the pairs are two distinct heads per env and iteration
    q = noise.q_pair
    assert q.shape == (2, B, 2) and bool((q[..., 0] != q[..., 1]).all())


def test_whole_plan_matches_reference_on_the_same_noise():
    """A plan for B envs, one of them cold and the others warm started:
    the executed action and the new mean within 1e-5 of the reference's
    (float32 rounding of other summation orders; TF32 would read ~1e-3)."""
    pl, w = small_planner()
    obs, t0, prev, noise = plan_inputs(pl)
    a, mean = pl.plan(obs, t0, prev, noise)
    ra, rmean = ref.plan(w, obs, t0, prev, noise, as_dict(SMALL))
    assert a.shape == (B, 12) and mean.shape == (B, 3, 12)
    assert float(a.abs().max()) <= 1.0
    torch.testing.assert_close(a, ra, rtol=0, atol=1e-5)
    torch.testing.assert_close(mean, rmean, rtol=0, atol=1e-5)


def test_reset_rule():
    """A reset env's warm start is zero; the others' is the previous mean
    shifted by one, its last step zero (the published ``mean[:-1] =
    _prev_mean[1:]``)."""
    g = torch.Generator().manual_seed(4)
    prev = torch.randn(5, 3, 12, generator=g)
    t0 = torch.tensor([True, False, False, True, False])
    got = td.warm_start(prev, t0)
    assert torch.equal(got, ref.warm_start(prev, t0))
    assert not bool(got[t0].any())
    assert torch.equal(got[~t0, :2], prev[~t0, 1:])
    assert not bool(got[~t0, 2].any())


def test_one_weight_dict_loads_into_both():
    """The published names and shapes on the meta device at the published
    widths: 4,994,678 parameters, 2,926,585 of them in the 5 Q heads; the
    reference's dict loads strictly and holds the same names."""
    m = td.WorldModel(PUBLISHED, device="meta")
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == ref.param_shapes(as_dict(PUBLISHED))
    assert sum(p.numel() for p in m.parameters()) == 4_994_678
    assert sum(p.numel() for p in m._Qs.parameters()) == 2_926_585
    assert {k for k in got if k.startswith("_Qs")} == {
        f"_Qs.params.{i}" for i in range(10)}
    pl, w = small_planner()
    assert set(pl.model.state_dict()) == set(w)
    assert pl.model._dynamics[-1].act == "simnorm"
    assert pl.model._encoder["state"][-1].act == "simnorm"


@pytest.fixture(scope="module")
def env():
    return BatchedQuadrupedEnv(QuadrupedConfig(), B, device="cpu")


def test_plan_runner_steps_the_env_and_resets_the_warm_start(env):
    """Three control steps through ``env.step(autoreset=True)``, env 1
    forced to reset (``donef``) at the second: each action is the plan's
    × act_bound + act_offset on the runner's own noise, every env starts
    cold after the reset and env 1 again after its own; ``planner_resets``
    counts it, and the spans nest one plan a step."""
    pl, w = small_planner()
    runner = PlanRunner(env, pl, torch.Generator().manual_seed(5))
    bound = torch.as_tensor(env.act_bound)
    offset = torch.as_tensor(env.act_offset)
    state, obs = runner.reset(torch.Generator().manual_seed(6))
    assert bool(state.t0.all()) and not bool(state.mean.any())
    g = torch.Generator().manual_seed(5)
    profiler.collect_spans()
    profiler.collect_counters()
    profiler.enable_spans(True)
    try:
        for k in range(3):
            noise = pl.draw_noise(B, g)
            ra, rmean = ref.plan(w, state.obs, state.t0, state.mean, noise,
                                 as_dict(SMALL))
            forced = (torch.arange(B) == 1) if k == 1 else False
            state, obs, _, done, info = runner.step(state, forced)
            torch.testing.assert_close(info["action"], ra * bound + offset,
                                       rtol=0, atol=1e-5)
            torch.testing.assert_close(state.mean, rmean, rtol=0, atol=1e-5)
            assert torch.equal(state.t0, done)
            assert torch.equal(state.obs, obs)
            if k == 1:
                assert bool(done[1])
    finally:
        profiler.enable_spans(False)
    names = [r.name for r in profiler.collect_spans()]
    counts = profiler.collect_counters()
    for name, n in (("policy.tdmpc2", 3), ("policy.tdmpc2.encode", 3),
                    ("policy.tdmpc2.pi_trajs", 3), ("policy.tdmpc2.value", 6),
                    ("policy.tdmpc2.refit", 6), ("policy.tdmpc2.select", 3),
                    ("env.plan", 3)):
        assert names.count(name) == n, name
    assert counts["plans"] == 3 and counts["value_rollouts"] == 6
    assert counts["planner_resets"] >= 1
    assert "norm_launches" not in counts


def test_plan_keeps_its_inner_tensors_when_asked():
    """``keep`` holds the latent, the trajectories, the warm start, the
    named iterations' inputs and refits, and the final refit, without
    changing the plan."""
    pl, _ = small_planner()
    obs, t0, prev, noise = plan_inputs(pl)
    a, mean = pl.plan(obs, t0, prev, noise)
    keep = {"iterations": {1}}
    a2, mean2 = pl.plan(obs, t0, prev, noise, keep)
    assert torch.equal(a, a2) and torch.equal(mean, mean2)
    assert set(keep["iters"]) == {1}
    it = keep["iters"][1]
    assert it["actions"].shape == (3, B, 32, 12)
    assert torch.equal(it["actions"][:, :, :4], keep["pi_actions"])
    assert torch.equal(keep["refit"].mean, mean)
    assert torch.equal(keep["mean0"], td.warm_start(prev, t0))


def test_reference_copies_are_one_file_importing_no_port():
    mine = ROOT / "tests" / "tdmpc2_ref.py"
    bench = ROOT / "benchmark" / "reference" / "tdmpc2.py"
    assert mine.read_bytes() == bench.read_bytes()
    roots = set()
    for node in ast.walk(ast.parse(mine.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "math", "torch"}


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_published_planner_on_the_card(cuda):
    """The published widths and budget at B=32 on the card (bias-less
    GEMMs, the row kernel): one plan against the reference on the same
    noise, values and latent within 1e-4 of their scale (the cell's
    limits), the refits on the program's values and the executed action
    on its final elites within float32 rounding, 128 row-kernel launches
    and ``norm_launches`` a plan."""
    pl, w = small_planner(cfg=PUBLISHED, device=cuda)
    d = as_dict(PUBLISHED)
    obs, t0, prev, noise = plan_inputs(pl, n=32)
    keep = {"iterations": {0, 5}}
    launches = gn.groupnorm_mish.launches
    profiler.collect_counters()
    profiler.enable_spans(True)
    try:
        a, mean = pl.plan(obs, t0, prev, noise, keep)
    finally:
        profiler.enable_spans(False)
    torch.cuda.synchronize()
    assert gn.groupnorm_mish.launches - launches == 128
    assert profiler.collect_counters()["norm_launches"] == 128
    with torch.no_grad():
        assert scaled_gap(keep["z"], ref.encode(w, obs, d)) <= 1e-4
        for i, it in keep["iters"].items():
            want = ref.estimate_value(w, keep["z"], it["actions"],
                                      noise.pi_value[i], noise.q_pair[i], d)
            assert scaled_gap(it["value"], want) <= 1e-4
            rfit = ref.refit(it["value"], it["actions"], d)
            for k in ("elite_value", "score", "mean", "std"):
                assert scaled_gap(getattr(it["fit"], k), rfit[k]) <= 1e-5
        fit = keep["refit"]
        ra = ref.select(fit.elite_actions, fit.score, noise.gumbel)
    assert scaled_gap(a, ra) <= 1e-6


@pytest.mark.cuda
def test_plan_runner_keeps_one_env_step_key_on_the_card(cuda):
    """Three control steps of the small planner at B=64 on flat ground:
    one capture, every later step a replay."""
    env = BatchedQuadrupedEnv(QuadrupedConfig(), 64, device=cuda)
    pl, _ = small_planner(device=cuda)
    runner = PlanRunner(env, pl, torch.Generator(device=cuda).manual_seed(1))
    state, _ = runner.reset(torch.Generator(device=cuda).manual_seed(2))
    for _ in range(3):
        state = runner.step(state)[0]
    torch.cuda.synchronize()
    st = env.graph_stats
    assert st["captures"] == 1
    assert st["replays"] == 2 and dict(st["eager"]) == {"warmup": 1}
