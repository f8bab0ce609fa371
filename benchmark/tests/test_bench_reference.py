"""The frozen reference agrees with the port's plain path at a small batch
on the CPU, and the work counts are what the shapes say."""


import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import config as rconfig
from benchmark.reference import counts, deploy as rdeploy, etg_fit as rfit
from benchmark.reference import networks as rnet, sac as rsac
from benchmark.reference.env import BatchedQuadrupedEnv as RefEnv
from paddlerobotics_torch.algos import sac as psac
from paddlerobotics_torch.algos.networks import Actor
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.deploy import policy_export
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.etg import fit

CPU = torch.device("cpu")
DR = {"random": {"random_dynamics": True}}


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("over", [{}, DR], ids=["flat", "dr"])
def test_env_steps_agree(over):
    B = 6
    pe = BatchedQuadrupedEnv(harness.quadruped_config(QuadrupedConfig, over),
                             B, device="cpu")
    re = RefEnv(harness.quadruped_config(rconfig.QuadrupedConfig, over), B,
                device="cpu")
    ps, po = pe.reset(_gen(3))
    rs, ro = re.reset(_gen(3))
    assert harness.gap(po, ro) == 0.0
    acts = torch.randn((8, B, 12), generator=_gen(4)) * 0.3
    for a in acts:
        pout = pe.step(ps, a)
        rout = re.step(rs, a)
        assert max(compare.step_gaps(pout, rout).values()) == 0.0
        ps, rs = pout[0], rout[0]


def test_a_program_state_carried_into_the_reference_steps_alike():
    B = 4
    pe = BatchedQuadrupedEnv(harness.quadruped_config(QuadrupedConfig, DR),
                             B, device="cpu")
    re = RefEnv(harness.quadruped_config(rconfig.QuadrupedConfig, DR), B,
                device="cpu")
    ps, _ = pe.reset(_gen(5))
    a = torch.full((B, 12), 0.1)
    gen_bytes = ps.rng.get_state()
    rin = compare.reference_state(ps, gen_bytes, CPU, re.default_etg())
    assert max(compare.step_gaps(pe.step(ps, a), re.step(rin, a))
               .values()) == 0.0


def test_etg_fit_agrees():
    cfg = QuadrupedConfig()
    w, b = fit.opt_with_points(cfg.etg, device="cpu")
    rw, rb = rfit.opt_with_points(rconfig.QuadrupedConfig().etg,
                                  device="cpu")
    assert torch.equal(w, rw) and torch.equal(b, rb)


def _sac_pair():
    cfg = QuadrupedConfig().sac
    p = psac.SAC(49, 12, cfg, device="cpu")
    r = rsac.SAC(49, 12, rconfig.QuadrupedConfig().sac, device="cpu")
    ps, rs = p.init(None), r.init(None)
    g = _gen(11)
    for a, b in ((ps.actor, rs.actor), (ps.critic, rs.critic),
                 (ps.target_critic, rs.target_critic)):
        w = harness.make_params(a, g)
        harness.load_params(a, w)
        harness.load_params(b, w)
    return p, ps, r, rs


def test_sac_update_agrees():
    p, ps, r, rs = _sac_pair()
    g = _gen(12)
    b = 32
    batch = {"obs": torch.randn(b, 49, generator=g),
             "act": torch.rand(b, 12, generator=g) * 2 - 1,
             "rew": torch.randn(b, 1, generator=g),
             "next_obs": torch.randn(b, 49, generator=g),
             "terminal": torch.ones(b, 1)}
    for _ in range(3):
        noise = (torch.randn(b, 12, generator=g),
                 torch.randn(b, 12, generator=g))
        lp = p.learn(ps, batch, noise=noise)
        lr = r.learn(rs, batch, noise=noise)
        assert torch.equal(lp["critic_loss"], lr["critic_loss"])
        assert torch.equal(lp["actor_loss"], lr["actor_loss"])
    for a, b2 in ((ps.actor, rs.actor), (ps.critic, rs.critic),
                  (ps.target_critic, rs.target_critic)):
        for x, y in zip(a.parameters(), b2.parameters()):
            assert torch.equal(x, y)


def test_deploy_policy_agrees():
    cfg = QuadrupedConfig()
    actor = Actor(49, 12, device="cpu")
    w = harness.make_params(actor, _gen(13))
    harness.load_params(actor, w)
    w0, b0 = fit.opt_with_points(cfg.etg, device="cpu")
    table = policy_export.export_gait_table(cfg, w0, b0, 40, device="cpu")
    pol = policy_export.export_policy_fn(actor, table, [0.3] * 12,
                                         device="cpu")
    ractor = harness.load_params(rnet.Actor(49, 12, device="cpu"), w)
    rcfg = rconfig.QuadrupedConfig()
    rw0, rb0 = rfit.opt_with_points(rcfg.etg, device="cpu")
    rtable = rdeploy.gait_table(rcfg, rw0, rb0, 40)
    assert torch.equal(torch.as_tensor(table), rtable)
    rpol = rdeploy.DeployPolicy(ractor, rtable, [0.3] * 12, CPU)
    obs = torch.randn(49, generator=_gen(14))
    with torch.no_grad():
        for i in (0, 7, 39, 45):
            assert torch.equal(pol(obs, i), rpol(obs, i))


def test_physics_operation_count_is_the_ports():
    """The frozen count equals the same count on the port's plain physics
    (the count ``chip_smoke.count_ops_per_env`` made)."""
    from paddlerobotics_torch.sim import sbatch, terrain

    cfg = QuadrupedConfig()
    b = 8
    rb = sbatch.init_robot(b, 0.27, hist_len=2)
    n = counts._Count()
    with n:
        sbatch.control_step(rb, rb.s.q.clone(),
                            sbatch.BDynParams.default(b), cfg.sim,
                            terrain.height_fn(cfg.task))
    ops = counts.physics_ops_per_env(rconfig.QuadrupedConfig())
    assert ops == n.ops / b
    assert 60_000 < ops < 120_000


@pytest.mark.parametrize("ring,bytes_", [(2, 972), (40, 1964)])
def test_physics_bytes_follow_the_shapes(ring, bytes_):
    # inputs 111 floats (state 37, last and new action 24, dynamics 50);
    # outputs 70 floats and min(ring, 10) snapshot rows of 31
    assert counts.physics_bytes_per_env(rconfig.QuadrupedConfig(),
                                        ring) == bytes_


def test_physics_bound_is_the_larger_of_operations_and_bytes():
    cfg = rconfig.QuadrupedConfig()
    ops_s = counts.physics_ops_per_env(cfg) * 4096 / counts.PEAK_FP32_FLOPS
    by_s = 972 * 4096 / counts.PEAK_BYTES_PER_S
    assert counts.physics_bound_s(cfg, 4096, 2) == max(ops_s, by_s) == ops_s


def test_mlp_flops():
    assert counts.mlp_flops(4096, counts.actor_layers(49, 12, 256)) == \
        2 * 4096 * (49 * 256 + 256 * 256 + 2 * 256 * 12)


def test_sac_update_flops_match_a_flop_counter():
    """The spelled-out count equals PyTorch's count of the matrix products
    one reference update runs (forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    r = rsac.SAC(49, 12, rconfig.QuadrupedConfig().sac, device="cpu")
    st = r.init(None)
    g = _gen(15)
    b = 16
    batch = {"obs": torch.randn(b, 49, generator=g),
             "act": torch.rand(b, 12, generator=g),
             "rew": torch.randn(b, 1, generator=g),
             "next_obs": torch.randn(b, 49, generator=g),
             "terminal": torch.ones(b, 1)}
    noise = (torch.randn(b, 12, generator=g), torch.randn(b, 12,
                                                          generator=g))
    fc = FlopCounterMode(display=False)
    with fc:
        r.learn(st, batch, noise=noise)
    assert fc.get_total_flops() == counts.sac_update_flops(b, 49, 12, 256)
