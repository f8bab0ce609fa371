"""The batched env's ETG residual (``ops/etg_residual.py``) on the CPU: the
wrapper's path is the PyTorch composition bit for bit, against the
benchmark's frozen copy of the env's residual, at H = 20 and another H, in
both pairings, over several gait periods; a float32 model of the kernel's
arithmetic, which reads the constants and scalars the kernel is handed,
against the composition; the packed scalars are PyTorch's own float32
roundings; what ``check_args`` refuses (an H over ``MAX_H`` among them); no
``etg_launches`` on the CPU; ``kernel_time.etg_bound``'s bytes.

The kernel itself is held against the composition on the card in
``tests/test_torch_card_kernels.py``.
"""

import numpy as np
import pytest
import torch

from paddlerobotics_torch.core.config import ETGConfig, QuadrupedConfig
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.ops import etg_residual as er
from paddlerobotics_torch.ops import kernel_time
from paddlerobotics_torch.utils import profiler

CASES = [(h, p) for h in (20, 48) for p in ("trot", "bound")]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(H: int, pairing: str, B: int):
    cfg = QuadrupedConfig(etg=ETGConfig(H=H, pairing=pairing))
    return BatchedQuadrupedEnv(cfg, B, device="cpu")


def _inputs(env, seed: int, periods: int = 6):
    """The env's fitted readout with a perturbation per env, and step
    indices over ``periods`` gait periods."""
    g = torch.Generator().manual_seed(seed)
    w, b = env.default_etg()
    w = w + 0.02 * torch.randn(w.shape, generator=g)
    b = b + 0.01 * torch.randn(b.shape, generator=g)
    steps = round(periods * env.cfg.etg.T / env.cfg.etg.dt)
    idx = torch.randint(0, steps, (env.B,), generator=g, dtype=torch.int32)
    return w, b, idx


@pytest.mark.parametrize("H,pairing", CASES)
def test_cpu_path_is_the_frozen_composition(H, pairing):
    """On CPU tensors the wrapper returns what the benchmark's frozen copy
    of the env's residual returns, every output bit for bit."""
    from benchmark.reference import config as rconfig
    from benchmark.reference.env import BatchedQuadrupedEnv as RefEnv

    B = 7
    env = _env(H, pairing, B)
    ref = RefEnv(rconfig.QuadrupedConfig(etg=rconfig.ETGConfig(
        H=H, pairing=pairing)), B, device="cpu")
    w, b, idx = _inputs(env, seed=H)
    got = env._etg_residual(w, b, idx)
    want = ref._etg_residual(w, b, idx)
    assert [t.dtype for t in got] == [torch.float32, torch.bool,
                                      torch.bool, torch.float32]
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert torch.equal(got[0], er.plain(w, b, idx, env._etg)[0])


def kernel_model(w, b, idx, k: er.Consts):
    """The kernel's arithmetic in float32 on the CPU, from the constants
    and scalars it is handed: one (leg, env) at a time in vectors over the
    envs, the readout summed over each half of h in order, then the two
    halves added."""
    s = {n: torch.tensor(v) for n, v in zip(er.SCALARS, k.scalars)}
    lg = {n: k.legs[:, i] for i, n in enumerate(er.LEG_FIELDS)}
    u = k.centers
    H, B = w.shape[1], w.shape[2]
    t_a = idx.to(torch.float32) * s["dt"]

    def features(t):
        p1 = torch.sin(t * s["w1"] + s["ph1"]) * s["amp"]
        p2 = torch.sin(t * s["w2"] + s["ph2"]) * s["amp"]
        d2 = (p1 - u[:, 0:1]) * (p1 - u[:, 0:1]) + \
            (p2 - u[:, 1:2]) * (p2 - u[:, 1:2])
        return torch.exp(-d2 * s["inv_sigma_sq"])           # (H, B)

    act = torch.empty((12, B))
    swing = torch.empty((4, B), dtype=torch.bool)
    stance = torch.empty((4, B), dtype=torch.bool)
    for j in range(4):
        t = t_a if lg["sel_a"][j] != 0 else t_a + s["half_t"]
        v = features(t)
        half = -(-H // 2)
        lo, hi = torch.zeros((3, B)), torch.zeros((3, B))
        for h in range(half):
            lo = lo + w[:, h] * v[h]
        for h in range(half, H):
            hi = hi + w[:, h] * v[h]
        d = lo + hi
        dx = d[0] + b[0] + lg["stx"][j]
        dy = d[1] + b[1] + lg["lat"][j]
        dz = d[2] + b[2]
        fx, fy, fz = lg["fx0"][j] + dx, lg["fy0"][j] + dy, lg["fz0"][j] + dz
        lh = lg["l_hip"][j]
        d2 = fx * fx + fy * fy + fz * fz
        ck = (d2 - lh * lh - s["l_low_sq"] - s["l_up_sq"]) * \
            s["inv_2_l_low_up"]
        tk = -torch.acos(torch.clamp(ck, -1.0, 1.0))
        l = torch.sqrt(torch.clamp(torch.cos(tk) * s["two_l_up_low"]
                                   + s["l_sq_sum"], min=float(s["sq_min"])))
        th = torch.asin(torch.clamp(-fx / l, -1.0, 1.0)) - tk * 0.5
        lc = l * torch.cos(th + tk * 0.5)
        tab = torch.atan2(lc * fy + lh * fz, lh * fy - lc * fz)
        for i, ang in enumerate((tab, th, tk)):
            act[3 * j + i] = ang - lg[("q0_ab", "q0_hip", "q0_knee")[i]][j]
        swing[j] = dz > s["swing_z"]
        stance[j] = dz <= s["stance_z"]
    return act, swing, stance, features(t_a)


@pytest.mark.parametrize("H,pairing", CASES)
def test_composition_matches_a_model_of_the_kernels_arithmetic(H, pairing):
    """The kernel's function, read from its packed constants and scalars,
    is the composition's: V(t) and the residual within float32 rounding of
    sums in another order and of scalar divisions as products, the masks
    equal (no dz of these inputs lies within rounding of a threshold)."""
    env = _env(H, pairing, 64)
    w, b, idx = _inputs(env, seed=H + 1)
    act, swing, stance, v_a = er.plain(w, b, idx, env._etg)
    m_act, m_swing, m_stance, m_v = kernel_model(w, b, idx, env._etg)
    assert float((m_v - v_a).abs().max()) < 1e-6
    assert float((m_act - act).abs().max()) < 1e-5
    assert bool(swing.any()) and bool(stance.any())
    assert torch.equal(m_swing, swing) and torch.equal(m_stance, stance)


def test_packed_scalars_are_pytorchs_roundings():
    """Each scalar the kernel reads is the float32 that PyTorch makes of
    the composition's Python float (a product or a sum with a tensor); the
    two divisions by a scalar are products by the float32 reciprocal."""
    env = _env(20, "trot", 2)
    k = env._etg
    s = dict(zip(er.SCALARS, k.scalars.tolist()))
    one = torch.ones(1)
    cfg = env.cfg.etg
    l_up = 0.2
    for name, x in (("dt", cfg.dt), ("w1", 2 * np.pi / cfg.T),
                    ("ph1", cfg.phase[0]), ("w2", 2 * np.pi / cfg.T2),
                    ("amp", cfg.amp), ("half_t", cfg.T / 2),
                    ("l_low_sq", l_up ** 2), ("l_sq_sum", 2 * l_up ** 2),
                    ("two_l_up_low", 2 * l_up * l_up),
                    ("swing_z", er.SWING_Z), ("stance_z", er.STANCE_Z)):
        assert s[name] == float(one * x), name
    assert s["inv_sigma_sq"] == float(np.float32(1) / np.float32(0.04))
    assert s["inv_2_l_low_up"] == float(np.float32(1) / np.float32(0.08))
    assert s["sq_min"] == float(torch.clamp(torch.zeros(1), min=1e-12))


def test_check_args_refuses():
    """What the kernel does not take raises before a launch: an H over
    ``MAX_H``, another dtype, shape or layout."""
    over = _env(er.MAX_H + 1, "trot", 3)
    w, b, idx = _inputs(over, seed=0)
    with pytest.raises(ValueError, match="phase features"):
        er.check_args(w, b, idx, over._etg)
    env = _env(20, "trot", 3)
    w, b, idx = _inputs(env, seed=0)
    er.check_args(w, b, idx, env._etg)
    for bad, match in (
            ((w.double(), b, idx), "dtype"),
            ((w, b, idx.long()), "dtype"),
            ((w, b[:, :2], idx), "shape"),
            ((w[:, :10].contiguous(), b, idx), "shape"),
            ((w.transpose(0, 2).contiguous().transpose(0, 2), b, idx),
             "contiguous")):
        with pytest.raises((TypeError, ValueError), match=match):
            er.check_args(*bad, env._etg)


def test_no_etg_launches_on_the_cpu():
    """On the CPU the composition runs: no kernel launch is counted, and a
    step under spans adds no ``etg_launches``; inputs that require grad
    keep their graph."""
    env = _env(20, "trot", 4)
    state, _ = env.reset(torch.Generator().manual_seed(2))
    n = er.etg_residual.launches
    profiler.collect_counters()
    profiler.enable_spans(True)
    try:
        env.step(state, torch.zeros((4, 12)))
    finally:
        profiler.enable_spans(False)
    profiler.collect_spans()
    assert "etg_launches" not in profiler.collect_counters()
    assert er.etg_residual.launches == n
    w, b, idx = _inputs(env, seed=3)
    w = w.requires_grad_(True)
    act = env._etg_residual(w, b, idx)[0]
    act.sum().backward()
    assert w.grad is not None and bool(w.grad.abs().sum() > 0)


@pytest.mark.parametrize("H", [20, 48])
def test_bound_counts_each_input_read_and_each_output_written_once(H):
    """``kernel_time.etg_bound``'s bytes are the inputs' and the outputs'
    own, at the rollout's batch."""
    env = _env(H, "trot", 1)
    B = kernel_time.B
    w, b = env._w0[..., None].repeat(1, 1, B), env._b0[:, None].repeat(1, B)
    idx = torch.zeros((B,), dtype=torch.int32)
    outs = er.plain(w, b, idx, env._etg)
    n = sum(t.numel() * t.element_size() for t in (w, b, idx, *outs))
    bound = kernel_time.etg_bound(B, H)
    assert bound["bytes"] == n
    assert bound["bound_by"] == "bytes"
    if H == 20:
        assert abs(bound["bound_ms"] - 1_605_632 / 3.35e12 * 1e3) < 1e-12
