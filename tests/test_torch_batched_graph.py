"""The batched env step replayed as a CUDA graph (``envs/step_graph``).

On the CPU: the device constants a step reads instead of copying from the
host (the ring's indices and ages per head, the standing start the
autoreset selects from) equal what they replace, the eager step stays
bit-equal to the frozen plain reference, and the eligibility rule sends
the CPU, grad and NaN-check calls to the eager step, counted by reason.

On a card (marked ``cuda``, skipped without one; run with
``python -m pytest --noconftest -m cuda tests/test_torch_batched_graph.py``):
the graphed step against the eager ``_step``, bit for bit, on flat ground
at B=64, under DR (the 40-row ring, every head value) at B=64, and at B=1,
with a forced ``donef``, envs that fall and autoreset, every state field,
the observation, reward, done, info and the generator's state compared
after every step, the capturing call included; returned tensors that no
later step overwrites; and the launch counter and ``graph_stats`` adding
up to the calls made; and a capture that the cyclic collector, running
inside it, would have invalidated by destroying a dropped env's graphs.
"""

import dataclasses
import gc
import types

import numpy as np
import pytest
import torch

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs import step_graph
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv, BEnvState
from paddlerobotics_torch.ops import physics_step
from paddlerobotics_torch.sim import sbatch
from paddlerobotics_torch.utils import profiler
from torch_card import cuda  # noqa: F401


def _config(dr: bool) -> QuadrupedConfig:
    cfg = QuadrupedConfig()
    if dr:
        cfg = dataclasses.replace(cfg, random=dataclasses.replace(
            cfg.random, random_dynamics=True))
    return cfg


# --- the ring's device constants ----------------------------------------------

def _listed_slots(L, head, count):
    return [(head - k) % L for k in range(count)]


def _listed_ages(L, head):
    return torch.tensor([float((head - k) % L) for k in range(L)],
                        dtype=torch.float32)[:, None]


def _listed_delayed_obs(rb, latency, substep_dt, taps):
    """``sbatch.delayed_obs`` as it indexed the ring with host lists."""
    L = rb.obs_hist.shape[0]
    if taps is None or taps >= L:
        f = torch.clamp(latency / substep_dt, 0.0, L - 1.001)
        wgt = torch.clamp(1.0 - torch.abs(_listed_ages(L, rb.hist_head)
                                          - f[None, :]), min=0.0)
        ob = torch.einsum("lb,ljb->jb", wgt, rb.obs_hist)
        return ob[:12], ob[12:24], ob[24:28], ob[28:31]
    f = torch.clamp(latency / substep_dt, 0.0, taps - 1.001)
    sub = rb.obs_hist[_listed_slots(L, rb.hist_head, taps)]
    ages = torch.arange(taps, dtype=torch.float32)[:, None]
    wgt = torch.clamp(1.0 - torch.abs(ages - f[None, :]), min=0.0)
    ob = torch.einsum("tb,tjb->jb", wgt, sub)
    return ob[:12], ob[12:24], ob[24:28], ob[28:31]


@pytest.mark.parametrize("L", [2, 32, 40])
def test_ring_constants_equal_the_listed_ones(L):
    """Every head value: the device index and ages equal the list-built
    ones, and ``delayed_obs`` (both branches) and ``pd_ring_seed`` return
    what they returned with host lists, bit for bit."""
    B = 5
    g = torch.Generator().manual_seed(L)
    rb = sbatch.init_robot(B, 0.27, hist_len=L)
    hist = torch.randn((L, sbatch.OBS_ROW, B), generator=g)
    latency = torch.rand((B,), generator=g) * 0.08
    for head in range(L):
        rb = rb.replace(obs_hist=hist, hist_head=head)
        for count in sorted({1, min(2, L), min(4, L), L}):
            idx = sbatch.ring_slots(L, head, count, "cpu")
            assert idx.dtype == torch.int64
            assert idx.tolist() == _listed_slots(L, head, count)
            seed = sbatch.pd_ring_seed(rb, (count, 0, 0, 0.0))
            assert torch.equal(seed, hist[_listed_slots(L, head, count),
                                          :24])
        assert torch.equal(sbatch.ring_ages(L, head, "cpu"),
                           _listed_ages(L, head))
        for taps in (None, 2, min(4, L)):
            got = sbatch.delayed_obs(rb, latency, 0.0026, taps=taps)
            want = _listed_delayed_obs(rb, latency, 0.0026, taps)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    # built once: the same tensor for the same ring and head
    assert sbatch.ring_slots(L, 0, L, "cpu") is sbatch.ring_slots(
        L, 0, L, "cpu")


@pytest.mark.parametrize("dr", [False, True])
def test_fresh_robot_equals_init_robot(dr):
    """The standing start the autoreset selects from is
    ``sbatch.init_robot``'s, field by field."""
    env = BatchedQuadrupedEnv(_config(dr), 6, device="cpu")
    want = sbatch.init_robot(6, env._spawn_height, hist_len=env._hist_len)
    got = env._fresh
    pairs = [(got.s.pos, want.s.pos), (got.s.quat, want.s.quat),
             (got.s.w, want.s.w), (got.s.v, want.s.v), (got.s.q, want.s.q),
             (got.s.qd, want.s.qd), (got.last_action, want.last_action),
             (got.tau, want.tau), (got.obs_hist, want.obs_hist),
             (got.contact.foot_pos, want.contact.foot_pos),
             (got.contact.foot_contact, want.contact.foot_contact),
             (got.contact.knee_contact, want.contact.knee_contact),
             (got.contact.base_contact, want.contact.base_contact)]
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.hist_head == want.hist_head
    assert env._donef[True].item() is True
    assert env._donef[False].item() is False


@pytest.mark.parametrize("dr", [False, True])
def test_eager_step_bit_equal_to_frozen_reference(dr):
    """The eager step, now reading device constants, against the
    benchmark's frozen copy of the step that read host lists: every field,
    exactly, over a ring cycle with a forced done and envs that fell."""
    from benchmark import compare
    from benchmark.reference import config as rconfig
    from benchmark.reference.env import BatchedQuadrupedEnv as RefEnv

    rcfg = rconfig.QuadrupedConfig()
    if dr:
        rcfg = dataclasses.replace(rcfg, random=dataclasses.replace(
            rcfg.random, random_dynamics=True))
    B = 6
    env = BatchedQuadrupedEnv(_config(dr), B, device="cpu")
    ref = RefEnv(rcfg, B, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(11))
    rstate, _ = ref.reset(torch.Generator().manual_seed(11))
    # two envs start on the ground: they fall at the first step
    for st in (state, rstate):
        st.robot.s.pos[2, :2] = 0.05
    g = torch.Generator().manual_seed(5)
    for i in range(9):
        a = 0.3 * torch.randn((B, 12), generator=g)
        out = env.step(state, a, i == 4)
        rout = ref.step(rstate, a, i == 4)
        gaps = compare.step_gaps(out, rout)
        assert all(v == 0.0 for v in gaps.values()), (i, gaps)
        assert out[0].robot.hist_head == rout[0].robot.hist_head
        assert torch.equal(out[0].rng.get_state(), rout[0].rng.get_state())
        state, rstate = out[0], rout[0]
    assert env.graph_stats["eager"]["cpu"] == 9


def test_eager_reasons_are_counted():
    """The CPU, an action that requires grad and the NaN checks each send
    the call to the eager step under its own reason; ``eager_reason`` names
    a CPU generator and a ``donef`` of another type on a card's env."""
    B = 4
    env = BatchedQuadrupedEnv(_config(False), B, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(1))
    start = state
    a = torch.zeros((B, 12))
    state = env.step(state, a)[0]
    with torch.no_grad():
        state = env.step(state, a)[0]
    state = env.step(state, a.clone().requires_grad_(True))[0]
    profiler.enable_nan_checks(True)
    try:
        state = env.step(state, a)[0]
    finally:
        profiler.enable_nan_checks(False)
    st = env.graph_stats
    assert dict(st["eager"]) == {"cpu": 2, "grad": 1, "nan_checks": 1}
    assert st["captures"] == 0 and st["replays"] == 0

    # a card's env seen from the rule alone (no card needed)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    leaves = start.leaves()
    assert step_graph.eager_reason(card, start, leaves, a, False) == \
        "generator"
    on_card = dataclasses.replace(start, rng=types.SimpleNamespace(
        device=torch.device("cuda")))
    assert step_graph.eager_reason(card, on_card, leaves, a,
                                   np.bool_(True)) == "donef"
    assert step_graph.eager_reason(card, on_card, leaves, a, [True]) == \
        "donef"
    leaves[0] = leaves[0].clone().requires_grad_(True)
    assert step_graph.eager_reason(card, on_card, leaves, a, False) == "grad"


def test_state_leaves_round_trip():
    """``BEnvState.leaves`` / ``from_leaves`` keep every tensor by
    identity, and the host fields as given."""
    env = BatchedQuadrupedEnv(_config(True), 3, device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(2))
    leaves = state.leaves()
    assert len({id(t) for t in leaves}) == len(leaves)
    back = BEnvState.from_leaves(leaves, state.robot.hist_head, state.rng,
                                 state.push_salt)
    assert all(a is b for a, b in zip(back.leaves(), leaves))
    assert back.robot.hist_head == state.robot.hist_head
    assert back.rng is state.rng and back.push_salt == state.push_salt


# --- on the card ---------------------------------------------------------------

def _copy_state(state, rng):
    return BEnvState.from_leaves([t.clone() for t in state.leaves()],
                                 state.robot.hist_head, rng,
                                 state.push_salt)


def _assert_same(got, want, where):
    gs, go, gr, gd, gi = got
    ws, wo, wr, wd, wi = want
    for k, (a, b) in enumerate(zip(gs.leaves(), ws.leaves())):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
        assert torch.equal(a, b), (where, "state leaf", k)
    assert gs.robot.hist_head == ws.robot.hist_head, where
    assert gs.push_salt == ws.push_salt, where
    for name, a, b in (("obs", go, wo), ("reward", gr, wr),
                       ("done", gd, wd)):
        assert a.dtype == b.dtype and torch.equal(a, b), (where, name)
    assert list(gi) == list(wi), where
    for k in gi:
        assert torch.equal(gi[k], wi[k]), (where, "info", k)
    assert torch.equal(gs.rng.get_state(), ws.rng.get_state()), where


def _grounded(st, B):
    """``st`` with its first quarter of envs put on the ground, in a new
    position tensor (earlier outputs stay as they were)."""
    pos = st.robot.s.pos.clone()
    pos[2, :max(1, B // 4)] = 0.05
    return st.replace(robot=st.robot.replace(s=st.robot.s.replace(pos=pos)))


def _graph_never_aliases(out, others):
    ptrs = {t.data_ptr() for t in others}
    return all(t.data_ptr() not in ptrs for t in out)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["flat_b64", "dr_b64", "flat_b1"])
def test_graphed_step_bit_equal_to_eager(cuda, regime):
    """Flat ground and B=1: a Python ``donef`` (True at two steps, so its
    graph is replayed too); DR: a tensor ``donef`` at every step, as the
    trainer passes it, over every head value. Envs put on the ground fall
    at a capturing step and at a replayed one."""
    dr = regime.startswith("dr")
    B = 1 if regime.endswith("b1") else 64
    env = BatchedQuadrupedEnv(_config(dr), B, device=cuda)
    g_graph = torch.Generator(device=cuda).manual_seed(7)
    state, _ = env.reset(g_graph)
    g_eager = torch.Generator(device=cuda)
    g_eager.set_state(g_graph.get_state())
    eager = _copy_state(state, g_eager)
    acts = torch.Generator(device=cuda).manual_seed(3)
    n = 14 if dr else 8
    falls = (0, 9) if dr else (0, 6)
    launches = physics_step.control_step.launches
    kept = kept_copy = None
    for i in range(n):
        a = 0.3 * torch.randn((B, 12), generator=acts, device=cuda)
        if dr:
            donef = (torch.arange(B, device=cuda) + i) % 5 == 0
        else:
            donef = i in (3, 4)
        if i in falls:
            state, eager = _grounded(state, B), _grounded(eager, B)
        before = physics_step.control_step.launches
        got = env.step(state, a, donef)
        assert physics_step.control_step.launches == before + 1, i
        want = env._step(eager, a, donef, True)
        torch.cuda.synchronize()
        _assert_same(got, want, f"{regime} step {i}")
        if i in falls:
            assert bool(got[3][:max(1, B // 4)].all()), i
        if i == n - 6:
            kept = got
            kept_copy = [t.clone() for t in got[0].leaves()] + [
                got[1].clone(), got[2].clone(), got[3].clone()]
        state, eager = got[0], want[0]
    torch.cuda.synchronize()
    # step n-6's outputs after 5 more steps: nothing overwrote them
    later = kept[0].leaves() + list(kept[1:4])
    for a, b in zip(later, kept_copy):
        assert torch.equal(a, b)
    st = env.graph_stats
    assert st["replays"] + sum(st["eager"].values()) == n
    assert st["captures"] == st["eager"]["warmup"]
    assert set(st["eager"]) == {"warmup"}
    # flat: steps 1, 2, 4, 6, 7; DR: every step after the first cycle
    assert st["replays"] == (n - 4 if dr else 5)
    # the eager chain's n calls of _step launch too
    assert physics_step.control_step.launches == launches + 2 * n
    assert len(env._graphs._by_head) == (4 if dr else 1)


@pytest.mark.cuda
def test_replayed_outputs_are_fresh_and_a_new_generator_recaptures(cuda):
    """Two replays' outputs share no memory with each other or the graph's
    buffers; a reset with another generator drops the cache and captures
    again."""
    env = BatchedQuadrupedEnv(_config(False), 32, device=cuda)
    state, _ = env.reset(torch.Generator(device=cuda).manual_seed(1))
    a = torch.zeros((32, 12), device=cuda)
    outs = []
    for _ in range(4):
        out = env.step(state, a)
        outs.append(out)
        state = out[0]
    graph = next(iter(env._graphs._by_head.values()))[1]
    statics = graph.copy + graph.ins
    o2, o3 = outs[2], outs[3]
    fresh2 = o2[0].leaves()[:13] + [o2[1], o2[2], o2[3]]
    fresh3 = o3[0].leaves()[:13] + [o3[1], o3[2], o3[3]]
    assert _graph_never_aliases(fresh2, statics)
    assert _graph_never_aliases(fresh3, statics + fresh2)
    # the ETG readout passes through: the caller's own tensor, as eager
    assert o3[0].etg_w is o2[0].etg_w
    captures = env.graph_stats["captures"]
    state, _ = env.reset(torch.Generator(device=cuda).manual_seed(2))
    for _ in range(3):
        state = env.step(state, a)[0]
    assert env.graph_stats["captures"] == captures + 1
    assert len(env._graphs._by_head) == 1


@pytest.mark.cuda
def test_capture_survives_a_dropped_envs_graphs(cuda, monkeypatch):
    """A dropped env's graphs are freed by the cyclic collector (the env
    and its graph cache refer to each other); a collection inside another
    env's capture would destroy them there and invalidate that capture.
    Here the collector is off until a capture has begun and then runs at
    nearly every allocation inside it: a new env still captures its step
    and replays it."""
    real = torch.cuda.graph

    class collecting(real):
        def __enter__(self):
            super().__enter__()
            gc.set_threshold(1, 1, 1)
            gc.enable()

    a = torch.zeros((8, 12), device=cuda)

    def dropped():
        env = BatchedQuadrupedEnv(_config(False), 8, device=cuda)
        st, _ = env.reset(torch.Generator(device=cuda).manual_seed(0))
        for _ in range(3):
            st = env.step(st, a)[0]
        assert env.graph_stats["captures"] == 1

    env = BatchedQuadrupedEnv(_config(False), 8, device=cuda)
    old, was_on = gc.get_threshold(), gc.isenabled()
    gc.disable()
    try:
        dropped()
        monkeypatch.setattr(torch.cuda, "graph", collecting)
        st, _ = env.reset(torch.Generator(device=cuda).manual_seed(1))
        for _ in range(3):
            st = env.step(st, a)[0]
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*old)
        if was_on:
            gc.enable()
        else:
            gc.disable()
    assert env.graph_stats["captures"] == 1
    assert env.graph_stats["replays"] == 2
