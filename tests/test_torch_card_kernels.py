"""The port's hand-written kernels against their plain versions on the card
(every test marked ``cuda``, skipped without one; run with ``python -m
pytest --noconftest -m cuda tests/test_torch_card_kernels.py``).

Each kernel build reports its registers and spills (``-Xptxas -v``). The
physics kernel (``ops/csrc/physics_step.cu``) against
``sim/sbatch.control_step`` in thirteen cases over three control steps
(every mode, terrain and ring length, a batch whose last block has lanes
past B, the ES rollout's batch, one env, dynamics ID's population); the
attention kernel (``ops/csrc/attention.cu``) against
``reference_attention`` at the serving shapes, ragged and fully masked rows,
head dims 16 to 128, and at the full-width ERNIE encoder's layer 0 in its
wide plan and, on its shortest rows, its split plan; ``track_match``
(``ops/csrc/track_match.cu``) against ``track_match_plain`` on 216 seeded
steps; the ETG residual (``ops/csrc/etg_residual.cu``) against its
composition at B = 1, 40, 320 and 4096, two H and both pairings, its
refusals and NaN check; the NaN checks on faults planted inside the physics
and attention kernels and in a backward pass; a trace of annotated env
steps, and a traced replay of the graphed step at B=4096 (two ETG launches
a step, none of the readout's GEMVs).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from paddlerobotics_torch.core.config import QuadrupedConfig, SimConfig, TaskConfig
from paddlerobotics_torch.envs import randomize
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.ops import (attention, etg_residual, groupnorm_mish,
                                      lap, physics_step, upsample1d)
from paddlerobotics_torch.ops.kernel_time import dynid_dynamics, window_mask
from paddlerobotics_torch.sim import sbatch, terrain
from paddlerobotics_torch.utils import profiler
from torch_card import cuda, ernie, plain_physics  # noqa: F401

pytestmark = pytest.mark.cuda

B = 4096
TAIL_B = 4093                           # a last block with 3 lanes past B
# Kernel vs plain: after one control step every env agrees to TOL; after
# three, contact onsets (the damping term d·vn·[phi > 0] jumps at phi = 0)
# may let a last-bit difference grow in an env that is just touching down,
# so at most MAX_DRIFT_FRAC of the envs may exceed TOL.
TOL = 1e-4
MAX_DRIFT_FRAC = 1e-3
# attention kernel vs plain: float32 sums in another order (online softmax
# over key tiles against one softmax over all keys; products in three TF32
# passes, float32-accurate)
ATTN_ATOL, ATTN_RTOL = 2e-5, 1e-4
MATCH_CASES = 216                       # seeded matching steps, 6 kinds
# the matching's duals are float32: where two assignments' costs differ by
# an ulp it may take either (tests/test_torch_tracking.py)
COST_RTOL = 1e-6


def es_batch(ecfg) -> int:
    """The ES envs' batch, as ``ETGRLTrainer`` sizes it: es_num_envs
    rounded down to a multiple of the popsize."""
    return max(ecfg.popsize, ecfg.es_num_envs // ecfg.popsize * ecfg.popsize)


@pytest.mark.parametrize("kernel", [physics_step, attention, lap, upsample1d,
                                    groupnorm_mish, etg_residual],
                         ids=["physics_step", "attention", "track_match",
                              "upsample1d", "groupnorm_mish", "etg_residual"])
def test_build_reports_registers_and_spills(cuda, kernel):
    kernel.build()
    assert kernel.build_info["ptxas"]
    assert all("registers" in v for v in kernel.build_info["ptxas"].values())


# --- the physics kernel --------------------------------------------------------

PHYSICS_CASES = [
    ("ground", {}, "ground", 2, {}),
    ("dr_long_ring", {}, "ground", 40, {"dr": True}),
    ("torque", {}, "ground", 2, {"torque": True}),
    ("hybrid", {}, "ground", 2, {"hybrid": True}),
    ("pd_latency", {"pd_latency": 1.5 * SimConfig().substep_dt},
     "ground", 3, {}),
    ("on_rack", {"on_rack": True}, "ground", 2, {}),
    ("up_stair", {}, "up_stair", 2, {}),
    ("obstacle", {}, "obstacle", 2, {}),
    ("balance_beam", {}, "balance_beam", 2, {}),
    # lanes past B in the last block, through every barrier
    ("tail", {}, "ground", 40, {"dr": True, "B": TAIL_B}),
    # the ES population rollout's batch (10 blocks), nominal dynamics
    ("es_envs", {}, "ground", 2, {"B": es_batch(QuadrupedConfig().es)}),
    # the deployment loop: one env, 31 idle lanes in its one block
    ("single_env", {}, "ground", 2, {"B": 1}),
    # dynamics ID's population: each env its own draw of all 48
    # parameters, the ring of obs_latency_taps = latency_buffer_len
    # (32, rounded up to a multiple of action_repeat)
    ("dynid_pop", {}, "ground", 40, {"B": 40, "dynid": True}),
]


@pytest.fixture(scope="module")
def physics_vs_plain(cuda):
    """Every case's three control steps through the kernel and through the
    plain version, in the order above from one seeded stream: per case the
    widest per-env gap after step 1, the share of envs over TOL after step
    3, and whether the kernel's state stayed finite."""
    dev = cuda
    rng = np.random.default_rng(0)

    def nrm(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    def start(h_fn, L, spread, Bc):
        rb = sbatch.init_robot(Bc, 0.27, hist_len=L, device=dev)
        pos = rb.s.pos.clone()
        if spread:
            pos[0] = torch.as_tensor(rng.uniform(-0.5, 3.0, Bc),
                                     dtype=torch.float32, device=dev)
            pos[1] = torch.as_tensor(rng.uniform(-0.4, 0.4, Bc),
                                     dtype=torch.float32, device=dev)
            pos[2] = pos[2] + h_fn(pos[0], pos[1])
        pos = pos + nrm(3, Bc, scale=0.01)
        quat = rb.s.quat + nrm(4, Bc, scale=0.02)
        quat = quat / quat.norm(dim=0)
        s = sbatch.BQuadState(pos=pos.contiguous(), quat=quat.contiguous(),
                              w=nrm(3, Bc, scale=0.2), v=nrm(3, Bc, scale=0.1),
                              q=rb.s.q + nrm(12, Bc, scale=0.05),
                              qd=nrm(12, Bc, scale=0.5))
        hist = sbatch._obs_row(s)[None].repeat(L, 1, 1)
        return rb.replace(s=s, obs_hist=hist)

    def env_err(a, b):
        """Per-env max |kernel − plain| over the state and the ring."""
        e = torch.zeros_like(a.s.q[0])
        for f in ("pos", "quat", "w", "v", "q", "qd"):
            e = torch.maximum(e, (getattr(a.s, f) - getattr(b.s, f)).abs().amax(0))
        d = (a.obs_hist - b.obs_hist).abs().amax(dim=(0, 1))
        return torch.maximum(e, d)

    out = {}
    for name, simkw, mode, L, kw in PHYSICS_CASES:
        cfg = SimConfig(**simkw)
        h_fn = terrain.height_fn(TaskConfig(task_mode=mode, terrain_start=0.0))
        Bc = kw.get("B", B)
        rb0 = start(h_fn, L, mode != "ground", Bc)
        p = sbatch.BDynParams.default(Bc, device=dev)
        if kw.get("dr"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            p = randomize.sample_dynamics(Bc, gen, device=dev)
        if kw.get("dynid"):
            p = dynid_dynamics(Bc, dev)
        torque = kw.get("torque", False)
        qd_ref = tau_ff = None
        if kw.get("hybrid"):
            qd_ref, tau_ff = nrm(12, Bc, scale=0.3), nrm(12, Bc, scale=1.5)
        rk, rp, errs = rb0, rb0, []
        for _ in range(3):
            act = (nrm(12, Bc, scale=5.0) if torque else
                   (rb0.s.q + nrm(12, Bc, scale=0.1)).contiguous())
            rk = physics_step.control_step(rk, act, p, cfg, h_fn, torque,
                                           qd_ref=qd_ref, tau_ff=tau_ff)
            rp = sbatch.control_step(rp, act, p, cfg, h_fn, torque,
                                     qd_ref=qd_ref, tau_ff=tau_ff)
            errs.append(env_err(rk, rp))
        torch.cuda.synchronize()
        out[name] = (errs[0].max().item(),
                     (errs[2] > TOL).float().mean().item(),
                     all(torch.isfinite(getattr(rk.s, f)).all().item()
                         for f in ("pos", "quat", "w", "v", "q", "qd")))
    return out


@pytest.mark.parametrize("case", [c[0] for c in PHYSICS_CASES])
def test_physics_kernel_matches_plain(physics_vs_plain, case):
    first_step_err, frac_over_tol, finite = physics_vs_plain[case]
    assert finite
    assert first_step_err <= TOL
    assert frac_over_tol <= MAX_DRIFT_FRAC


# --- the attention kernel ------------------------------------------------------

ATTN_CASES = ["serving", "past_kv", "fully_masked_rows", "ragged",
              "windows_64", "hd16", "hd48", "hd128"]


@pytest.fixture(scope="module")
def attn_cases(cuda):
    """(q, k, v, mask) per case, drawn in the order of ATTN_CASES: the
    serving window and its past-KV decode, rows with no key, ragged T and S
    on hd 32, 64 windows, hd 16, and hd 48 (on the 64 instance) and 128
    with ragged T and S and a row with no key."""
    dev = cuda
    rng = np.random.default_rng(1)
    gen = torch.Generator(dev)
    gen.manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def qkv(B, H, T, S, hd):
        return randn(B, H, T, hd), randn(B, H, S, hd), randn(B, H, S, hd)

    full = (torch.rand(2, 64, 64, generator=gen, device=dev) < 0.5).float()
    full[:, ::3] = 0.0                  # every third row: no key at all
    g_hd = torch.Generator(dev)
    g_hd.manual_seed(3)

    def hd_case(B, H, T, S, hd):
        q, k, v = (torch.randn(shape, generator=g_hd, device=dev)
                   for shape in ((B, H, T, hd), (B, H, S, hd), (B, H, S, hd)))
        m = (torch.rand(B, T, S, generator=g_hd, device=dev) < 0.6).float()
        m[:, T // 2] = 0.0
        return (q, k, v), m

    cases = [
        (qkv(1, 8, 200, 200, 64), window_mask(1, rng, dev)),
        (qkv(1, 8, 20, 200, 64), window_mask(1, rng, dev, past=180, T=20)),
        (qkv(2, 8, 64, 64, 64), full),
        (qkv(2, 3, 37, 53, 32),
         (torch.rand(2, 37, 53, generator=gen, device=dev) < 0.5).float()),
        (qkv(64, 8, 200, 200, 64), window_mask(64, rng, dev)),
        (qkv(2, 4, 40, 40, 16),
         (torch.rand(2, 40, 40, generator=gen, device=dev) < 0.7).float()),
        hd_case(2, 3, 45, 77, 48),
        hd_case(2, 2, 33, 91, 128),
    ]
    return dict(zip(ATTN_CASES, cases))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_kernel_matches_plain(attn_cases, case):
    """Within ATTN_ATOL/ATTN_RTOL of the plain version; a row with no key
    is all zeros."""
    (q, k, v), m = attn_cases[case]
    out = attention.flash_attention(q, k, v, m)
    ref = attention.reference_attention(q, k, v, m)
    torch.cuda.synchronize()
    dead = m.amax(-1) == 0                          # (B,T) rows with no key
    assert torch.isfinite(out).all()
    assert (out.permute(0, 2, 1, 3)[dead] == 0).all()
    torch.testing.assert_close(out, ref, atol=ATTN_ATOL, rtol=ATTN_RTOL)


@pytest.fixture(scope="module")
def ernie_layer0(cuda):
    """Layer 0's q, k, v (317, 12, 64, 64) and mask (a stride-0 view of the
    key-padding rows) of the full-width ERNIE encoder over the 317-row
    catalog padded to 64 tokens."""
    _, model, _, ids = ernie(cuda)
    with torch.no_grad():
        h0, m = model.embed(ids)
        q, k, v = model.attn_0.project(h0)
    return q, k, v, m


def test_attention_kernel_matches_plain_at_ernie_pad(ernie_layer0):
    q, k, v, m = ernie_layer0
    assert m.stride(1) == 0
    out = attention.flash_attention(q, k, v, m)
    ref = attention.reference_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=ATTN_ATOL, rtol=ATTN_RTOL)


def test_split_plan_matches_plain_on_key_partitions_with_no_key(ernie_layer0):
    """ERNIE's shortest rows at the smallest batch whose grid would not fill
    the card: the split plan, some of whose key partitions hold no unmasked
    key, merged against the plain version."""
    q, k, v, m = ernie_layer0
    _, H, T, hd = q.shape
    split_B = next(b for b in (1, 2, 4, 8, 16) if attention.launch_plan(
        b, H, T, hd)["key_partitions"] > 1)
    rows = torch.argsort((m[:, 0] > 0).sum(-1))[:split_B]
    qs, ks, vs = (x[rows].contiguous() for x in (q, k, v))
    msk = m[rows].contiguous()
    per = attention.launch_plan(split_B, H, T, hd)["keys_per_partition"]
    assert (msk[:, 0].reshape(split_B, -1, per).amax(-1) == 0).sum() > 0
    out = attention.flash_attention(qs, ks, vs, msk)
    ref = attention.reference_attention(qs, ks, vs, msk)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=ATTN_ATOL, rtol=ATTN_RTOL)


# --- track_match ---------------------------------------------------------------

def match_cases(rng, n_cases: int):
    """Seeded matching steps: (kind, cost1, iou_cost, status, tsu,
    det_valid, max_cosine_distance) as numpy, T and D from 1 to 32, in six
    kinds: random costs with gated entries, exact ties, costs at the
    threshold and at the clip constant, no eligible row, no eligible
    column, and full square problems without gates (held against scipy)."""
    from paddlerobotics_torch.hri import tracker as trk

    kinds = ("random", "ties", "at_clip", "no_rows", "no_cols", "no_gates")
    out = []
    for i in range(n_cases):
        kind = kinds[i % len(kinds)]
        T, D = (int(x) for x in rng.integers(1, lap.MAX_N + 1, 2))
        max_cos = (0.2, 0.3)[i % 2]
        cost1 = rng.uniform(0.0, 2 * max_cos, (T, D))
        cost1[rng.random((T, D)) < 0.15] = trk.INF
        iou = rng.uniform(0.0, 1.0, (T, D))
        status = rng.integers(0, 3, T)
        tsu = rng.integers(0, 6, T)
        valid = rng.random(D) < 0.8
        if kind == "ties":
            cost1 = rng.choice([0.0, 0.1, 0.2, max_cos], (T, D))
            iou = rng.choice([0.3, 0.6, 0.7, 1.0], (T, D))
        elif kind == "at_clip":
            clip = np.float32(lap.clip_value(max_cos))
            cost1 = rng.choice([max_cos, clip, np.nextafter(
                clip, np.float32(1.0)), 0.5 * max_cos], (T, D))
            iou = rng.choice([0.7, np.float32(lap.clip_value(0.7)), 0.2],
                             (T, D))
        elif kind == "no_rows":
            status = np.zeros(T, int)
        elif kind == "no_cols":
            valid = np.zeros(D, bool)
        elif kind == "no_gates":
            D = min(D, T)
            cost1 = rng.uniform(0.0, max_cos, (T, D))
            iou = rng.uniform(0.0, 1.0, (T, D))
            status = np.full(T, trk.CONFIRMED)
            tsu = np.ones(T, int)
            valid = np.ones(D, bool)
        out.append((kind, cost1.astype(np.float32), iou.astype(np.float32),
                    status.astype(np.int32), tsu.astype(np.int32), valid,
                    max_cos))
    return out


def test_track_match_matches_plain_on_216_seeded_steps(cuda):
    """Assignments, matched masks and the (scans, solves) counts equal to
    the plain version on the host; the no-gate cases at scipy's cost."""
    rng = np.random.default_rng(8)
    # the draws of the 12 frames that the YOLOv3 service took first
    rng.random((12, 416, 416, 3), dtype=np.float32)
    failed = []
    for name, c1, iou, st, ts, dv, mc in match_cases(rng, MATCH_CASES):
        host = [torch.as_tensor(x) for x in (c1, iou, st, ts, dv)]
        work_k = torch.zeros(2, dtype=torch.int32, device=cuda)
        work_p = torch.zeros(2, dtype=torch.int32)
        a_k, m_k = lap.track_match(*[x.to(cuda) for x in host], mc,
                                   work=work_k)
        a_p, m_p = lap.track_match_plain(*host, mc, work=work_p)
        same = (torch.equal(a_k.cpu(), a_p) and torch.equal(m_k.cpu(), m_p)
                and torch.equal(work_k.cpu(), work_p))
        if name == "no_gates":
            r, c = linear_sum_assignment(c1)
            a = a_k.cpu().numpy()
            ours = c1[np.arange(c1.shape[0])[a >= 0], a[a >= 0]].sum(
                dtype=np.float64)
            ref = c1[r, c].sum(dtype=np.float64)
            same &= (int((a >= 0).sum()) == len(r)
                     and abs(ours - ref) / max(ref, 1e-30) <= COST_RTOL)
        if not same:
            failed.append(name)
    assert not failed


# --- the ETG residual ------------------------------------------------------------

ETG_BATCHES = [1, 40, 320, B]           # deploy, dynamics ID, ES, rollout
ETG_H = [20, 48]                        # the default; two chunks a half
ETG_ACT_TOL = 1e-5
# a mask may differ where dz lies this close to a threshold: where cuBLAS
# splits the readout's sum otherwise than the kernel (the split is the
# library's own choice, so its float32 rounding is all the test holds)
ETG_DZ_ROUNDING = 1e-6


@pytest.fixture(scope="module")
def etg_consts(cuda):
    """Each (H, pairing)'s constants, from a one-env env on the card (the
    constants do not depend on the batch), with its fitted readout."""
    out = {}
    for H in ETG_H:
        for pairing in ("trot", "bound"):
            cfg = QuadrupedConfig(etg=dataclasses.replace(
                QuadrupedConfig().etg, H=H, pairing=pairing))
            env = BatchedQuadrupedEnv(cfg, 1, device=cuda)
            out[H, pairing] = (env._etg, env._w0, env._b0)
    return out


def etg_inputs(k, w0, b0, Bx: int, seed: int):
    """The fitted readout perturbed per env, and step indices over ten
    gait periods."""
    g = torch.Generator(device=w0.device).manual_seed(seed)
    w = w0[..., None] + 0.02 * torch.randn(
        (*w0.shape, Bx), generator=g, device=w0.device)
    b = b0[:, None] + 0.01 * torch.randn((3, Bx), generator=g,
                                         device=w0.device)
    steps = round(10 * k.etg.T / k.etg.dt)
    idx = torch.randint(0, steps, (Bx,), generator=g, device=w0.device,
                        dtype=torch.int32)
    return w, b, idx


def composed_dz(k, w, b, idx):
    """dz (4, B) as the composition computes it."""
    t = idx.to(torch.float32) * k.etg.dt
    d = [torch.einsum("xhb,hb->xb", w, etg_residual.phase_features(k, tt))
         + b for tt in (t, t + k.etg.T / 2)]
    return torch.where(k.sel_a, d[0][2][None, :], d[1][2][None, :])


@pytest.mark.parametrize("Bx", ETG_BATCHES)
@pytest.mark.parametrize("H", ETG_H)
@pytest.mark.parametrize("pairing", ["trot", "bound"])
def test_etg_kernel_matches_the_composition(etg_consts, Bx, H, pairing,
                                           record_property):
    """One launch a call; V(t) bit-equal; the residual within ETG_ACT_TOL;
    the masks equal but where dz lies within rounding of a threshold.
    Whether every output is bit-equal (where cuBLAS sums the readout in the
    kernel's two halves, as it did at H=20 for every batch here with the
    cuBLAS the kernel's source names) is recorded as ``bit_equal``, not
    held: the split is cuBLAS's choice, not the kernel's arithmetic."""
    k, w0, b0 = etg_consts[H, pairing]
    w, b, idx = etg_inputs(k, w0, b0, Bx, seed=Bx + H)
    n = etg_residual.etg_residual.launches
    act, swing, stance, v_a = etg_residual.etg_residual(w, b, idx, k)
    p_act, p_swing, p_stance, p_v = etg_residual.plain(w, b, idx, k)
    torch.cuda.synchronize()
    assert etg_residual.etg_residual.launches == n + 1
    assert torch.equal(v_a, p_v)
    assert float((act - p_act).abs().max()) <= ETG_ACT_TOL
    dz = composed_dz(k, w, b, idx)
    sure = ((dz - etg_residual.SWING_Z).abs() > ETG_DZ_ROUNDING) & (
        (dz - etg_residual.STANCE_Z).abs() > ETG_DZ_ROUNDING)
    assert torch.equal(swing[sure], p_swing[sure])
    assert torch.equal(stance[sure], p_stance[sure])
    record_property("bit_equal", bool(
        torch.equal(act, p_act) and torch.equal(swing, p_swing)
        and torch.equal(stance, p_stance)))
    record_property("act_max_abs_diff", float((act - p_act).abs().max()))


def test_etg_kernel_refuses_and_checks_nan(cuda, etg_consts):
    """An H over MAX_H and an input that requires grad under grad mode
    raise on the card path without a launch (the kernel has no backward;
    under ``torch.no_grad()`` the same call launches it); under the NaN
    checks a NaN in the readout raises naming the kernel."""
    k, w0, b0 = etg_consts[20, "trot"]
    w, b, idx = etg_inputs(k, w0, b0, 64, seed=1)
    n = etg_residual.etg_residual.launches
    for args in ((w.clone().requires_grad_(), b, idx),
                 (w, b.clone().requires_grad_(), idx)):
        with pytest.raises(RuntimeError, match="no backward"):
            etg_residual.etg_residual(*args, k)
    assert etg_residual.etg_residual.launches == n
    with torch.no_grad():
        got = etg_residual.etg_residual(w.clone().requires_grad_(), b, idx,
                                        k)[0]
    assert etg_residual.etg_residual.launches == n + 1
    assert torch.equal(got, etg_residual.etg_residual(w, b, idx, k)[0])
    cfg = QuadrupedConfig(etg=dataclasses.replace(
        QuadrupedConfig().etg, H=etg_residual.MAX_H + 1))
    over = BatchedQuadrupedEnv(cfg, 1, device=cuda)
    wo = over._w0[..., None].repeat(1, 1, 64)
    n = etg_residual.etg_residual.launches
    with pytest.raises(ValueError, match="phase features"):
        etg_residual.etg_residual(wo, b, idx, over._etg)
    assert etg_residual.etg_residual.launches == n
    w[0, 0, 3] = float("nan")
    profiler.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError,
                           match=r"etg_residual \(ops/csrc/etg_residual.cu\)"):
            etg_residual.etg_residual(w, b, idx, k)
    finally:
        profiler.enable_nan_checks(False)


# --- the NaN checks and the trace ----------------------------------------------

@pytest.fixture(scope="module")
def env4096(cuda):
    env = BatchedQuadrupedEnv(QuadrupedConfig(), B, device=cuda)
    st0, _ = env.reset(torch.Generator(device=cuda).manual_seed(3))
    return env, st0


def test_nan_checks_raise_inside_both_kernels_and_in_a_backward(cuda, env4096):
    """A clean B=4096 env step is bit-equal with the checks on. Faults
    planted inside each kernel (env 0 without base or leg mass: a singular
    articulated inertia, NaN in that env's state; +inf in q at a masked
    score: inf·0 in the kernel's masked score) and in a backward pass raise
    ``FloatingPointError`` naming their operation with the checks on, and
    pass silently with them off, the kernel's NaN where the plain
    version's is."""
    dev = cuda
    env, st0 = env4096
    zeros = torch.zeros((env.B, 12), device=dev)

    def step(state=st0):
        rng = torch.Generator(device=dev)
        rng.set_state(state.rng.get_state())
        ns, nobs, rew, done, _ = env.step(state.replace(rng=rng), zeros)
        return [nobs, rew, done, ns.robot.obs_hist] + [
            getattr(ns.robot.s, f) for f in ("pos", "quat", "w", "v", "q",
                                             "qd")]

    ref = step()
    p = sbatch.BDynParams.default(env.B, device=dev)
    base, leg = p.base_mass_scale.clone(), p.leg_mass_scale.clone()
    base[0] = 0.0
    leg[:, 0] = 0.0
    st_bad, _ = env.reset(torch.Generator(device=dev).manual_seed(3),
                          dyn=p._replace(base_mass_scale=base,
                                         leg_mass_scale=leg))
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((1, 8, 200, 64), generator=gen, device=dev)
               for _ in range(3))
    mask = torch.ones((1, 200, 200), device=dev)
    mask[0, 0, 100:] = 0.0
    q[0, 0, 0, 0] = float("inf")
    x = torch.zeros(3, device=dev, requires_grad=True)
    (torch.sqrt(x) * 0.0).sum().backward()          # without the checks
    raised = {}
    profiler.enable_nan_checks()
    try:
        got = step()
        torch.cuda.synchronize()
        for name, fault in (
                ("control_step", lambda: step(st_bad)),
                ("flash_attention", lambda: attention.flash_attention(
                    q, k, v, mask)),
                ("backward", lambda: (torch.sqrt(x) * 0.0).sum().backward())):
            try:
                fault()
                torch.cuda.synchronize()
                raised[name] = None
            except FloatingPointError as e:
                raised[name] = str(e)
    finally:
        profiler.enable_nan_checks(False)
    assert not profiler.nan_checks_on
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert "control_step (ops/csrc/physics_step.cu)" in raised["control_step"]
    assert "flash_attention (ops/csrc/attention.cu)" in raised[
        "flash_attention"]
    assert "aten." in raised["backward"]
    # checks off: the same faults pass silently, their NaN in the outputs
    silent_env = step(st_bad)[0]
    with plain_physics():
        plain_env = step(st_bad)[0]
    with torch.no_grad():
        silent_attn = attention.flash_attention(q, k, v, mask)
    x.grad = None
    (torch.sqrt(x) * 0.0).sum().backward()
    assert silent_env[0].isnan().any()
    assert silent_env[1:].isfinite().all()
    assert torch.equal(silent_env.isnan(), plain_env.isnan())
    assert silent_attn.isnan().any()
    assert x.grad.isnan().all()


def test_trace_holds_three_physics_kernels_and_env_step_ranges(cuda, env4096,
                                                               tmp_path):
    env, st0 = env4096
    zeros = torch.zeros((env.B, 12), device=cuda)
    state = st0
    physics_step.control_step.launches = 0
    with profiler.trace(str(tmp_path)) as path:
        for _ in range(3):
            with profiler.annotate("env_step"):
                state = env.step(state, zeros)[0]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and
               "control_step_kernel" in e.get("name", "")]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and
              e.get("name") == "env_step"]
    assert physics_step.control_step.launches == 3
    assert len(kernels) == 3
    assert len(ranges) == 3


def test_traced_replay_runs_two_etg_kernels_a_step(cuda, env4096, tmp_path):
    """Three replays of the graphed step at B=4096 under the profiler: two
    ETG kernels a step, one GEMV a step (the observation's latency blend,
    ``sim/sbatch.delayed_obs``; the composition's readout ran four more),
    and ``etg_launches`` 2 a step."""
    env, st0 = env4096
    zeros = torch.zeros((env.B, 12), device=cuda)
    state = st0
    for _ in range(2):                  # the key's capture, then a replay
        state = env.step(state, zeros)[0]
    replays = env.graph_stats["replays"]
    n = etg_residual.etg_residual.launches
    profiler.collect_counters()
    with profiler.trace(str(tmp_path)) as path:
        for _ in range(3):
            state = env.step(state, zeros)[0]
    counters = profiler.collect_counters()
    profiler.collect_spans()
    with open(path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    assert env.graph_stats["replays"] == replays + 3
    assert sum("etg_residual_kernel" in k for k in kernels) == 6
    assert sum("gemv" in k.lower() for k in kernels) == 3
    assert counters.get("etg_launches") == 6
    assert etg_residual.etg_residual.launches == n + 6
