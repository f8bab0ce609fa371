"""Diffusion Policy's ``Conv1dBlock`` tail (``ops/groupnorm_mish.py``): on
the CPU, the wrapper's path is the published ``Conv1d → GroupNorm → Mish``
and FiLM or residual bit for bit; the blocks against the plain reference's
``res_block``; a float64 model of the kernel's arithmetic (the bias, two-pass
biased statistics, Mish, the epilogue) against ``plain`` at the published
shapes; the U-Net's 25 calls and the bytes ``kernel_time.groupnorm_bound``
counts for them; parameter names; no ``norm_launches`` on the CPU; what
``check_args`` refuses.

On a card (marked ``cuda``, skipped without one; run with
``python -m pytest --noconftest -m cuda tests/test_torch_groupnorm_mish.py``):
the kernel (``ops/csrc/groupnorm_mish.cu``) against ``plain`` with TF32
off at the five published (C, L), each epilogue, B = 1, 3, 64 and 4096,
and at the small U-Net's shapes; ``conv_groupnorm_mish`` against the
composition on a transposed input; the refusals; the NaN checks; the
published U-Net and DDIM-10 at B=4096 against the plain reference, 25
launches a U-Net call.

The row path (one group of length 1: LayerNorm, TD-MPC2's ``NormedLinear``
tail): on the CPU ``linear_norm_act`` and ``heads_linear_norm_act`` are the
published ``F.linear → F.layer_norm → Mish / SimNorm`` bit for bit, and a
float64 model of the row kernel's arithmetic against ``row_plain`` at the
planner's shapes; on the card the kernel against ``row_plain`` at those
shapes (Mish, SimNorm, the 5-head ensemble both ways), the GEMM-and-kernel
path against the composition, its refusals and NaN check.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import diffusion_policy_ref as ref
from paddlerobotics_torch.algos import diffusion_policy as dp
from paddlerobotics_torch.ops import groupnorm_mish as gn
from paddlerobotics_torch.ops import kernel_time
from paddlerobotics_torch.ops import upsample1d as up
from paddlerobotics_torch.utils import profiler
from torch_card import cuda  # noqa: F401

PUBLISHED_SHAPES = [(256, 16), (512, 8), (1024, 4), (512, 4), (256, 8)]
SMALL_SHAPES = [(16, 16), (32, 8), (64, 4), (32, 4), (16, 8)]
EPILOGUES = ["none", "film", "residual", "residual_bias"]
PUBLISHED = dp.DiffusionConfig()
SMALL = dp.DiffusionConfig(down_dims=(16, 32, 64), step_embed_dim=16)
GROUPS = 8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def operands(B, C, L, epilogue, seed=0, device="cpu"):
    """h ~ N(0, 1) (a convolution's output), the vectors as the reference's
    ``make_weights`` draws them (bias and shift 0.1·N, scale 1 + 0.1·N),
    FiLM's (B, 2C) and the residual ~ N(0, 1): (h, kwargs of ``plain``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    h = randn(B, C, L)
    kw = dict(bias=0.1 * randn(C), gamma=1 + 0.1 * randn(C),
              beta=0.1 * randn(C), groups=GROUPS, eps=1e-5)
    if epilogue == "film":
        kw["film"] = randn(B, 2 * C)
    elif epilogue.startswith("residual"):
        kw["res"] = randn(B, C, L)
        if epilogue == "residual_bias":
            kw["res_bias"] = 0.1 * randn(C)
    return h, kw


def scaled_gap(got, want):
    """The widest difference over the larger of the reference's widest
    magnitude and 1."""
    return float((got - want).abs().max() / max(float(want.abs().max()), 1.0))


def kernel_model(h, bias, gamma, beta, groups, eps, film=None, res=None,
                 res_bias=None):
    """The kernel's arithmetic in float64: each (env, group) row of
    (C/groups)·L floats plus the channel's bias; its mean, then the mean of
    the squared deviations (biased); (v − μ)·γ/√(var + eps) + β; Mish as
    u·tanh(log1p(exp(u))); then FiLM or the residual with its bias."""
    d = lambda t: None if t is None else t.double()
    h, bias, gamma, beta = d(h), d(bias), d(gamma), d(beta)
    B, C, L = h.shape
    v = (h + bias[:, None]).reshape(B, groups, -1)
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    u = ((v - mu) / torch.sqrt(var + eps)).reshape(B, C, L)
    u = u * gamma[:, None] + beta[:, None]
    m = u * torch.tanh(torch.log1p(torch.exp(u)))
    if film is not None:
        film = d(film)
        return film[:, :C, None] * m + film[:, C:, None]
    if res is not None:
        return m + d(res) + (0 if res_bias is None else d(res_bias)[:, None])
    return m


# --- on the CPU ----------------------------------------------------------------

def published_block(inp, out, k=5, groups=GROUPS, seed=0):
    """``nn.Conv1d → nn.GroupNorm → nn.Mish`` as published, seeded."""
    torch.manual_seed(seed)
    return nn.Sequential(nn.Conv1d(inp, out, k, padding=k // 2),
                         nn.GroupNorm(groups, out), nn.Mish())


@pytest.mark.parametrize("epilogue", ["none", "film", "residual",
                                      "residual_conv"])
@pytest.mark.parametrize("inp,C,L", [(12, 16, 16), (64, 32, 8)])
def test_cpu_path_is_the_published_composition(inp, C, L, epilogue):
    """On the CPU ``conv_groupnorm_mish`` returns what ``nn.Conv1d``,
    ``nn.GroupNorm``, ``nn.Mish`` and FiLM (``embed[:, 0]·h +
    embed[:, 1]``) or the residual add (through ``nn.Conv1d(k=1)``) return,
    bit for bit, and their gradients."""
    blk = published_block(inp, C)
    conv, norm = blk[0], blk[1]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, inp, L, generator=g).requires_grad_()
    film = torch.randn(3, 2 * C, generator=g)
    rc = nn.Conv1d(inp, C, 1)
    res = torch.randn(3, C, L, generator=g)
    want = blk(x)
    kw = {}
    if epilogue == "film":
        embed = film.reshape(-1, 2, C, 1)
        want, kw = embed[:, 0] * want + embed[:, 1], {"film": film}
    elif epilogue == "residual":
        want, kw = want + res, {"res": res}
    elif epilogue == "residual_conv":
        want = want + rc(x)
        kw = {"res": x, "res_weight": rc.weight, "res_bias": rc.bias}
    got = gn.conv_groupnorm_mish(x, conv.weight, conv.bias, norm.weight,
                                 norm.bias, norm.num_groups, norm.eps,
                                 conv.padding[0], **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    gw, gx = torch.autograd.grad(got.square().sum(), (conv.weight, x))
    ww, wx = torch.autograd.grad(want.square().sum(), (conv.weight, x))
    torch.testing.assert_close(gw, ww, rtol=0, atol=0)
    torch.testing.assert_close(gx, wx, rtol=0, atol=0)


@pytest.mark.parametrize("inp,out", [(12, 16), (16, 16)])
def test_residual_block_is_the_references_bit_for_bit(inp, out):
    """A ``ConditionalResidualBlock1D`` with and without its 1×1 residual
    convolution keeps the published parameter names and, on the CPU,
    computes the reference's ``res_block`` bit for bit."""
    cfg = dataclasses.asdict(SMALL)
    blk = dp.ConditionalResidualBlock1D(inp, out, 20, 5, GROUPS)
    names = {"blocks.0.block.0.weight", "blocks.0.block.0.bias",
             "blocks.0.block.1.weight", "blocks.0.block.1.bias",
             "blocks.1.block.0.weight", "blocks.1.block.0.bias",
             "blocks.1.block.1.weight", "blocks.1.block.1.bias",
             "cond_encoder.1.weight", "cond_encoder.1.bias"}
    if inp != out:
        names |= {"residual_conv.weight", "residual_conv.bias"}
    assert set(blk.state_dict()) == names
    g = torch.Generator().manual_seed(inp)
    p = {f"b.{k}": 0.3 * torch.randn(v.shape, generator=g)
         for k, v in blk.state_dict().items()}
    blk.load_state_dict({k[2:]: v for k, v in p.items()}, strict=True)
    x = torch.randn(4, inp, 16, generator=g)
    cond = torch.randn(4, 20, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(blk(x, cond),
                                   ref.res_block(p, "b", x, cond, cfg),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("epilogue", ["none", "film", "residual_bias"])
@pytest.mark.parametrize("C,L", PUBLISHED_SHAPES)
def test_plain_matches_a_model_of_the_kernels_arithmetic(C, L, epilogue):
    """``plain`` (PyTorch's GroupNorm and Mish in float32) against the
    kernel's formulas in float64 at the published shapes: within 2e-6 of
    the output's scale, float32 rounding of 512-term statistics and of
    outputs of order 10 (the FiLM scale is ~N(0, 1))."""
    h, kw = operands(2, C, L, epilogue, seed=C + L)
    got = gn.plain(h, **kw)
    assert got.shape == (2, C, L) and got.dtype == torch.float32
    assert scaled_gap(got.double(), kernel_model(h, **kw)) <= 2e-6


def test_unet_runs_25_blocks_whose_bytes_the_bound_counts():
    """The published U-Net calls ``conv_groupnorm_mish`` 25 times, at the
    (C, L, epilogue) that ``kernel_time.UNET_NORM_BLOCKS`` lists (five of
    the residuals through a 1×1 convolution); ``groupnorm_bound`` counts
    227,328 floats an env over them (one read and one write of each block
    output, FiLM's and the residuals' reads) plus the per-channel vectors:
    3.72 GB and 1.11 ms at B=4096."""
    seen = []
    real = dp.conv_groupnorm_mish

    def record(x, weight, *a, film=None, res=None, res_weight=None, **k):
        out = real(x, weight, *a, film=film, res=res, res_weight=res_weight,
                   **k)
        kind = ("film" if film is not None else
                "residual" if res is not None else "none")
        seen.append((out.shape[1], out.shape[2], kind,
                     res_weight is not None))
        return out

    pol = dp.DiffusionPolicy(PUBLISHED, device="cpu").requires_grad_(False)
    dp.conv_groupnorm_mish = record
    try:
        pol.model(torch.zeros(1, 16, 12), torch.zeros(1),
                  torch.zeros(1, PUBLISHED.cond_dim - 256))
    finally:
        dp.conv_groupnorm_mish = real
    assert len(seen) == 25 and sum(s[3] for s in seen) == 5
    want = {}
    for C, L, kind, n in kernel_time.UNET_NORM_BLOCKS:
        want[(C, L, kind)] = want.get((C, L, kind), 0) + n
    got = {}
    for C, L, kind, _ in seen:
        got[(C, L, kind)] = got.get((C, L, kind), 0) + 1
    assert got == want
    B = 4096
    bounds = [(n, kernel_time.groupnorm_bound(B, C, L, kind))
              for C, L, kind, n in kernel_time.UNET_NORM_BLOCKS]
    vectors = sum(n * 4 * (3 * C + (C if kind == "residual" else 0))
                  for C, L, kind, n in kernel_time.UNET_NORM_BLOCKS)
    total = sum(n * b["bytes"] for n, b in bounds)
    assert total - vectors == 4 * B * 227_328
    assert all(b["bound_by"] == "bytes" for _, b in bounds)
    assert sum(n * b["bound_ms"] for n, b in bounds) == pytest.approx(
        1.1118644, abs=1e-6)


def test_no_norm_launches_on_the_cpu():
    """One DDIM-10 replan of the small policy on the CPU with spans on:
    ``unet_calls`` 10, no ``norm_launches`` counter, no launch counted."""
    pol = dp.DiffusionPolicy(SMALL, device="cpu")
    pol.load_state_dict(ref.make_weights(dataclasses.asdict(SMALL),
                                         torch.Generator().manual_seed(0)))
    pol.requires_grad_(False)
    g = torch.Generator().manual_seed(2)
    hist = torch.randn(4, SMALL.n_obs_steps, SMALL.obs_dim, generator=g)
    noise = torch.randn(4, SMALL.horizon, SMALL.action_dim, generator=g)
    launches = gn.groupnorm_mish.launches
    profiler.collect_counters()
    profiler.enable_spans(True)
    try:
        pol.predict_action(hist, noise)
    finally:
        profiler.enable_spans(False)
    counts = profiler.collect_counters()
    assert counts["unet_calls"] == 10 and "norm_launches" not in counts
    assert gn.groupnorm_mish.launches == launches


def test_check_args_refuses():
    """``check_args`` refuses what the kernel does not take: dtype, shapes,
    strides, groups of more than 512 floats, lengths not a multiple of 4,
    FiLM and a residual at once, a residual bias without a residual."""
    h, kw = operands(2, 64, 8, "residual_bias")
    vecs = {k: kw[k] for k in ("bias", "gamma", "beta", "groups")}
    gn.check_args(h, **vecs, res=kw["res"], res_bias=kw["res_bias"])
    film = torch.zeros(2, 128)
    bad = [((h.double(),), {}, "dtype"),
           ((h.transpose(1, 2).contiguous().transpose(1, 2),), {},
            "not contiguous"),
           ((h,), {"res": kw["res"].transpose(0, 1).contiguous()
                   .transpose(0, 1)}, "res: not contiguous"),
           ((h,), {"film": film[:, :64]}, "film: shape"),
           ((h,), {"res_bias": kw["res_bias"]}, "res_bias without res"),
           ((h,), {"film": film, "res": kw["res"]}, "not both"),
           ((torch.zeros(2, 1024, 8),), {}, "bias: shape"),
           ((h[0],), {}, "\\(B, C, L\\)"),
           ((torch.zeros(2, 64, 6),), {}, "multiples of 4")]
    for args, extra, msg in bad:
        with pytest.raises((ValueError, TypeError), match=msg):
            gn.check_args(*args, **{**vecs, **extra})
    big = torch.zeros(2, 2048, 4)
    with pytest.raises(ValueError, match="group of 1024 floats"):
        gn.check_args(big, torch.zeros(2048), torch.zeros(2048),
                      torch.zeros(2048), 8)
    with pytest.raises(ValueError, match="res_bias without res_weight"):
        gn.conv_groupnorm_mish(h, torch.zeros(64, 64, 5), *vecs.values(),
                               1e-5, 2, res_bias=kw["res_bias"])


# --- on the card ---------------------------------------------------------------

def _launch_once(h, kw):
    launches = gn.groupnorm_mish.launches
    got = gn.groupnorm_mish(h, **kw)
    torch.cuda.synchronize()
    assert gn.groupnorm_mish.launches == launches + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 64, 4096])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("C,L", PUBLISHED_SHAPES)
def test_kernel_matches_plain(cuda, C, L, epilogue, B):
    """The kernel against PyTorch's chain (``plain``) in float32 on the
    card, in one launch: within 1e-5 of the output's scale (statistics of
    256–512 terms summed in another order, two passes against Welford, and
    Mish's functions, each a few float32 roundings of values of order 1
    to 10)."""
    h, kw = operands(B, C, L, epilogue, seed=B, device=cuda)
    got = _launch_once(h, kw)
    want = gn.plain(h, **kw)
    assert got.shape == want.shape
    assert scaled_gap(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("C,L", SMALL_SHAPES)
def test_kernel_at_the_small_unets_shapes(cuda, C, L, epilogue):
    """Groups of 16 and 32 floats (the tests' small U-Net) run the
    smallest instance, most lanes idle, to the same tolerance."""
    h, kw = operands(3, C, L, epilogue, seed=C * L, device=cuda)
    assert gn.launch_plan(3, C, L, GROUPS)["floats_per_lane"] == 4
    assert scaled_gap(_launch_once(h, kw), gn.plain(h, **kw)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["film", "residual", "residual_conv"])
def test_conv_groupnorm_mish_matches_the_composition(cuda, epilogue):
    """The U-Net's first block on the card: a transposed (B, 12, 16) input
    through the bias-less convolutions and the kernel, against the
    published composition (cuDNN with its biases, GroupNorm, Mish, FiLM or
    the residual) at B=64, to the kernel's tolerance."""
    blk = published_block(12, 256).to(cuda)
    conv, norm = blk[0], blk[1]
    rc = nn.Conv1d(12, 256, 1).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(64, 16, 12, generator=g, device=cuda).transpose(1, 2)
    film = torch.randn(64, 512, generator=g, device=cuda)
    res = torch.randn(64, 256, 16, generator=g, device=cuda)
    with torch.no_grad():
        want = blk(x)
        kw = {}
        if epilogue == "film":
            want, kw = film[:, :256, None] * want + film[:, 256:, None], {
                "film": film}
        elif epilogue == "residual":
            want, kw = want + res, {"res": res}
        else:
            want = want + rc(x)
            kw = {"res": x, "res_weight": rc.weight, "res_bias": rc.bias}
        launches = gn.groupnorm_mish.launches
        got = gn.conv_groupnorm_mish(x, conv.weight, conv.bias, norm.weight,
                                     norm.bias, GROUPS, norm.eps, 2, **kw)
    torch.cuda.synchronize()
    assert gn.groupnorm_mish.launches == launches + 1
    assert scaled_gap(got, want) <= 1e-5


@pytest.mark.cuda
def test_kernel_refuses_without_falling_back(cuda):
    """On the card the wrapper raises where the kernel cannot run: under
    grad, for a dtype, a strided residual, a group of 1024 floats, a
    length that is not a multiple of 4; nothing is launched."""
    h, kw = operands(4, 64, 8, "residual", device=cuda)
    launches = gn.groupnorm_mish.launches
    with pytest.raises(RuntimeError, match="no backward"):
        gn.groupnorm_mish(h, **{**kw, "gamma": kw["gamma"].clone()
                                .requires_grad_()})
    with pytest.raises(TypeError, match="dtype"):
        gn.groupnorm_mish(h.double(), **kw)
    with pytest.raises(ValueError, match="res: not contiguous"):
        gn.groupnorm_mish(h, **{**kw, "res": kw["res"].transpose(0, 1)
                                .contiguous().transpose(0, 1)})
    big, bkw = operands(2, 2048, 4, "none", device=cuda)
    with pytest.raises(ValueError, match="group of 1024 floats"):
        gn.groupnorm_mish(big, **bkw)
    odd, okw = operands(2, 64, 6, "none", device=cuda)
    with pytest.raises(ValueError, match="multiples of 4"):
        gn.groupnorm_mish(odd, **okw)
    assert gn.groupnorm_mish.launches == launches


@pytest.mark.cuda
def test_nan_checks_name_the_kernel(cuda):
    """Under the NaN checks a NaN in the kernel's output raises
    ``FloatingPointError`` naming ``groupnorm_mish``; off, it passes."""
    h, kw = operands(8, 256, 16, "film", device=cuda)
    h[3, 40, 5] = float("nan")
    assert bool(torch.isnan(gn.groupnorm_mish(h, **kw)).any())
    profiler.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match="groupnorm_mish"):
            gn.groupnorm_mish(h, **kw)
    finally:
        profiler.enable_nan_checks(False)


@pytest.mark.cuda
def test_unet_and_ddim_at_b4096_against_the_reference(cuda):
    """The published U-Net at B=4096 on the reference's seeded weights:
    one call's ε and the DDIM-10 plan against the plain reference (cuDNN
    with its biases, PyTorch's GroupNorm and Mish,
    ``F.conv_transpose1d``), gaps as the benchmark's, at float32 rounding:
    ε within 1e-5 and the plan within 2e-4 (the upsample kernel alone
    reads ~1.3e-6 and ~2.3e-5 here; the chunk cell's limits are 4e-4 and
    7e-3). 25 launches and 25 ``norm_launches`` per U-Net call."""
    d = dataclasses.asdict(PUBLISHED)
    B = 4096
    pol = dp.DiffusionPolicy(PUBLISHED, device=cuda)
    w = ref.make_weights(d, torch.Generator(device=cuda).manual_seed(0))
    pol.load_state_dict(w)
    pol.requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(1)
    hist = torch.randn(B, PUBLISHED.n_obs_steps, PUBLISHED.obs_dim,
                       generator=g, device=cuda)
    noise = torch.randn(B, PUBLISHED.horizon, PUBLISHED.action_dim,
                        generator=g, device=cuda)
    t = torch.full((B,), 90.0, device=cuda)
    with torch.no_grad():
        cond = pol.global_cond(hist)
        launches = gn.groupnorm_mish.launches
        eps = pol.model(noise, t, cond)
        assert gn.groupnorm_mish.launches - launches == 25
        eps_ref = ref.unet(w, noise, t, ref.global_cond(w, hist, d), d)
    assert scaled_gap(eps, eps_ref) <= 1e-5
    profiler.collect_counters()
    profiler.enable_spans(True)
    try:
        launches = gn.groupnorm_mish.launches, up.upsample1d.launches
        plan = pol.predict_action(hist, noise)
    finally:
        profiler.enable_spans(False)
    counts = profiler.collect_counters()
    assert (gn.groupnorm_mish.launches - launches[0],
            up.upsample1d.launches - launches[1]) == (250, 20)
    assert counts["norm_launches"] == 25 * counts["unet_calls"] == 250
    with torch.no_grad():
        plan_ref = ref.ddim_sample(w, hist, noise, d)
    assert scaled_gap(plan, plan_ref) <= 2e-4


# --- the row path (L = 1) ----------------------------------------------------

# (rows, C, act, heads, head_div) of the TD-MPC2 planner's tails at B=256 ×
# 512 samples: the hidden layers (Mish), the dynamics' SimNorm, the Q
# ensemble after its shared GEMM (head_div 1) and its batched one
# (head_div = rows per head); the encoder's 256-wide layer; a small width.
ROW_SHAPES = [(131072, 512, "mish", 1, 1), (131072, 512, "simnorm", 1, 1),
              (655360, 512, "mish", 5, 1), (655360, 512, "mish", 5, 131072),
              (256, 256, "mish", 1, 1), (96, 64, "simnorm", 1, 1)]
ROW_IDS = ["mish", "simnorm", "heads_shared", "heads_batched", "encoder",
           "small_simnorm"]


def row_operands(R, C, heads, seed=0, device="cpu"):
    """h ~ N(0, 1) (a GEMM's output) and the per-head vectors as the
    reference's ``make_weights`` draws them."""
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    shape = (C,) if heads == 1 else (heads, C)
    return randn(R, C), dict(bias=0.1 * randn(*shape),
                             gamma=1 + 0.1 * randn(*shape),
                             beta=0.1 * randn(*shape), eps=1e-5)


def row_model(h, bias, gamma, beta, eps, act, dim=8, head_div=1):
    """The row kernel's arithmetic in float64: each row plus its head's
    bias, two-pass biased statistics, (v − μ)·γ/√(var + eps) + β, then
    Mish or a max-shifted softmax over groups of ``dim``."""
    h = h.double()
    R, C = h.shape
    heads = bias.shape[0] if bias.dim() == 2 else 1
    k = (torch.arange(R) // head_div) % heads
    pick = lambda t: (t.double()[k] if t.dim() == 2 else t.double())
    v = h + pick(bias)
    mu = v.mean(-1, keepdim=True)
    var = ((v - mu) ** 2).mean(-1, keepdim=True)
    u = (v - mu) / torch.sqrt(var + eps) * pick(gamma) + pick(beta)
    if act == "mish":
        return u * torch.tanh(torch.log1p(torch.exp(u)))
    x = u.view(R, -1, dim)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).view(R, C)


@pytest.mark.parametrize("act", ["mish", "simnorm"])
def test_row_path_cpu_is_the_published_composition(act):
    """On the CPU ``linear_norm_act`` returns what ``nn.Linear``,
    ``nn.LayerNorm`` and ``nn.Mish`` or the published SimNorm return, bit
    for bit, and its gradients; ``heads_linear_norm_act`` is the same head
    by head, on a shared input and on one input a head."""
    torch.manual_seed(1)
    lin, ln = nn.Linear(20, 64), nn.LayerNorm(64)
    x = torch.randn(6, 20).requires_grad_()
    y = ln(lin(x))
    want = F.mish(y) if act == "mish" else F.softmax(
        y.view(6, 8, 8), -1).view(6, 64)
    got = gn.linear_norm_act(x, lin.weight, lin.bias, ln.weight, ln.bias,
                             ln.eps, act)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    gw, gx = torch.autograd.grad(got.square().sum(), (lin.weight, x))
    ww, wx = torch.autograd.grad(want.square().sum(), (lin.weight, x))
    torch.testing.assert_close(gw, ww, rtol=0, atol=0)
    torch.testing.assert_close(gx, wx, rtol=0, atol=0)
    g = torch.Generator().manual_seed(2)
    w = torch.randn(3, 64, 20, generator=g)
    vecs = [torch.randn(3, 64, generator=g) for _ in range(3)]
    for inp in (x.detach(), torch.randn(3, 6, 20, generator=g)):
        got = gn.heads_linear_norm_act(inp, w, *vecs, 1e-5, act)
        for k in range(3):
            xk = inp if inp.dim() == 2 else inp[k]
            want = gn.linear_norm_act(xk, w[k], vecs[0][k], vecs[1][k],
                                      vecs[2][k], 1e-5, act)
            torch.testing.assert_close(got[k], want, rtol=0, atol=0)


@pytest.mark.parametrize("R,C,act,heads,head_div", [
    (max(R // 2048, 16), C, act, heads, max(div // 2048, 1))
    for R, C, act, heads, div in ROW_SHAPES], ids=ROW_IDS)
def test_row_plain_matches_a_model_of_the_kernels_arithmetic(R, C, act,
                                                             heads, head_div):
    """``row_plain`` (PyTorch's LayerNorm, Mish and softmax in float32,
    each row its head's parameters) against the row kernel's formulas in
    float64, at the planner's widths with fewer rows: within 2e-6 of the
    output's scale."""
    h, kw = row_operands(R, C, heads, seed=C + heads)
    got = gn.row_plain(h, act=act, head_div=head_div, **kw)
    assert got.shape == (R, C) and got.dtype == torch.float32
    assert scaled_gap(got.double(),
                      row_model(h, act=act, head_div=head_div, **kw)) <= 2e-6


def test_check_rows_refuses():
    """``check_rows`` refuses what the row kernel does not take: an
    unknown activation, dtype, shapes, strides, rows of more than 512 or
    not a multiple of 4 floats, rows that do not split into the heads,
    SimNorm groups that do not tile the row."""
    h, kw = row_operands(12, 64, 3)
    vecs = [kw[k] for k in ("bias", "gamma", "beta")]
    gn.check_rows(h, *vecs, "mish", 8, 4)
    bad = [((h, *vecs, "relu", 8, 1), "act"),
           ((h.double(), *vecs, "mish", 8, 1), "dtype"),
           ((h.t().contiguous().t(), *vecs, "mish", 8, 1), "not contiguous"),
           ((h[0], *vecs, "mish", 8, 1), "\\(rows, C\\)"),
           ((h, vecs[0][:, :32], *vecs[1:], "mish", 8, 1), "bias: shape"),
           ((h, vecs[0], vecs[1][:2], vecs[2], "mish", 8, 1), "gamma: shape"),
           ((h, *vecs, "mish", 8, 5), "blocks of 3 heads"),
           ((h, *vecs, "simnorm", 24, 1), "SimNorm groups")]
    for args, msg in bad:
        with pytest.raises((ValueError, TypeError), match=msg):
            gn.check_rows(*args)
    for C in (1024, 66):
        big, bkw = row_operands(4, C, 1)
        with pytest.raises(ValueError, match="multiples of 4 up to 512"):
            gn.check_rows(big, bkw["bias"], bkw["gamma"], bkw["beta"],
                          "mish", 8, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,act,heads,head_div", ROW_SHAPES, ids=ROW_IDS)
def test_row_kernel_matches_plain(cuda, R, C, act, heads, head_div):
    """The row kernel against ``row_plain`` in float32 on the card at the
    planner's shapes, in one launch: within 1e-5 of the output's scale
    (512-term statistics in another order, Mish's functions or a softmax
    of 8)."""
    h, kw = row_operands(R, C, heads, seed=R % 977, device=cuda)
    launches = gn.groupnorm_mish.launches
    got = gn.row_norm(h, act=act, head_div=head_div, **kw)
    torch.cuda.synchronize()
    assert gn.groupnorm_mish.launches == launches + 1
    want = gn.row_plain(h, act=act, head_div=head_div, **kw)
    assert scaled_gap(got, want) <= 1e-5
    assert gn.row_launch_plan(R, C)["floats_per_lane"] == (
        4 if C <= 128 else 8 if C <= 256 else 16)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("act", ["mish", "simnorm"])
def test_linear_norm_act_matches_the_composition_on_the_card(cuda, act,
                                                             shared):
    """The bias-less GEMM and the row kernel against cuBLAS with the bias,
    ``F.layer_norm`` and the activation, for one layer and for 5 heads (a
    shared input through one GEMM, one input a head through a batched
    one), at 4096 rows of 524 → 512: within 1e-5 of the output's scale."""
    g = torch.Generator(device=cuda).manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=g, device=cuda)
    w = randn(5, 512, 524) / 524 ** 0.5
    vecs = [0.1 * randn(5, 512), 1 + 0.1 * randn(5, 512),
            0.1 * randn(5, 512)]
    x = randn(4096, 524) if shared else randn(5, 4096, 524)
    sn = lambda y: (F.mish(y) if act == "mish" else
                    F.softmax(y.view(*y.shape[:-1], 64, 8), -1).view(y.shape))
    with torch.no_grad():
        got = gn.heads_linear_norm_act(x, w, *vecs, 1e-5, act)
        one = gn.linear_norm_act(x if shared else x[0], w[0], vecs[0][0],
                                 vecs[1][0], vecs[2][0], 1e-5, act)
        for k in range(5):
            xk = x if shared else x[k]
            want = sn(F.layer_norm(F.linear(xk, w[k], vecs[0][k]), (512,),
                                   vecs[1][k], vecs[2][k], 1e-5))
            assert scaled_gap(got[k], want) <= 1e-5
            if k == 0:
                assert scaled_gap(one, want) <= 1e-5


@pytest.mark.cuda
def test_row_kernel_refuses_and_checks_nan(cuda):
    """On the card the row path raises where the kernel cannot run (under
    grad, a dtype, a row of 1024 floats), launches nothing then, and under
    the NaN checks names the kernel."""
    h, kw = row_operands(64, 512, 1, device=cuda)
    launches = gn.groupnorm_mish.launches
    with pytest.raises(RuntimeError, match="no backward"):
        gn.row_norm(h, **{**kw, "gamma": kw["gamma"].clone()
                          .requires_grad_()})
    with pytest.raises(TypeError, match="dtype"):
        gn.row_norm(h.double(), **kw)
    big, bkw = row_operands(4, 1024, 1, device=cuda)
    with pytest.raises(ValueError, match="up to 512"):
        gn.row_norm(big, **bkw)
    assert gn.groupnorm_mish.launches == launches
    h[3, 40] = float("nan")
    assert bool(torch.isnan(gn.row_norm(h, **kw)).any())
    profiler.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match="row_norm"):
            gn.row_norm(h, **kw)
    finally:
        profiler.enable_nan_checks(False)
