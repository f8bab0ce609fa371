"""Diffusion Policy's ``Upsample1d`` (``ops/upsample1d.py``): a torch model
of the kernel's polyphase split against ``F.conv_transpose1d`` on the CPU
at the U-Net's two shapes (C=512, L=4 and C=256, L=8), the module's
parameters under their published names, the wrapper's CPU dispatch (the
plain ``F.conv_transpose1d``, with its gradients), spans and counters, and
what ``check_args`` refuses.

On a card (marked ``cuda``, skipped without one; run with
``python -m pytest --noconftest -m cuda tests/test_torch_upsample1d.py``):
the kernel (``ops/csrc/upsample1d.cu``) against ``F.conv_transpose1d``
with TF32 off at B = 1, 3, 64 and 4096; one U-Net call and one DDIM-10
sample at the published widths at B=4096 against the plain reference
within the chunk cell's limits, two launches a U-Net call; the refusals
on the card.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import diffusion_policy_ref as ref
from paddlerobotics_torch.algos import diffusion_policy as dp
from paddlerobotics_torch.ops import kernel_time
from paddlerobotics_torch.ops import upsample1d as up
from paddlerobotics_torch.utils import profiler
from torch_card import cuda  # noqa: F401

SHAPES = [(512, 4), (256, 8)]           # (C, L) of the U-Net's two levels
PUBLISHED = dp.DiffusionConfig()
SMALL = dp.DiffusionConfig(down_dims=(16, 32, 64), step_embed_dim=16)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def operands(B, C, L, seed=0, device="cpu"):
    """x ~ N(0, 1), the weight with variance 1 over its fan-in (C·4, as
    the reference's ``make_weights``), the bias 0.1·N."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, C, L, generator=g, device=device)
    w = torch.randn(C, C, 4, generator=g, device=device) / math.sqrt(4 * C)
    b = 0.1 * torch.randn(C, generator=g, device=device)
    return x, w, b


def polyphase(x, weight, bias):
    """The kernel's arithmetic: each phase one product over K = 2C (x at t
    with x at t−1 or t+1, against two taps), interleaved, then the bias."""
    L = x.shape[-1]
    xp = F.pad(x, (1, 1))
    cur, prev, nxt = xp[..., 1:L + 1], xp[..., :L], xp[..., 2:]
    even = torch.einsum("bkt,ko->bot", torch.cat((cur, prev), 1),
                        torch.cat((weight[..., 1], weight[..., 3])))
    odd = torch.einsum("bkt,ko->bot", torch.cat((cur, nxt), 1),
                       torch.cat((weight[..., 2], weight[..., 0])))
    return torch.stack((even, odd), -1).flatten(-2) + bias[:, None]


def scaled_gap(got, want):
    """The widest difference over the reference's widest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B", [1, 3, 5])
@pytest.mark.parametrize("C,L", SHAPES)
def test_polyphase_split_matches_conv_transpose1d(C, L, B):
    """The kernel's split, two 2-tap products interleaved, equals the
    transposed convolution to float32 rounding of 2C-term sums in another
    order."""
    x, w, b = operands(B, C, L, seed=B)
    want = F.conv_transpose1d(x, w, b, stride=2, padding=1)
    got = polyphase(x, w, b)
    assert got.shape == (B, C, 2 * L)
    assert scaled_gap(got, want) < 2e-6


@pytest.mark.parametrize("C,L", SHAPES + [(3, 4), (2, 8)])
def test_bound_counts_the_taps_the_function_needs(C, L):
    """``ops.kernel_time.upsample_bound`` counts 2·B·C²·(4L−2) FLOPs: the
    input-output pairs that the map's Jacobian links, one FMA each (the
    zero taps at a sequence's ends left out), counted here at B=1, C=1."""
    jac = torch.autograd.functional.jacobian(
        lambda x: F.conv_transpose1d(x, torch.ones(1, 1, 4), stride=2,
                                     padding=1), torch.ones(1, 1, L))
    taps = int((jac != 0).sum())
    assert taps == 4 * L - 2
    bd = kernel_time.upsample_bound(4096, C, L)
    assert bd["flops"] == 2 * 4096 * C * C * taps
    if (C, L) in SHAPES:
        assert bd["bound_by"] == "operations"
        assert bd["bound_ms"] == pytest.approx(
            {512: 0.448728, 256: 0.240390}[C], abs=1e-6)


def test_module_keeps_its_parameters_and_loads_conv_transpose1d():
    """``Upsample1d`` keeps ``conv.weight`` (d, d, 4) and ``conv.bias``
    (d,); an ``nn.ConvTranspose1d``'s state dict loads strictly and the
    module then computes what it does. At the published widths the U-Net's
    two up levels hold them under ``up_modules.N.2.conv``."""
    d = 32
    mod = dp.Upsample1d(d)
    assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == {
        "conv.weight": (d, d, 4), "conv.bias": (d,)}
    conv = nn.ConvTranspose1d(d, d, 4, 2, 1)
    mod.load_state_dict({f"conv.{k}": v for k, v in
                         conv.state_dict().items()}, strict=True)
    x = torch.randn(3, d, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(mod(x), conv(x), rtol=0,
                                   atol=2e-6 * float(conv(x).abs().max()))
    net = dp.ConditionalUnet1D(PUBLISHED, device="meta")
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()
              if ".2.conv." in k and k.startswith("up_modules")}
    assert shapes == {"up_modules.0.2.conv.weight": (512, 512, 4),
                      "up_modules.0.2.conv.bias": (512,),
                      "up_modules.1.2.conv.weight": (256, 256, 4),
                      "up_modules.1.2.conv.bias": (256,)}


def test_cpu_dispatch_spans_and_counters():
    """On the CPU the wrapper returns ``F.conv_transpose1d``'s result bit
    for bit and launches nothing: one DDIM-10 replan with spans on holds 20
    ``policy.diffusion.upsample`` spans, each inside a
    ``policy.diffusion.unet``, and no ``upsample_launches`` count."""
    x, w, b = operands(3, 64, 4)
    launches = up.upsample1d.launches
    torch.testing.assert_close(
        up.upsample1d(x, w, b),
        F.conv_transpose1d(x, w, b, stride=2, padding=1), rtol=0, atol=0)
    pol = dp.DiffusionPolicy(SMALL, device="cpu")
    pol.load_state_dict(ref.make_weights(
        {k: getattr(SMALL, k) for k in SMALL.__dataclass_fields__},
        torch.Generator().manual_seed(0)))
    pol.requires_grad_(False)
    g = torch.Generator().manual_seed(2)
    hist = torch.randn(4, SMALL.n_obs_steps, SMALL.obs_dim, generator=g)
    noise = torch.randn(4, SMALL.horizon, SMALL.action_dim, generator=g)
    profiler.collect_spans()
    profiler.collect_counters()
    profiler.enable_spans(True)
    try:
        pol.predict_action(hist, noise)
    finally:
        profiler.enable_spans(False)
    spans = profiler.collect_spans()
    counts = profiler.collect_counters()
    by_id = {s.id: s for s in spans}
    ups = [s for s in spans if s.name == "policy.diffusion.upsample"]
    assert len(ups) == 20
    assert all(by_id[s.parent].name == "policy.diffusion.unet" for s in ups)
    assert counts["unet_calls"] == 10 and "upsample_launches" not in counts
    assert up.upsample1d.launches == launches


def test_cpu_keeps_autograd_and_check_args_refuses():
    """On the CPU ``Upsample1d`` trains as ``nn.ConvTranspose1d`` does:
    the same gradients bit for bit. ``check_args`` refuses what the kernel
    does not take."""
    d = 16
    mod = dp.Upsample1d(d)
    conv = nn.ConvTranspose1d(d, d, 4, 2, 1)
    conv.load_state_dict(mod.conv.state_dict())
    x, _, _ = operands(2, d, 4)
    mod(x).square().sum().backward()
    conv(x).square().sum().backward()
    torch.testing.assert_close(mod.conv.weight.grad, conv.weight.grad,
                               rtol=0, atol=0)
    torch.testing.assert_close(mod.conv.bias.grad, conv.bias.grad,
                               rtol=0, atol=0)
    x, w, b = operands(2, d, 4)
    up.check_args(x, w, b)
    bad = [((x.repeat(1, 1, 4), w, b), "length 16"),
           ((x.transpose(1, 2).contiguous().transpose(1, 2), w, b),
            "not contiguous"),
           ((x.double(), w, b), "dtype"),
           ((x, w[:8], b), "weight: shape"),
           ((x, w, b[:8]), "bias: shape"),
           ((x[0], w, b), "expected \\(B, C, L\\)")]
    for args, msg in bad:
        with pytest.raises((ValueError, TypeError), match=msg):
            up.check_args(*args)


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 64, 4096])
@pytest.mark.parametrize("C,L", SHAPES)
def test_kernel_matches_conv_transpose1d(cuda, C, L, B):
    """The kernel against cuDNN's transposed convolution in float32 (TF32
    off): within 1e-5 of the output's scale, in one launch."""
    x, w, b = operands(B, C, L, seed=B, device=cuda)
    want = F.conv_transpose1d(x, w, b, stride=2, padding=1)
    launches = up.upsample1d.launches
    got = up.upsample1d(x, w, b)
    torch.cuda.synchronize()
    assert up.upsample1d.launches == launches + 1
    assert got.shape == want.shape
    assert scaled_gap(got, want) <= 1e-5


@pytest.mark.cuda
def test_unet_and_ddim_at_b4096_within_the_cells_limits(cuda):
    """The published U-Net at B=4096 on the reference's seeded weights: one
    call's ε and the DDIM-10 plan against the plain reference
    (``F.conv_transpose1d`` there) within the chunk cell's ``eps_gap``
    (4e-4) and ``chunk_gap`` (7e-3), gaps as the benchmark's (over the
    larger of the reference's widest magnitude and 1); two kernel launches
    and two ``upsample_launches`` per U-Net call."""
    d = {k: getattr(PUBLISHED, k) for k in PUBLISHED.__dataclass_fields__}
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

    def gap(p, r):
        return float((p - r).abs().max() / max(float(r.abs().max()), 1.0))

    t = torch.full((B,), 90.0, device=cuda)
    with torch.no_grad():
        cond = pol.global_cond(hist)
        launches = up.upsample1d.launches
        eps = pol.model(noise, t, cond)
        assert up.upsample1d.launches - launches == 2
        eps_ref = ref.unet(w, noise, t, ref.global_cond(w, hist, d), d)
    assert gap(eps, eps_ref) <= 4e-4
    profiler.collect_counters()
    profiler.enable_spans(True)
    try:
        launches = up.upsample1d.launches
        plan = pol.predict_action(hist, noise)
    finally:
        profiler.enable_spans(False)
    counts = profiler.collect_counters()
    assert up.upsample1d.launches - launches == 20
    assert counts["upsample_launches"] == 2 * counts["unet_calls"] == 20
    with torch.no_grad():
        plan_ref = ref.ddim_sample(w, hist, noise, d)
    assert gap(plan, plan_ref) <= 7e-3


@pytest.mark.cuda
def test_kernel_refuses_without_falling_back(cuda):
    """On the card the wrapper raises where the kernel cannot run: under
    grad, for a length it has no instance of, for a strided input."""
    x, w, b = operands(4, 64, 4, device=cuda)
    launches = up.upsample1d.launches
    with pytest.raises(RuntimeError, match="no backward"):
        up.upsample1d(x, w.clone().requires_grad_(), b)
    with pytest.raises(ValueError, match="length 16"):
        up.upsample1d(x.repeat(1, 1, 4), w, b)
    with pytest.raises(ValueError, match="not contiguous"):
        up.upsample1d(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    assert up.upsample1d.launches == launches
