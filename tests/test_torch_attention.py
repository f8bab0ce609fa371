"""Port parity of the masked flash attention (``ops/attention.py``).

The port's plain version and its dispatcher on CPU tensors (which runs the
plain version and launches nothing) are held against the JAX package's
``flash_attention`` in interpret mode and ``reference_attention``, at the
tolerance of ``tests/test_pallas_attention.py``: atol 2e-5, rtol 1e-4
(float32 sums taken in another order). So is a model of the CUDA kernel's
arithmetic (``ops/csrc/attention.cu``): its key tiles and their order, the
online softmax, products in three TF32 passes and the merge of split-key
partials. The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``.
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.hri.transformer import (frame_ids_to_attn_mask as
                                                j_frame_mask,
                                                merge_padding_mask as j_merge)
from paddlerobotics_tpu.ops.pallas.attention import (flash_attention as
                                                     j_flash,
                                                     reference_attention as
                                                     j_reference)

from paddlerobotics_torch.hri import transformer
from paddlerobotics_torch.ops import attention

ATOL, RTOL = 2e-5, 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _block_causal():
    B, H, T, hd = 2, 4, 40, 16
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, H, T, hd).astype(np.float32) for _ in range(3))
    fids = np.repeat(np.arange(1, 5), 10)[None].repeat(B, 0)
    pad = np.ones((B, T), np.float32)
    pad[:, 7:10] = 0.0
    mask = np.asarray(j_merge(j_frame_mask(jnp.asarray(fids)),
                              jnp.asarray(pad)))
    return q, k, v, mask, 16


def _fully_masked():
    B, H, T, hd = 1, 2, 8, 8
    q = k = v = np.ones((B, H, T, hd), np.float32)
    mask = np.zeros((B, T, T), np.float32)
    mask[:, :4, :4] = 1.0
    return q, k, v, mask, 8


def _past_kv():
    # one new frame of 20 tokens against a 200-token cache + itself
    B, H, T, S, hd = 1, 4, 20, 200, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, H, T, hd), np.float32)
    k = rng.standard_normal((B, H, S, hd), np.float32)
    v = rng.standard_normal((B, H, S, hd), np.float32)
    mask = (rng.random((B, T, S)) > 0.3).astype(np.float32)
    mask[:, 3] = 0.0                                   # a fully masked row
    return q, k, v, mask, 32


def _ragged():
    B, H, T, S, hd = 2, 3, 37, 53, 32
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, T, hd), np.float32)
    k = rng.standard_normal((B, H, S, hd), np.float32)
    v = rng.standard_normal((B, H, S, hd), np.float32)
    mask = (rng.random((B, T, S)) > 0.5).astype(np.float32)
    return q, k, v, mask, 16


def _serving():
    # the controller's call: B=1, H=8, T=S=200, hd=64, block-causal over 10
    # frames of 20 tokens with padding holes (absent detections)
    B, H, T, hd = 1, 8, 200, 64
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((B, H, T, hd), np.float32)
               for _ in range(3))
    fids = np.repeat(np.arange(1, 11), 20)[None]
    keep = rng.integers(1, 21, size=(B, 10))
    pad = (np.arange(20)[None, None] < keep[..., None]).reshape(B, T)
    mask = np.asarray(j_merge(j_frame_mask(jnp.asarray(fids)),
                              jnp.asarray(pad.astype(np.float32))))
    assert (mask.max(-1) == 0).any()                   # rows with no key
    return q, k, v, mask, 128


def _ernie_pad():
    # the utterance encoder's call: key-padding masks of short utterances
    # padded to 64 tokens, so most keys of most rows are masked and whole
    # key partitions of the split plan hold no unmasked key
    B, H, T, hd = 3, 4, 64, 64
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, H, T, hd), np.float32)
               for _ in range(3))
    lengths = np.array([3, 9, 64])
    pad = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    mask = np.ascontiguousarray(np.broadcast_to(pad[:, None, :], (B, T, T)))
    return q, k, v, mask, 16


CASES = {"block_causal": _block_causal, "fully_masked": _fully_masked,
         "past_kv": _past_kv, "ragged": _ragged, "ernie_pad": _ernie_pad}
_JAX_OUT = {}


def _jax_outputs(case):
    """(inputs, JAX reference, JAX flash in interpret mode), once per case."""
    if case not in _JAX_OUT:
        q, k, v, mask, block = {**CASES, "serving": _serving}[case]()
        jargs = [jnp.asarray(x) for x in (q, k, v, mask)]
        _JAX_OUT[case] = ((q, k, v, mask), np.asarray(j_reference(*jargs)),
                          np.asarray(j_flash(*jargs, block_t=block,
                                             block_s=block, interpret=True)))
    return _JAX_OUT[case]


@pytest.mark.parametrize("case", list(CASES))
def test_attention_matches_jax(case):
    q, k, v, mask, block = CASES[case]()
    jargs = [jnp.asarray(x) for x in (q, k, v, mask)]
    ref_j = np.asarray(j_reference(*jargs))
    flash_j = np.asarray(j_flash(*jargs, block_t=block, block_s=block,
                                 interpret=True))
    targs = [torch.tensor(np.array(x)) for x in (q, k, v, mask)]
    launches = attention.flash_attention.launches
    plain = attention.reference_attention(*targs).numpy()
    disp = attention.flash_attention(*targs).numpy()
    assert attention.flash_attention.launches == launches
    for got in (plain, disp):
        np.testing.assert_allclose(got, ref_j, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, flash_j, atol=ATOL, rtol=RTOL)
    if case == "fully_masked":
        np.testing.assert_array_equal(disp[:, :, 4:], 0.0)
    assert np.isfinite(disp).all()


def _tf32(x):
    """cvt.rna.tf32.f32 on the bits: round to nearest, ties away from zero,
    to 10 mantissa bits (the low 13 bits of the float32 cleared)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _mm3(a, b):
    """a @ b in three TF32 passes: a_hi·b_lo + a_lo·b_hi + a_hi·b_hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def _kernel_model(q, k, v, mask, wide):
    """The kernel's arithmetic in float32. Wide blocks: each 16-row tile
    walks every key tile of 32. Split blocks: 4 partitions, partition w
    takes key tiles w, w+4, ... of 32 (16 at hd=128), then the (max, sum,
    acc) partials merge."""
    NEG = attention.NEG_INF
    hd, S = q.shape[-1], k.shape[2]
    bn = 16 if not wide and hd > 64 else 32
    n_part = 1 if wide else 4
    m = mask[:, None]
    parts = []
    for w in range(n_part):
        m_run = torch.full(q.shape[:3] + (1,), NEG)
        l_run = torch.zeros(q.shape[:3] + (1,))
        acc = torch.zeros(q.shape)
        for j in range(w, math.ceil(S / bn), n_part):
            sl = slice(j * bn, (j + 1) * bn)
            mk = m[..., sl]
            s = _mm3(q, k[:, :, sl].transpose(-1, -2)) * hd ** -0.5
            s = s * mk + NEG * (1.0 - mk)
            m_cur = torch.maximum(m_run, s.amax(-1, keepdim=True))
            alpha = torch.exp(m_run - m_cur)
            p = torch.exp(s - m_cur) * mk
            l_run = l_run * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _mm3(p, v[:, :, sl])
            m_run = m_cur
        parts.append((m_run, l_run, acc))
    M = torch.stack([p_[0] for p_ in parts]).amax(0)
    f = [torch.exp(m_ - M) for m_, _, _ in parts]
    if n_part == 1:                       # no merge: the scales are 1
        f = [torch.ones_like(M)]
    L = sum(l_ * f_ for (_, l_, _), f_ in zip(parts, f))
    acc = sum(a_ * f_ for (_, _, a_), f_ in zip(parts, f))
    return acc / L.clamp_min(1e-20)


@pytest.mark.parametrize("blocks", ["wide", "split"])
@pytest.mark.parametrize("case", [*CASES, "serving"])
def test_kernel_model_matches_jax(case, blocks):
    (q, k, v, mask), ref_j, flash_j = _jax_outputs(case)
    got = _kernel_model(*(torch.tensor(np.array(x)) for x in (q, k, v, mask)),
                        wide=blocks == "wide").numpy()
    np.testing.assert_allclose(got, ref_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, flash_j, atol=ATOL, rtol=RTOL)
    dead = mask.max(-1) == 0                           # (B,T) rows, no key
    np.testing.assert_array_equal(got.transpose(0, 2, 1, 3)[dead], 0.0)
    assert dead.any() or case in ("block_causal", "ragged", "ernie_pad")


def test_tf32_split_is_float32_accurate():
    """One TF32 pass is ~1e-3 off on these products; three passes are as
    close as float32."""
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.standard_normal((64, 64), np.float32))
    b = torch.tensor(rng.standard_normal((64, 64), np.float32))
    exact = a.double() @ b.double()
    one = (_tf32(a) @ _tf32(b)).double()
    assert (one - exact).abs().max() > 1e-3
    assert (_mm3(a, b).double() - exact).abs().max() < 2e-5
    assert (_tf32(torch.tensor([1.0 + 2 ** -11])) ==       # a tie: away
            torch.tensor([1.0 + 2 ** -10])).all()


def test_frame_and_padding_masks_match_jax():
    fids = np.array([[1, 1, 2, 2, 3, 3], [1, 2, 2, 3, 3, 3]])
    pad = np.array([[1, 0, 1, 1, 1, 0], [1, 1, 1, 0, 1, 1]], np.float32)
    j = np.asarray(j_merge(j_frame_mask(jnp.asarray(fids)), jnp.asarray(pad)))
    t = transformer.merge_padding_mask(
        transformer.frame_ids_to_attn_mask(torch.as_tensor(fids)),
        torch.as_tensor(pad)).numpy()
    np.testing.assert_array_equal(t, j)


def test_launch_args_layout():
    """The kernel's arguments: strides of the head-split views, the mask
    read per batch, the output a (B,H,T,hd) view of (B,T,H,hd); head dims
    the kernel has no instance for are refused."""
    B, T, H, hd, S = 2, 5, 4, 16, 7
    qkv = torch.zeros(B, T, 3 * H * hd)
    q = qkv[..., :H * hd].reshape(B, T, H, hd).transpose(1, 2)
    k = torch.zeros(B, H, S, hd)
    mask = torch.ones(B, T, S)
    ptrs, ints, out = attention.launch_args(q, k, k, mask)
    assert ints[:5] == [B, H, T, S, hd]
    assert ints[5:8] == [T * 3 * H * hd, hd, 3 * H * hd]
    assert ints[14:16] == [T * S, S]
    assert tuple(out.shape) == (B, H, T, hd)
    assert ints[16:19] == [T * H * hd, hd, H * hd]
    assert len(ptrs) == 5
    for hd_ in (8, 48, 128):               # on the instance of 16, 64, 128
        x = torch.zeros(1, 1, 4, hd_)
        assert attention.launch_args(x, x, x, torch.ones(1, 4, 4))[1][4] == hd_
    for hd_ in (12, 136):
        x = torch.zeros(1, 1, 4, hd_)
        with pytest.raises(ValueError, match="head dim"):
            attention.launch_args(x, x, x, torch.ones(1, 4, 4))
    with pytest.raises(ValueError, match="mask"):
        attention.launch_args(q, k, k, torch.ones(B, T, S + 1))
    # cp.async copies 16 bytes: a view one float off, or with rows 10
    # floats apart, is refused
    off = torch.zeros(B, H, S * hd + 1)[..., 1:].reshape(B, H, S, hd)
    with pytest.raises(ValueError, match="16-byte"):
        attention.launch_args(q, off, k, mask)
    rows10 = torch.zeros(B, H, S, 10)[..., :8]
    with pytest.raises(ValueError, match="16-byte"):
        attention.launch_args(torch.zeros(B, H, T, 8), rows10,
                              torch.zeros(B, H, S, 8), mask)


def test_attn_bound_at_the_serving_shape():
    """chip_smoke's bound of one controller call (B=1, H=8, T=S=200,
    hd=64): 81.9 MFLOP, 1.80 MB, 0.54 µs set by bytes at 3.35 TB/s (three
    TF32 passes at 495 TFLOP/s take 0.50 µs)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    bd = chip_smoke.attn_bound(1, 8, 200, 200, 64)
    assert bd["flops"] == 81_920_000
    assert bd["bytes"] == 1_798_400
    assert bd["bound_by"] == "bytes"
    assert round(bd["bound_ms"] * 1e3, 2) == 0.54
    assert round(bd["bound_ops_tc_ms"] * 1e3, 2) == 0.50
    assert round(bd["bound_ops_fp32_ms"] * 1e3, 2) == 1.22
    assert bd["bound_ms"] == max(bd["bound_bytes_ms"], bd["bound_ops_tc_ms"])


@pytest.mark.parametrize("grad_input", ["q", "k", "v", "mask"])
def test_flash_attention_refuses_autograd(grad_input):
    """The kernel has no backward (nor has the JAX one), so its wrapper
    raises under grad mode when an input requires grad — on the CPU's plain
    path too — instead of returning an output with no gradient to the
    projections before it; under ``torch.no_grad()`` the same call runs.
    A materialized call (``masked_attention``) trains through."""
    q, k, v, mask, _ = CASES["block_causal"]()
    args = dict(zip("q k v mask".split(),
                    (torch.tensor(np.array(x)) for x in (q, k, v, mask))))
    args[grad_input].requires_grad_(True)
    launches = attention.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        attention.flash_attention(**args)
    with torch.no_grad():
        out = attention.flash_attention(**args)
    assert attention.flash_attention.launches == launches
    assert not out.requires_grad
    ref, _ = attention.masked_attention(**args)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=ATOL,
                               rtol=RTOL)
    if grad_input != "mask":
        ref.sum().backward()
        assert args[grad_input].grad is not None
