"""Port parity of the masked flash attention (``ops/attention.py``).

The port's plain version and its dispatcher on CPU tensors (which runs the
plain version and launches nothing) are held against the JAX package's
``flash_attention`` in interpret mode and ``reference_attention``, at the
tolerance of ``tests/test_pallas_attention.py``: atol 2e-5, rtol 1e-4
(float32 sums taken in another order). The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""

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


CASES = {"block_causal": _block_causal, "fully_masked": _fully_masked,
         "past_kv": _past_kv, "ragged": _ragged}


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
    with pytest.raises(ValueError, match="head dim"):
        attention.launch_args(torch.zeros(1, 1, 4, 48),
                              torch.zeros(1, 1, 4, 48),
                              torch.zeros(1, 1, 4, 48), torch.ones(1, 4, 4))
    with pytest.raises(ValueError, match="mask"):
        attention.launch_args(q, k, k, torch.ones(B, T, S + 1))
