"""Transformer decoder with past-KV incremental decoding (port of the JAX
package's ``hri/transformer.py``).

- ``MaskedMultiHeadAttention``: fused QKV projection without bias, scores
  masked as ``s·m − 1e10·(1−m)``, softmax weights re-masked, past-KV
  concatenated along the source axis. With ``use_kernel`` it calls
  ``ops/attention.flash_attention`` (the CUDA kernel on the card, its plain
  version on the CPU) and returns zero weights, as the flash path of the
  JAX module does; otherwise the materialized path.
- ``TransformerDecoderBlock``: frame embeddings added to the block input at
  every layer, post-norm (default) or pre-norm, tanh-GELU MLP, LayerNorm
  eps 1e-6 (flax's defaults).
- ``TransformerDecoder``: per-token hidden states, per-frame max pool under
  the padding mask, stacked present-KV, stacked attention weights.

Submodules carry the flax scope names (``block_0``,
``MaskedMultiHeadAttention_0``, ``LayerNorm_0``, ``Dense_0`` …), so
``convert.load_flax`` carries weights across by path. Activations are
(B, T, D) as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.ops import attention

NEG_INF = -1e10


def frame_ids_to_attn_mask(frame_ids: torch.Tensor) -> torch.Tensor:
    """(B,T) non-decreasing frame ids → (B,T,T) block mask,
    ``mask[b,i,j] = frame_ids[b,j] <= frame_ids[b,i]``."""
    q = frame_ids[..., :, None]
    k = frame_ids[..., None, :]
    return (k <= q).to(torch.float32)


def merge_padding_mask(attn_mask: torch.Tensor,
                       padding_mask: torch.Tensor) -> torch.Tensor:
    """attn_mask (B,T,S) ∧ outer(padding, padding)."""
    pm = padding_mask[..., :, None] * padding_mask[..., None, :]
    T = attn_mask.shape[-2]
    return attn_mask * pm[..., -T:, :]


class MaskedMultiHeadAttention(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, device=None):
        super().__init__()
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.qkv_fc = nn.Linear(model_dim, 3 * model_dim, bias=False,
                                device=device)
        self.out_fc = nn.Linear(model_dim, model_dim, bias=False,
                                device=device)

    def forward(self, x, attn_mask, past_kv=None, use_kernel=False):
        """x (B,T,D); attn_mask (B,T,S); past_kv (B,2,H,P,hd) or None.
        Returns (attn_out (B,T,D), present_kv (B,2,H,T,hd), weights)."""
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = self.qkv_fc(x).split(self.model_dim, dim=-1)

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        present_kv = torch.stack([k, v], dim=1)
        if past_kv is not None:
            k = torch.cat([past_kv[:, 0], k], dim=-2)
            v = torch.cat([past_kv[:, 1], v], dim=-2)

        if use_kernel:
            attn = attention.flash_attention(q, k, v, attn_mask)
            # the kernel never materializes the scores: the weights output
            # is a zero placeholder, as in the JAX module's flash path
            weights = x.new_zeros(()).expand(B, H, T, k.shape[-2])
        else:
            attn, weights = attention.masked_attention(q, k, v, attn_mask)
        attn = attn.transpose(1, 2).reshape(B, T, D)
        return self.out_fc(attn), present_kv, weights


class TransformerDecoderBlock(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, ffn_dim: int,
                 normalize_before: bool = False, device=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.MaskedMultiHeadAttention_0 = MaskedMultiHeadAttention(
            model_dim, num_heads, device=device)
        self.LayerNorm_0 = nn.LayerNorm(model_dim, eps=1e-6, device=device)
        self.LayerNorm_1 = nn.LayerNorm(model_dim, eps=1e-6, device=device)
        self.Dense_0 = nn.Linear(model_dim, ffn_dim, device=device)
        self.Dense_1 = nn.Linear(ffn_dim, model_dim, device=device)

    def mlp(self, h):
        return self.Dense_1(F.gelu(self.Dense_0(h), approximate="tanh"))

    def forward(self, x, frame_emb, attn_mask, padding_mask, past_kv=None,
                past_padding_mask=None, use_kernel=False):
        if past_padding_mask is not None:
            padding_mask = torch.cat([past_padding_mask, padding_mask], -1)
            pad = attn_mask.new_ones(attn_mask.shape[:-1] +
                                     (past_padding_mask.shape[-1],))
            attn_mask = torch.cat([pad, attn_mask], dim=-1)
        attn_mask = merge_padding_mask(attn_mask, padding_mask)
        mha, ln1, ln2 = (self.MaskedMultiHeadAttention_0, self.LayerNorm_0,
                         self.LayerNorm_1)
        if self.normalize_before:
            x_ = ln1(x)
            x_ = x_ if frame_emb is None else x_ + frame_emb
            attn, present_kv, w = mha(x_, attn_mask, past_kv, use_kernel)
            x = x + attn
            x = x + self.mlp(ln2(x))
        else:
            x = x if frame_emb is None else x + frame_emb
            attn, present_kv, w = mha(x, attn_mask, past_kv, use_kernel)
            x = ln1(x + attn)
            x = ln2(x + self.mlp(x))
        return x, present_kv, w


class TransformerDecoder(nn.Module):
    def __init__(self, num_blocks: int, model_dim: int, num_heads: int,
                 ffn_dim: int, tokens_per_frame: int = 10,
                 normalize_before: bool = False, device=None):
        super().__init__()
        self.num_blocks = num_blocks
        self.tokens_per_frame = tokens_per_frame
        for i in range(num_blocks):
            setattr(self, f"block_{i}", TransformerDecoderBlock(
                model_dim, num_heads, ffn_dim, normalize_before,
                device=device))

    def forward(self, x, frame_emb, attn_mask, padding_mask,
                past_kv_arr: Optional[torch.Tensor] = None,
                past_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: bool = False):
        """Returns (hid, frame_hid, present_kv_arr, attn_weights_arr)."""
        presents, weights = [], []
        for i in range(self.num_blocks):
            past_kv = None if past_kv_arr is None else past_kv_arr[:, i]
            x, pkv, w = getattr(self, f"block_{i}")(
                x, frame_emb, attn_mask, padding_mask, past_kv,
                past_padding_mask, use_kernel)
            presents.append(pkv)
            weights.append(w)
        present_kv_arr = torch.stack(presents, dim=1)
        if use_kernel:      # zero placeholders: a view, nothing allocated
            w = weights[0][:, None]
            attn_weights_arr = w.expand(w.shape[0], self.num_blocks,
                                        *w.shape[2:])
        else:
            attn_weights_arr = torch.stack(weights, dim=1)

        B, T, D = x.shape
        nf = T // self.tokens_per_frame
        pm = padding_mask[..., -T:, None]
        h = pm * x + NEG_INF * (1.0 - pm)
        frame_hid = h.reshape(B, nf, self.tokens_per_frame, D).amax(dim=2)
        return x, frame_hid, present_kv_arr, attn_weights_arr
