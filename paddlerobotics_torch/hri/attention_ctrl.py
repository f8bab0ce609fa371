"""Attention controller: transformer decoder over visual tokens with
trigger / object / action heads (port of the JAX package's
``hri/attention_ctrl.py``, the ``visual_token`` input).

- inputs: F frames × K tokens of 562-d visual tokens, projected without
  bias (``vt_fc``);
- frame-id embedding table ``wfe`` (F+1, D), id 0 is padding (zero row),
  added at every decoder block input;
- block-causal attention from frame ids, padding mask over absent
  detections;
- heads: trigger (per frame, on the frame-pooled hidden state), obj_cls
  (per token), action (frame hidden · projected action embeddings ``wae``);
- test time: temperature softmax + top-k sampling without the null action.

``AttnCtrlConfig`` keeps every field of the JAX dataclass with its name and
default, so a bundle manifest's ``ctrl_cfg`` loads unchanged. The
``instance`` / ``without_*`` inputs, ``controller_loss`` and training are
not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.transformer import (TransformerDecoder,
                                                  frame_ids_to_attn_mask)
from paddlerobotics_torch.utils.init import flax_default_


@dataclasses.dataclass(frozen=True)
class AttnCtrlConfig:
    inputs_type: str = "visual_token"
    num_actions: int = 1000
    act_tr_dim: int = 778          # concat(one-hot act, one-hot exp, ERNIE 768)
    num_frames: int = 10
    tokens_per_frame: int = 20
    inst_fm_reduce_dim: int = 128
    inst_fm_flatten_dim: int = 512
    inst_cls_dim: int = 80
    inst_pos_dim: int = 50
    visual_token_dim: int = 562
    model_dim: int = 512
    num_decoder_blocks: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    dropout: float = 0.0
    normalize_before: bool = False
    trigger_loss_coef: float = 5.0
    obj_loss_coef: float = 1.0
    act_loss_coef: float = 1.0
    use_last_act_loss: bool = False
    use_pallas_attention: bool = False


class TriggerHead(nn.Module):
    """MLP → 1 logit."""

    def __init__(self, in_dim: int, hidden_dims: tuple = (256,), device=None):
        super().__init__()
        dims = (in_dim, *hidden_dims, 1)
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f"Dense_{i}",
                    nn.Linear(dims[i], dims[i + 1], device=device))

    def forward(self, feat):
        h = feat
        for i in range(self.n - 1):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n - 1}")(h)[..., 0]


class AttentionController(nn.Module):
    """``use_pallas_attention`` selects the hand-written kernel
    (``ops/attention.flash_attention``) in every block; ``forward``'s
    ``use_kernel`` overrides it for one call. Runs on the card unless
    ``device`` says otherwise; ``generator`` draws flax-default weights."""

    def __init__(self, cfg: AttnCtrlConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.inputs_type != "visual_token":
            raise NotImplementedError(
                f"inputs_type {cfg.inputs_type!r}: the port has the "
                "visual_token input only")
        device = resolve_device(device)
        self.cfg = cfg
        D = cfg.model_dim
        self.vt_fc = nn.Linear(cfg.visual_token_dim, D, bias=False,
                               device=device)
        self.wfe = nn.Parameter(torch.zeros(cfg.num_frames + 1, D,
                                            device=device))
        self.decoder = TransformerDecoder(
            cfg.num_decoder_blocks, D, cfg.num_heads, cfg.ffn_dim,
            tokens_per_frame=cfg.tokens_per_frame,
            normalize_before=cfg.normalize_before, device=device)
        self.trigger = TriggerHead(D, device=device)
        self.obj_cls = TriggerHead(D, device=device)
        self.wae = nn.Parameter(torch.zeros(cfg.num_actions + 1,
                                            cfg.act_tr_dim, device=device))
        self.wae_proj = nn.Linear(cfg.act_tr_dim, D, device=device)
        if generator is not None:
            flax_default_(self, generator)
            with torch.no_grad():      # flax uniform(1.0): U[0, 1)
                for p in (self.wfe, self.wae):
                    p.copy_(torch.rand(p.shape, generator=generator,
                                       device=generator.device))

    def forward(self, tokens: dict, frame_ids: torch.Tensor,
                padding_mask: torch.Tensor,
                past_kv_arr: Optional[torch.Tensor] = None,
                past_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> dict:
        """tokens {'visual_tokens': (B,T,562)}; frame_ids (B,T) int;
        padding_mask (B,T) float. Returns the JAX module's dict: hid,
        frame_hid, trigger_logits, obj_logits, act_logits, present_kv_arr,
        attn_weights."""
        cfg = self.cfg
        if use_kernel is None:
            use_kernel = cfg.use_pallas_attention
        x = self.vt_fc(tokens["visual_tokens"])
        frame_emb = torch.where((frame_ids > 0)[..., None],
                                self.wfe[frame_ids], 0.0)
        attn_mask = frame_ids_to_attn_mask(frame_ids)
        hid, frame_hid, present_kv, attn_w = self.decoder(
            x, frame_emb, attn_mask, padding_mask, past_kv_arr=past_kv_arr,
            past_padding_mask=past_padding_mask, use_kernel=use_kernel)

        trigger_logits = self.trigger(frame_hid)        # (B,F)
        obj_logits = self.obj_cls(hid)                  # (B,T)
        wae_proj = self.wae_proj(self.wae[:cfg.num_actions])
        act_logits = torch.einsum("bfd,ad->bfa", frame_hid, wae_proj)
        return {
            "hid": hid, "frame_hid": frame_hid,
            "trigger_logits": trigger_logits, "obj_logits": obj_logits,
            "act_logits": act_logits, "present_kv_arr": present_kv,
            "attn_weights": attn_w,
        }


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with u in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def top_k_sampling(act_logits: torch.Tensor, temperature: float, top_k: int,
                   null_act_idx: int = 0,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Temperature + top-k sampling without the null action.
    act_logits (B,F,A) → ids (B,F).

    Sampling is ``argmax(log p + g)`` with Gumbel noise g, as
    ``jax.random.categorical`` draws it: ``noise`` (the shape of
    ``act_logits``) is used when given, else g is drawn from
    ``generator``."""
    logits = act_logits / temperature
    mask = torch.ones(logits.shape[-1], device=logits.device)
    mask[null_act_idx] = 0.0
    logits = logits * mask + (-1e10) * (1.0 - mask)
    probs = torch.softmax(logits, dim=-1)
    kth = torch.sort(probs, dim=-1).values[..., -top_k][..., None]
    probs = torch.where(probs >= kth, probs, 0.0)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    if noise is None:
        if generator is None:
            raise ValueError("top_k_sampling needs noise or a generator")
        noise = gumbel(act_logits.shape, generator).to(act_logits.device)
    return torch.argmax(torch.log(probs + 1e-12) + noise, dim=-1)
