"""Attention controller: transformer decoder over visual tokens with
trigger / object / action heads, and its training loss (port of the JAX
package's ``hri/attention_ctrl.py``).

- inputs: F frames × K tokens, by ``inputs_type``:
  - ``visual_token``: 562-d visual tokens, projected without bias
    (``vt_fc``);
  - the instance family (``instance`` and the ``without_inst_fm`` /
    ``_cls`` / ``_pos`` ablations) and ``inst_crop``: the features the
    variant keeps, concatenated as ``[fm, crop, cls, pos]`` and projected
    by ``inst_vt_fc`` + ReLU. ``inst_fm`` (512 channels × 5×5) goes
    through a 1×1 conv + ReLU in NHWC and is flattened in h-w-c order
    before ``inst_fm_fc`` + ReLU, as flax lays it out; ``inst_crop_feat``
    (1280-d) through ``inst_crop_fc`` + ReLU;
- frame-id embedding table ``wfe`` (F+1, D), id 0 is padding (zero row),
  added at every decoder block input;
- block-causal attention from frame ids, padding mask over absent
  detections;
- heads: trigger (per frame, on the frame-pooled hidden state), obj_cls
  (per token), action (frame hidden · projected action embeddings ``wae``);
- test time: temperature softmax + top-k sampling without the null action;
- training loss: 5·trigger sigmoid-CE + padding-masked obj CE + action
  NLL per frame (``controller_loss``).

``AttnCtrlConfig`` keeps every field of the JAX dataclass with its name and
default, so a bundle manifest's ``ctrl_cfg`` loads unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
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


INSTANCE_FAMILY = ("instance", "without_inst_fm", "without_inst_cls",
                   "without_inst_pos")
INST_FM_CHANNELS = 512          # RoIAligned YOLO tap, 5×5 cells
INST_FM_CELLS = 25
INST_CROP_DIM = 1280            # pooled MobileNetV2 features of a crop
INST_CROP_OUT = 512


def variant_token_keys(inputs_type: str) -> tuple:
    """Token keys an ``inputs_type`` consumes, in the order their features
    are concatenated."""
    if inputs_type == "visual_token":
        return ("visual_tokens",)
    if inputs_type == "inst_crop":
        return ("inst_crop_feat", "inst_cls", "inst_pos_emb")
    if inputs_type not in INSTANCE_FAMILY:
        raise ValueError(f"unknown inputs_type {inputs_type!r}")
    keys = []
    if inputs_type != "without_inst_fm":
        keys.append("inst_fm")
    if inputs_type != "without_inst_cls":
        keys.append("inst_cls")
    if inputs_type != "without_inst_pos":
        keys.append("inst_pos_emb")
    return tuple(keys)


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
        self.token_keys = variant_token_keys(cfg.inputs_type)
        device = resolve_device(device)
        self.cfg = cfg
        D = cfg.model_dim
        keys = self.token_keys
        if keys == ("visual_tokens",):
            self.vt_fc = nn.Linear(cfg.visual_token_dim, D, bias=False,
                                   device=device)
        else:
            width = 0
            if "inst_fm" in keys:
                self.inst_fm_conv = nn.Conv2d(
                    INST_FM_CHANNELS, cfg.inst_fm_reduce_dim, 1,
                    device=device)
                self.inst_fm_fc = nn.Linear(
                    INST_FM_CELLS * cfg.inst_fm_reduce_dim,
                    cfg.inst_fm_flatten_dim, device=device)
                width += cfg.inst_fm_flatten_dim
            if "inst_crop_feat" in keys:
                self.inst_crop_fc = nn.Linear(INST_CROP_DIM, INST_CROP_OUT,
                                              device=device)
                width += INST_CROP_OUT
            width += (cfg.inst_cls_dim * ("inst_cls" in keys)
                      + cfg.inst_pos_dim * ("inst_pos_emb" in keys))
            self.inst_vt_fc = nn.Linear(width, D, device=device)
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

    def embed(self, tokens: dict) -> torch.Tensor:
        """The variant's tokens → (B,T,D). ``tokens`` must carry every key
        of ``token_keys``; other keys are not read."""
        missing = [k for k in self.token_keys if k not in tokens]
        if missing:
            raise KeyError(f"tokens lack {missing} required by inputs_type="
                           f"{self.cfg.inputs_type!r}")
        if self.token_keys == ("visual_tokens",):
            return self.vt_fc(tokens["visual_tokens"])
        feats = []
        if "inst_fm" in self.token_keys:
            fm = tokens["inst_fm"]                       # (B,T,512,5,5)
            B, T = fm.shape[:2]
            # the 1×1 conv as a product over channels in NHWC, flattened
            # (h, w, c) as flax flattens its NHWC output
            conv = self.inst_fm_conv
            fm = torch.relu(F.linear(fm.permute(0, 1, 3, 4, 2),
                                     conv.weight.flatten(1), conv.bias))
            feats.append(torch.relu(self.inst_fm_fc(fm.reshape(B, T, -1))))
        if "inst_crop_feat" in self.token_keys:
            feats.append(torch.relu(self.inst_crop_fc(
                tokens["inst_crop_feat"])))
        for k in ("inst_cls", "inst_pos_emb"):
            if k in self.token_keys:
                feats.append(tokens[k])
        return torch.relu(self.inst_vt_fc(torch.cat(feats, dim=-1)))

    def forward(self, tokens: dict, frame_ids: torch.Tensor,
                padding_mask: torch.Tensor,
                past_kv_arr: Optional[torch.Tensor] = None,
                past_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: Optional[bool] = None) -> dict:
        """tokens: the variant's inputs (``token_keys``), e.g.
        {'visual_tokens': (B,T,562)} or {'inst_fm': (B,T,512,5,5),
        'inst_cls': (B,T,80), 'inst_pos_emb': (B,T,50)}; frame_ids (B,T)
        int; padding_mask (B,T) float. Returns the JAX module's dict: hid,
        frame_hid, trigger_logits, obj_logits, act_logits, present_kv_arr,
        attn_weights."""
        cfg = self.cfg
        if use_kernel is None:
            use_kernel = cfg.use_pallas_attention
        x = self.embed(tokens)
        # frame id 0 is padding (a zero row). A one-hot product gives the
        # gather's values exactly, and its backward sums in a fixed order
        # (the gather's accumulating backward does not on the CPU)
        ids = torch.arange(1, cfg.num_frames + 1, device=frame_ids.device)
        onehot = (frame_ids[..., None] == ids).to(self.wfe.dtype)
        frame_emb = onehot @ self.wfe[1:]
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


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def controller_loss(cfg: AttnCtrlConfig, outputs: dict,
                    has_act: torch.Tensor, is_obj: torch.Tensor,
                    act_ids: torch.Tensor, padding_mask: torch.Tensor):
    """Training loss → (total, aux) with aux's keys trigger_loss, obj_loss,
    act_loss, loss. obj_loss is the mean over all tokens of the masked CE
    (not over the unmasked ones); act_loss sums each window's per-frame NLL
    over F and divides by ``num_frames``, or takes the last frame's with
    ``use_last_act_loss``."""
    trigger_loss = sigmoid_ce(outputs["trigger_logits"], has_act).mean()
    obj_loss = (sigmoid_ce(outputs["obj_logits"], is_obj)
                * padding_mask).mean()
    log_probs = torch.log_softmax(outputs["act_logits"], dim=-1)
    nll = -torch.gather(log_probs, -1, act_ids.long()[..., None])[..., 0]
    if cfg.use_last_act_loss:
        act_loss = nll[:, -1].mean()
    else:
        act_loss = (nll.sum(dim=1) / cfg.num_frames).mean()
    total = (cfg.trigger_loss_coef * trigger_loss
             + cfg.obj_loss_coef * obj_loss + cfg.act_loss_coef * act_loss)
    return total, {"trigger_loss": trigger_loss, "obj_loss": obj_loss,
                   "act_loss": act_loss, "loss": total}


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
