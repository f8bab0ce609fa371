"""Diffusion Policy (Chi et al., "Diffusion Policy: Visuomotor Policy
Learning via Action Diffusion", RSS 2023, arXiv:2303.04137) as an A1 policy:
the CNN-based ``ConditionalUnet1D`` of github.com/real-stanford/
diffusion_policy, the DDPM schedule it is trained with, and a DDIM sampler
that turns Gaussian noise and a short observation history into a trajectory
of normalised actions.

The U-Net follows ``diffusion_policy/model/diffusion/conditional_unet1d.py``
at the low-dim workspace's settings (``train_diffusion_unet_lowdim_
workspace.yaml``: down_dims 256/512/1024, kernel 5, 8 groups, a 256-wide
step embedding, FiLM with a predicted scale, the observation history as the
global condition), and keeps its module names, so a published checkpoint's
``model.*`` keys load by name:

- ``Conv1dBlock``: Conv1d(k, pad k//2) → GroupNorm → Mish, then the
  epilogue its caller gives (FiLM's scale and bias, or a residual); all of
  it through ``ops/groupnorm_mish.conv_groupnorm_mish``, which on the card
  runs the convolution without its bias and the rest as one hand-written
  pass;
- ``ConditionalResidualBlock1D(in, out)``: h = block0(x); (scale, bias) =
  Linear(cond, 2·out)(Mish(cond)); h = block1(scale·h + bias); out = h +
  res(x), res a 1×1 conv where in ≠ out (FiLM is block0's epilogue, the
  residual block1's);
- down levels of two blocks each, each level's output kept as a skip,
  ``Downsample1d`` (Conv1d k3 s2) after all but the last; two middle blocks;
  up levels ``cat(x, skip.pop())`` → two blocks → ``Upsample1d``
  (ConvTranspose1d k4 s2, run as two polyphase 2-tap products by
  ``ops/upsample1d``); the first level's skip is never popped, as
  published; the head Conv1dBlock → 1×1 conv to the action width.

Sampling (``DiffusionPolicy.predict_action``): DDIM with η = 0 over
``num_inference_steps`` of the ``num_train_timesteps`` of a
``squaredcos_cap_v2`` schedule (t = 90, 80, …, 0 for 10 of 100), ε
prediction, the predicted x0 clipped to [-1, 1], ᾱ = 1 after the last step,
as diffusers' ``DDIMScheduler`` computes it (betas in double, their
cumulative product in float32).

Spans (``utils/profiler.annotate``): ``policy.diffusion`` around a whole
``predict_action``, inside it ``policy.diffusion.cond`` (the normalised
history as the global condition), ``policy.diffusion.unet`` (each U-Net
call; inside it ``policy.diffusion.upsample``, each of its two
``Upsample1d`` calls) and ``policy.diffusion.ddim`` (each scheduler
update); the counters ``unet_calls`` and, from the kernels' wrappers,
``upsample_launches`` and ``norm_launches``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.ops.groupnorm_mish import conv_groupnorm_mish
from paddlerobotics_torch.ops.upsample1d import upsample1d
from paddlerobotics_torch.utils import profiler


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """The published low-dim settings (To=2, Tp=16, Ta=8) at the A1 task's
    widths."""
    obs_dim: int = 49
    action_dim: int = 12
    n_obs_steps: int = 2             # To: observations in the condition
    horizon: int = 16                # Tp: actions in a plan
    n_action_steps: int = 8          # Ta: actions executed per plan
    down_dims: Tuple[int, ...] = (256, 512, 1024)
    kernel_size: int = 5
    n_groups: int = 8
    step_embed_dim: int = 256
    num_train_timesteps: int = 100
    num_inference_steps: int = 10

    @property
    def cond_dim(self) -> int:
        return self.step_embed_dim + self.n_obs_steps * self.obs_dim


# --- the U-Net ---------------------------------------------------------------

class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        emb = math.log(10000) / (half - 1)
        emb = torch.exp(torch.arange(half, device=x.device) * -emb)
        emb = x[:, None] * emb[None, :]
        return torch.cat((emb.sin(), emb.cos()), dim=-1)


class Downsample1d(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1, device=device)

    def forward(self, x):
        return self.conv(x)


class Upsample1d(nn.Module):
    """ConvTranspose1d(dim, dim, 4, 2, 1), kept as the ``conv`` submodule
    (its weight and bias load by their published names), run by
    ``ops/upsample1d.upsample1d``: the hand-written polyphase kernel on the
    card, its plain version on the CPU."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1, device=device)

    def forward(self, x):
        with profiler.annotate("policy.diffusion.upsample"):
            return upsample1d(x, self.conv.weight, self.conv.bias)


class Conv1dBlock(nn.Module):
    """Conv1d → GroupNorm → Mish, kept as the ``block`` Sequential (its
    parameters load by their published names), run by
    ``ops/groupnorm_mish.conv_groupnorm_mish`` with the epilogue the caller
    gives: ``film`` (B, 2·out), or ``res`` (B, out, L) added, through the
    1×1 convolution ``res_weight``, ``res_bias`` where given."""

    def __init__(self, inp: int, out: int, kernel_size: int, n_groups: int,
                 device=None):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv1d(inp, out, kernel_size, padding=kernel_size // 2,
                      device=device),
            nn.GroupNorm(n_groups, out, device=device),
            nn.Mish())

    def forward(self, x, film=None, res=None, res_weight=None,
                res_bias=None):
        conv, norm = self.block[0], self.block[1]
        return conv_groupnorm_mish(
            x, conv.weight, conv.bias, norm.weight, norm.bias,
            norm.num_groups, norm.eps, conv.padding[0], film=film, res=res,
            res_weight=res_weight, res_bias=res_bias)


class ConditionalResidualBlock1D(nn.Module):
    def __init__(self, inp: int, out: int, cond_dim: int, kernel_size: int,
                 n_groups: int, device=None):
        super().__init__()
        self.out_channels = out
        self.blocks = nn.ModuleList([
            Conv1dBlock(inp, out, kernel_size, n_groups, device),
            Conv1dBlock(out, out, kernel_size, n_groups, device)])
        # FiLM with a predicted scale (cond_predict_scale=True)
        self.cond_encoder = nn.Sequential(
            nn.Mish(), nn.Linear(cond_dim, 2 * out, device=device))
        self.residual_conv = (nn.Conv1d(inp, out, 1, device=device)
                              if inp != out else nn.Identity())

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.blocks[0](x, film=self.cond_encoder(cond))
        rc = self.residual_conv
        if isinstance(rc, nn.Conv1d):
            return self.blocks[1](h, res=x, res_weight=rc.weight,
                                  res_bias=rc.bias)
        return self.blocks[1](h, res=x)


class ConditionalUnet1D(nn.Module):
    """ε(x_t, t, global_cond): x_t (B, Tp, A), t (B,), global_cond
    (B, To·obs) → (B, Tp, A)."""

    def __init__(self, cfg: DiffusionConfig, device=None):
        super().__init__()
        dsed = cfg.step_embed_dim
        k, g, cond = cfg.kernel_size, cfg.n_groups, cfg.cond_dim
        self.diffusion_step_encoder = nn.Sequential(
            SinusoidalPosEmb(dsed), nn.Linear(dsed, 4 * dsed, device=device),
            nn.Mish(), nn.Linear(4 * dsed, dsed, device=device))
        dims = [cfg.action_dim] + list(cfg.down_dims)
        in_out = list(zip(dims[:-1], dims[1:]))

        def block(i, o):
            return ConditionalResidualBlock1D(i, o, cond, k, g, device)

        self.down_modules = nn.ModuleList([
            nn.ModuleList([block(i, o), block(o, o),
                           Downsample1d(o, device)
                           if n < len(in_out) - 1 else nn.Identity()])
            for n, (i, o) in enumerate(in_out)])
        mid = dims[-1]
        self.mid_modules = nn.ModuleList([block(mid, mid), block(mid, mid)])
        self.up_modules = nn.ModuleList([
            nn.ModuleList([block(2 * o, i), block(i, i),
                           Upsample1d(i, device)])
            for i, o in reversed(in_out[1:])])
        start = cfg.down_dims[0]
        self.final_conv = nn.Sequential(
            Conv1dBlock(start, start, k, g, device),
            nn.Conv1d(start, cfg.action_dim, 1, device=device))

    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                global_cond: torch.Tensor) -> torch.Tensor:
        x = sample.transpose(1, 2)                      # (B, A, Tp)
        feat = torch.cat([self.diffusion_step_encoder(timestep),
                          global_cond], dim=-1)
        skips = []
        for resnet, resnet2, downsample in self.down_modules:
            x = resnet2(resnet(x, feat), feat)
            skips.append(x)
            x = downsample(x)
        for mid in self.mid_modules:
            x = mid(x, feat)
        for resnet, resnet2, upsample in self.up_modules:
            x = torch.cat((x, skips.pop()), dim=1)
            x = upsample(resnet2(resnet(x, feat), feat))
        return self.final_conv(x).transpose(1, 2)


# --- the schedule and the sampler --------------------------------------------

def alphas_cumprod(num_train_timesteps: int) -> List[float]:
    """ᾱ_t of the ``squaredcos_cap_v2`` schedule: betas from the cosine
    ᾱ(s) = cos²((s + 0.008)/1.008 · π/2), capped at 0.999, in double; their
    complements' cumulative product in float32."""
    def bar(s):
        return math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2

    n = num_train_timesteps
    betas = torch.tensor([min(1 - bar((i + 1) / n) / bar(i / n), 0.999)
                          for i in range(n)], dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0).tolist()


def ddim_schedule(cfg: DiffusionConfig) -> List[Tuple[int, float, float]]:
    """(t, ᾱ_t, ᾱ_prev) per DDIM step: t = (n−1)·r, …, r, 0 with r =
    train steps // inference steps; ᾱ_prev = 1 after the last step."""
    ac = alphas_cumprod(cfg.num_train_timesteps)
    r = cfg.num_train_timesteps // cfg.num_inference_steps
    ts = [i * r for i in reversed(range(cfg.num_inference_steps))]
    return [(t, ac[t], ac[t - r] if t - r >= 0 else 1.0) for t in ts]


def ddim_step(x: torch.Tensor, eps: torch.Tensor, a_t: float,
              a_prev: float) -> torch.Tensor:
    """x_prev = √ᾱ_prev·x0 + √(1−ᾱ_prev)·ε, x0 = (x − √(1−ᾱ_t)·ε)/√ᾱ_t
    clipped to [-1, 1], ε the unclipped prediction (η = 0)."""
    x0 = ((x - math.sqrt(1 - a_t) * eps) / math.sqrt(a_t)).clamp(-1.0, 1.0)
    return math.sqrt(a_prev) * x0 + math.sqrt(1 - a_prev) * eps


# --- the policy --------------------------------------------------------------

class DiffusionPolicy(nn.Module):
    """The U-Net (``model``) and the affine observation normaliser
    (``obs_scale``, ``obs_offset``: normalised = obs·scale + offset, the
    published ``LinearNormalizer``'s form). Actions stay normalised: the
    caller maps a plan to the env's range (``envs/wrappers.ChunkRunner``)."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.model = ConditionalUnet1D(cfg, device)
        self.register_buffer("obs_scale", torch.ones(cfg.obs_dim,
                                                     device=device))
        self.register_buffer("obs_offset", torch.zeros(cfg.obs_dim,
                                                       device=device))
        self.schedule = ddim_schedule(cfg)

    def global_cond(self, obs_hist: torch.Tensor) -> torch.Tensor:
        """obs_hist (B, To, obs) → the normalised history, flattened."""
        nobs = obs_hist[:, :self.cfg.n_obs_steps] * self.obs_scale \
            + self.obs_offset
        return nobs.reshape(nobs.shape[0], -1)

    @torch.no_grad()
    def predict_action(self, obs_hist: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
        """obs_hist (B, To, obs), noise (B, Tp, A) → the sampled plan
        (B, Tp, A) of normalised actions in [-1, 1]."""
        with profiler.annotate("policy.diffusion"):
            with profiler.annotate("policy.diffusion.cond"):
                cond = self.global_cond(obs_hist)
            x = noise
            for t, a_t, a_prev in self.schedule:
                with profiler.annotate("policy.diffusion.unet"):
                    tt = torch.full((x.shape[0],), float(t),
                                    device=x.device)
                    eps = self.model(x, tt, cond)
                profiler.count("unet_calls")
                with profiler.annotate("policy.diffusion.ddim"):
                    x = ddim_step(x, eps, a_t, a_prev)
            return x

