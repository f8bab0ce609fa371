"""Plain reference of Diffusion Policy (Chi et al., RSS 2023,
arXiv:2303.04137; github.com/real-stanford/diffusion_policy, the CNN-based
``ConditionalUnet1D`` at ``train_diffusion_unet_lowdim_workspace.yaml``'s
settings), run as an A1 policy that plans chunks of actions.

Plain ``torch`` operations in float32, written from the layer equations;
the weights are a dict by the published module names (``model.*``), so the
same dict loads into any implementation that keeps them. It imports
nothing but ``torch`` and ``math``. A copy of this file serves the port's
tests and one the benchmark (``tests/diffusion_policy_ref.py``,
``benchmark/reference/diffusion_policy.py``); the two are the same bytes.

``cfg`` is a dict: ``obs_dim``, ``action_dim``, ``n_obs_steps`` (To),
``horizon`` (Tp), ``n_action_steps`` (Ta), ``down_dims``, ``kernel_size``,
``n_groups``, ``step_embed_dim``, ``num_train_timesteps``,
``num_inference_steps``.

Where this departs from the published code, and why:

- the first down level's skip (``down_dims[0]`` channels at length Tp) is
  pushed and never popped: the up path has one level fewer than the down
  path. Kept, as published;
- the observations condition the U-Net globally only (``obs_as_global_
  cond``): no local condition and no inpainting mask, so the published
  sampler's ``trajectory[condition_mask] = ...`` writes nothing and is left
  out;
- the sampler is DDIM with η = 0 over ``num_inference_steps`` of the
  training schedule (the paper's real-time setting: 10 of 100), where the
  low-dim config samples DDPM over all 100;
- the timestep enters as a float tensor of B equal values, where the
  published code expands a long tensor: the same numbers reach the
  sinusoidal embedding;
- the observation normaliser is an affine map with seeded ``obs_scale``
  and ``obs_offset`` (the form of the fitted ``LinearNormalizer``); the
  action normaliser is the env's ``act_bound`` and ``act_offset``, as the
  SAC actor's tanh output is used;
- many envs step in one batch with autoreset, which the published
  ``MultiStepWrapper`` never does: an env that resets inside a chunk holds
  the zero residual (``act_offset``) until the next replan, and its history
  restarts from its new first observation, repeated (``hold_rule``).

``tf32()`` is the control's precision: both operands of every convolution
and matrix product rounded to TF32's 10 bits of mantissa (to nearest, ties
away from zero, as ``cvt.rna.tf32.f32``), the product taken in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode


# --- weights -----------------------------------------------------------------

def _block_shapes(pre, i, o, cond, k):
    return {
        f"{pre}.blocks.0.block.0.weight": (o, i, k),
        f"{pre}.blocks.0.block.0.bias": (o,),
        f"{pre}.blocks.0.block.1.weight": (o,),
        f"{pre}.blocks.0.block.1.bias": (o,),
        f"{pre}.blocks.1.block.0.weight": (o, o, k),
        f"{pre}.blocks.1.block.0.bias": (o,),
        f"{pre}.blocks.1.block.1.weight": (o,),
        f"{pre}.blocks.1.block.1.bias": (o,),
        f"{pre}.cond_encoder.1.weight": (2 * o, cond),
        f"{pre}.cond_encoder.1.bias": (2 * o,),
        **({f"{pre}.residual_conv.weight": (o, i, 1),
            f"{pre}.residual_conv.bias": (o,)} if i != o else {}),
    }


def levels(cfg):
    """(in, out) of each down level; the up levels are the last ones but
    the first, reversed."""
    dims = [cfg["action_dim"]] + list(cfg["down_dims"])
    return list(zip(dims[:-1], dims[1:]))


def cond_dim(cfg) -> int:
    return cfg["step_embed_dim"] + cfg["n_obs_steps"] * cfg["obs_dim"]


def param_shapes(cfg):
    """Every weight's shape by its published name, in module order."""
    d, k, c = cfg["step_embed_dim"], cfg["kernel_size"], cond_dim(cfg)
    lv = levels(cfg)
    out = {"model.diffusion_step_encoder.1.weight": (4 * d, d),
           "model.diffusion_step_encoder.1.bias": (4 * d,),
           "model.diffusion_step_encoder.3.weight": (d, 4 * d),
           "model.diffusion_step_encoder.3.bias": (d,)}
    for n, (i, o) in enumerate(lv):
        pre = f"model.down_modules.{n}"
        out.update(_block_shapes(f"{pre}.0", i, o, c, k))
        out.update(_block_shapes(f"{pre}.1", o, o, c, k))
        if n < len(lv) - 1:
            out[f"{pre}.2.conv.weight"] = (o, o, 3)
            out[f"{pre}.2.conv.bias"] = (o,)
    mid = lv[-1][1]
    for n in range(2):
        out.update(_block_shapes(f"model.mid_modules.{n}", mid, mid, c, k))
    for n, (i, o) in enumerate(reversed(lv[1:])):
        pre = f"model.up_modules.{n}"
        out.update(_block_shapes(f"{pre}.0", 2 * o, i, c, k))
        out.update(_block_shapes(f"{pre}.1", i, i, c, k))
        out[f"{pre}.2.conv.weight"] = (i, i, 4)     # ConvTranspose1d
        out[f"{pre}.2.conv.bias"] = (i,)
    s, a = cfg["down_dims"][0], cfg["action_dim"]
    out.update({"model.final_conv.0.block.0.weight": (s, s, k),
                "model.final_conv.0.block.0.bias": (s,),
                "model.final_conv.0.block.1.weight": (s,),
                "model.final_conv.0.block.1.bias": (s,),
                "model.final_conv.1.weight": (a, s, 1),
                "model.final_conv.1.bias": (a,),
                "obs_scale": (cfg["obs_dim"],),
                "obs_offset": (cfg["obs_dim"],)})
    return out


def make_weights(cfg, generator: torch.Generator):
    """Seeded weights, from one normal draw on the generator's device in
    ``param_shapes`` order: each weight of two or more dimensions with
    variance 1 over its fan-in (its elements over its first dimension),
    GroupNorm's scales 1 + 0.1·N, the observation scale exp(0.2·N), every
    other vector 0.1·N."""
    shapes = param_shapes(cfg)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=generator, device=generator.device)
    out, i = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[i:i + n].view(shape)
        i += n
        if len(shape) >= 2:
            x = x / math.sqrt(n // shape[0])
        elif name.endswith(".block.1.weight"):
            x = 1.0 + 0.1 * x
        elif name == "obs_scale":
            x = torch.exp(0.2 * x)
        else:
            x = 0.1 * x
        out[name] = x
    return out


# --- the U-Net ---------------------------------------------------------------

def conv_block(p, pre, x, cfg):
    """Conv1d(k, pad k//2) → GroupNorm(n_groups) → Mish."""
    w = p[f"{pre}.block.0.weight"]
    x = F.conv1d(x, w, p[f"{pre}.block.0.bias"], padding=w.shape[-1] // 2)
    x = F.group_norm(x, cfg["n_groups"], p[f"{pre}.block.1.weight"],
                     p[f"{pre}.block.1.bias"])
    return F.mish(x)


def res_block(p, pre, x, cond, cfg):
    """h = block0(x); (scale, bias) = Linear(Mish(cond)); h = block1(scale·h
    + bias); out = h + res(x)."""
    h = conv_block(p, f"{pre}.blocks.0", x, cfg)
    o = h.shape[1]
    film = F.linear(F.mish(cond), p[f"{pre}.cond_encoder.1.weight"],
                    p[f"{pre}.cond_encoder.1.bias"])
    scale, bias = film[:, :o, None], film[:, o:, None]
    h = conv_block(p, f"{pre}.blocks.1", scale * h + bias, cfg)
    if f"{pre}.residual_conv.weight" in p:
        x = F.conv1d(x, p[f"{pre}.residual_conv.weight"],
                     p[f"{pre}.residual_conv.bias"])
    return h + x


def step_embedding(p, t, cfg):
    """SinusoidalPosEmb(d) → Linear(d, 4d) → Mish → Linear(4d, d)."""
    half = cfg["step_embed_dim"] // 2
    freq = torch.exp(torch.arange(half, device=t.device) *
                     -(math.log(10000) / (half - 1)))
    e = t[:, None] * freq[None, :]
    e = torch.cat((e.sin(), e.cos()), dim=-1)
    pre = "model.diffusion_step_encoder"
    e = F.mish(F.linear(e, p[f"{pre}.1.weight"], p[f"{pre}.1.bias"]))
    return F.linear(e, p[f"{pre}.3.weight"], p[f"{pre}.3.bias"])


def unet(p, sample, t, global_cond, cfg):
    """ε for sample (B, Tp, A) at timesteps t (B,) under global_cond
    (B, To·obs); (B, Tp, A)."""
    x = sample.transpose(1, 2)
    cond = torch.cat([step_embedding(p, t, cfg), global_cond], dim=-1)
    lv = levels(cfg)
    skips = []
    for n in range(len(lv)):
        pre = f"model.down_modules.{n}"
        x = res_block(p, f"{pre}.0", x, cond, cfg)
        x = res_block(p, f"{pre}.1", x, cond, cfg)
        skips.append(x)
        if n < len(lv) - 1:
            x = F.conv1d(x, p[f"{pre}.2.conv.weight"],
                         p[f"{pre}.2.conv.bias"], stride=2, padding=1)
    for n in range(2):
        x = res_block(p, f"model.mid_modules.{n}", x, cond, cfg)
    for n in range(len(lv) - 1):
        pre = f"model.up_modules.{n}"
        x = torch.cat((x, skips.pop()), dim=1)
        x = res_block(p, f"{pre}.0", x, cond, cfg)
        x = res_block(p, f"{pre}.1", x, cond, cfg)
        x = F.conv_transpose1d(x, p[f"{pre}.2.conv.weight"],
                               p[f"{pre}.2.conv.bias"], stride=2, padding=1)
    x = conv_block(p, "model.final_conv.0", x, cfg)
    x = F.conv1d(x, p["model.final_conv.1.weight"],
                 p["model.final_conv.1.bias"])
    return x.transpose(1, 2)


# --- the schedule and the sampler --------------------------------------------

def alphas_cumprod(n: int):
    """ᾱ of the squaredcos_cap_v2 schedule over n training steps: β_i =
    min(1 − ᾱ((i+1)/n)/ᾱ(i/n), 0.999), ᾱ(s) = cos²((s+0.008)/1.008·π/2),
    in double; the cumulative product of 1 − β in float32 (diffusers)."""
    def bar(s):
        return math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = torch.tensor([min(1 - bar((i + 1) / n) / bar(i / n), 0.999)
                          for i in range(n)], dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0).tolist()


def ddim_timesteps(cfg):
    """t = 90, 80, ..., 0 for 10 of 100: every r-th step from the top,
    r = training steps // inference steps."""
    r = cfg["num_train_timesteps"] // cfg["num_inference_steps"]
    return [i * r for i in range(cfg["num_inference_steps"])][::-1], r


def global_cond(p, obs_hist, cfg):
    """The last To observations, normalised (obs·scale + offset), flat."""
    nobs = obs_hist[:, :cfg["n_obs_steps"]] * p["obs_scale"] + p["obs_offset"]
    return nobs.reshape(nobs.shape[0], -1)


def ddim_sample(p, obs_hist, noise, cfg):
    """The plan (B, Tp, A) from noise (B, Tp, A): for each t, ε = U-Net;
    x0 = (x − √(1−ᾱ_t)·ε)/√ᾱ_t clipped to [-1, 1]; x = √ᾱ_prev·x0 +
    √(1−ᾱ_prev)·ε, ᾱ_prev = 1 after the last step."""
    ac = alphas_cumprod(cfg["num_train_timesteps"])
    ts, r = ddim_timesteps(cfg)
    cond = global_cond(p, obs_hist, cfg)
    x = noise
    for t in ts:
        eps = unet(p, x, torch.full((x.shape[0],), float(t),
                                    device=x.device), cond, cfg)
        a_t = ac[t]
        a_prev = ac[t - r] if t - r >= 0 else 1.0
        x0 = ((x - math.sqrt(1 - a_t) * eps) / math.sqrt(a_t)).clamp(-1, 1)
        x = math.sqrt(a_prev) * x0 + math.sqrt(1 - a_prev) * eps
    return x


# --- the chunk ---------------------------------------------------------------

def held_at(held, k):
    """The hold mask in force at control step k of a chunk: the mask the
    steps before left, or none at the replan (k = 0), which frees every
    env."""
    return held if k > 0 else torch.zeros_like(held)


def select(plan, held, k, cfg, bound, offset):
    """The action of control step k of a chunk, ``held`` the mask the step
    before left: plan step To−1+k × bound + offset; ``offset`` (the zero
    residual) where the env is held."""
    a = plan[:, cfg["n_obs_steps"] - 1 + k] * bound + offset
    return torch.where(held_at(held, k)[:, None], offset, a)


def hold_rule(held, k, history, obs, done):
    """After control step k: an env that reset is held until the next
    replan; the history shifts in the new observation, or, after a reset,
    is the new first observation repeated."""
    new = torch.cat([history[:, 1:], obs[:, None]], dim=1)
    first = obs[:, None].expand_as(history)
    return (held_at(held, k) | done,
            torch.where(done[:, None, None], first, new))


# --- the control's precision -------------------------------------------------

aten = torch.ops.aten
_OPERANDS = {aten.convolution.default: (0, 1), aten.mm.default: (0, 1),
             aten.bmm.default: (0, 1), aten.addmm.default: (1, 2),
             aten.baddbmm.default: (1, 2)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32).view(x.shape)


class tf32(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        idx = _OPERANDS.get(func)
        if idx is not None:
            args = list(args)
            for i in idx:
                args[i] = round_tf32(args[i])
        return func(*args, **(kwargs or {}))
