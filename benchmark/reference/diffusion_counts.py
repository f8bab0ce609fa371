"""The work of a Diffusion Policy replan, counted from the configuration's
widths (the ``diffusion`` group of its file), never from the program.

One U-Net call at batch B, as 2·multiply-adds: the step encoder's two
linears per env (the published code embeds the timestep per env), and per
residual block (in, out) at length L its two convolutions (in·out·k·L and
out·out·k·L), its FiLM linear (cond·2·out) and, where in ≠ out, its 1×1
residual convolution (in·out·L); each downsample (d·d·3 taps at the halved
length), each upsample (d·d·4 taps at the input length: a transposed
convolution of stride 2 gives each of the 2L outputs two taps) and the
head's convolutions at length Tp. Convolutions count every tap, padding
included. GroupNorm, Mish and the additions are left out: they are memory
traffic, a few operations per element.
"""

from __future__ import annotations


def unet_macs_per_env(d) -> int:
    k, T, c = d["kernel_size"], d["horizon"], (
        d["step_embed_dim"] + d["n_obs_steps"] * d["obs_dim"])
    e = d["step_embed_dim"]
    dims = [d["action_dim"]] + list(d["down_dims"])
    lv = list(zip(dims[:-1], dims[1:]))

    def block(i, o, L):
        return i * o * k * L + o * o * k * L + c * 2 * o + (
            i * o * L if i != o else 0)

    macs = 2 * e * 4 * e
    for n, (i, o) in enumerate(lv):
        L = T >> n
        macs += block(i, o, L) + block(o, o, L)
        if n < len(lv) - 1:
            macs += o * o * 3 * (L // 2)
    L = T >> (len(lv) - 1)
    macs += 2 * block(dims[-1], dims[-1], L)
    for i, o in reversed(lv[1:]):
        macs += block(2 * o, i, L) + block(i, i, L) + i * i * 4 * L
        L *= 2
    s = d["down_dims"][0]
    macs += s * s * k * T + s * d["action_dim"] * T
    return macs


def unet_flops(d, B: int) -> int:
    """FLOPs of one U-Net call at batch B."""
    return 2 * unet_macs_per_env(d) * B


def replan_flops(d, B: int) -> int:
    """FLOPs of one replan: ``num_inference_steps`` U-Net calls."""
    return d["num_inference_steps"] * unet_flops(d, B)
