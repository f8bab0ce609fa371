"""The work of a TD-MPC2 plan, counted from the configuration's widths (the
``tdmpc2`` group of its file), never from the program.

FLOPs are 2·multiply-adds of the linear layers a plan runs for B envs: the
encoder once per env; the ``num_pi_trajs`` policy trajectories (``horizon``
policy calls and ``horizon`` − 1 dynamics steps each); and per iteration the
value of ``num_samples`` sequences: ``horizon`` steps of reward and
dynamics, then the policy and all ``num_q`` Q heads on the last latent.
LayerNorm, Mish, SimNorm, the bin softmaxes, the top-k and the refit are
left out: memory traffic, a few operations per element.

Bytes are those of the LayerNorm tails of one plan (the ``groupnorm_mish``
kernel's row path): each row of a NormedLinear's output read once and
written once, and each launch's bias, scale and shift (one set a head)
read once.
"""

from __future__ import annotations


def _mlp(dims):
    """(multiply-adds a row, widths of the normed tails) of an MLP whose
    hidden layers are NormedLinear."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return macs, list(dims[1:-1])


def nets(d):
    """Each network's multiply-adds a row and its normed tails' widths (the
    encoder's and dynamics' last layer are normed, with SimNorm)."""
    Z, A, M, nb = d["latent_dim"], d["action_dim"], d["mlp_dim"], d["num_bins"]
    enc = [d["obs_dim"]] + [d["enc_dim"]] * max(d["num_enc_layers"] - 1, 1)
    out = {"encoder": _mlp(enc + [Z]), "dynamics": _mlp([Z + A, M, M, Z]),
           "reward": _mlp([Z + A, M, M, nb]), "pi": _mlp([Z, M, M, 2 * A]),
           "q": _mlp([Z + A, M, M, nb])}
    for k in ("encoder", "dynamics"):
        out[k] = (out[k][0], out[k][1] + [Z])
    return out


def value_macs_per_sample(d) -> int:
    """One sequence's value estimate: 7,571,456 at the published widths."""
    n = nets(d)
    return (d["horizon"] * (n["dynamics"][0] + n["reward"][0]) + n["pi"][0]
            + d["num_q"] * n["q"][0])


def value_flops(d, B: int) -> int:
    """FLOPs of one iteration's value estimate for B envs."""
    return 2 * B * d["num_samples"] * value_macs_per_sample(d)


def plan_flops(d, B: int) -> int:
    """FLOPs of one plan for B envs."""
    n, H = nets(d), d["horizon"]
    trajs = d["num_pi_trajs"] * (H * n["pi"][0] + (H - 1) * n["dynamics"][0])
    return (2 * B * (n["encoder"][0] + trajs)
            + d["iterations"] * value_flops(d, B))


def norm_launches(d, B: int):
    """(rows, width, heads) of each LayerNorm tail launch of one plan."""
    n, H, P = nets(d), d["horizon"], d["num_pi_trajs"]
    S = d["num_samples"]
    out = [(B, c, 1) for c in n["encoder"][1]]
    out += H * [(B * P, c, 1) for c in n["pi"][1]]
    out += (H - 1) * [(B * P, c, 1) for c in n["dynamics"][1]]
    per_iter = (H * [(B * S, c, 1) for c in n["dynamics"][1] + n["reward"][1]]
                + [(B * S, c, 1) for c in n["pi"][1]]
                + [(d["num_q"] * B * S, c, d["num_q"]) for c in n["q"][1]])
    return out + d["iterations"] * per_iter


def norm_bytes(d, B: int) -> int:
    """Bytes the LayerNorm tails of one plan must move."""
    return sum(4 * (2 * R * C + 3 * h * C) for R, C, h in norm_launches(d, B))
