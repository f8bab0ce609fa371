"""Plain reference of TD-MPC2 (Hansen, Su and Wang, ICLR 2024,
arXiv:2310.16828; github.com/nicklashansen/tdmpc2: ``tdmpc2/tdmpc2.py``'s
``_plan`` and ``_estimate_value``, ``common/world_model.py``,
``common/layers.py``, ``common/math.py``) at the single-task preset
(``model_size`` 5), run as an A1 policy that plans every control step.

Plain ``torch`` operations in float32, written from the layer equations;
the weights are a dict by the published module names (``_encoder.state.*``,
``_dynamics.*``, ``_reward.*``, ``_pi.*``, ``_Qs.params.*``, the buffers
``log_std_min`` and ``log_std_dif``), so the same dict loads into any
implementation that keeps them. It imports nothing but ``torch`` and
``math``. A copy of this file serves the port's tests and one the benchmark
(``tests/tdmpc2_ref.py``, ``benchmark/reference/tdmpc2.py``); the two are the
same bytes.

``cfg`` is a dict: ``obs_dim``, ``action_dim``, ``enc_dim``,
``num_enc_layers``, ``mlp_dim``, ``latent_dim``, ``num_q``, ``simnorm_dim``,
``num_bins``, ``vmin``, ``vmax``, ``log_std_min``, ``log_std_max``,
``horizon``, ``iterations``, ``num_samples``, ``num_elites``,
``num_pi_trajs``, ``min_std``, ``max_std``, ``temperature``,
``episode_length``, ``discount_denom``, ``discount_min``, ``discount_max``.

Where this departs from the published code, and why:

- many envs plan at once: every tensor of a plan gains a leading env axis,
  by plain broadcasting, and each env has its own samples, policy noise,
  Q pair and Gumbel draw, as the one-env code draws them per call;
- the Q pair of Q 'avg' is drawn per env and per iteration (the published
  code draws one ``randperm`` pair per call, for its one env);
- every draw is handed in (``noise``: the samples, the policy's ε, the Q
  pairs, the Gumbel noise), so the reference plans on the program's draws;
- eval mode: the executed action is the chosen elite's first action, with
  no exploration noise, and dropout (0.01 on each Q head's first layer in
  training) is off;
- the reset rule: an env that reset (``t0``) starts its next plan from a
  zero mean, as the published agent's first step of an episode; the other
  envs shift their last mean by one;
- one task, no task embedding; the target Q ensemble, which planning never
  reads, is left out;
- the seeded weights (``make_weights``) draw the reward's and the Q heads'
  output layers, which the published init sets to zero: zero heads tie
  every value, and the top-k would have nothing to choose.

``tf32()`` is the control's precision: both operands of every matrix
product rounded to TF32's 10 bits of mantissa (to nearest, ties away from
zero, as ``cvt.rna.tf32.f32``), the product taken in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

LN_EPS = 1e-5


# --- weights -----------------------------------------------------------------

def _mlp_shapes(pre, inp, hidden, out, normed_last):
    dims = [inp] + list(hidden) + [out]
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"{pre}.{i}.weight"] = (b, a)
        shapes[f"{pre}.{i}.bias"] = (b,)
        if i < len(dims) - 2 or normed_last:
            shapes[f"{pre}.{i}.ln.weight"] = (b,)
            shapes[f"{pre}.{i}.ln.bias"] = (b,)
    return shapes


def param_shapes(cfg):
    """Every weight's shape by its published name, in module order."""
    Z, A, M = cfg["latent_dim"], cfg["action_dim"], cfg["mlp_dim"]
    out = _mlp_shapes("_encoder.state", cfg["obs_dim"],
                      [cfg["enc_dim"]] * max(cfg["num_enc_layers"] - 1, 1),
                      Z, True)
    out.update(_mlp_shapes("_dynamics", Z + A, [M, M], Z, True))
    out.update(_mlp_shapes("_reward", Z + A, [M, M], cfg["num_bins"], False))
    out.update(_mlp_shapes("_pi", Z, [M, M], 2 * A, False))
    q = _mlp_shapes("q", Z + A, [M, M], cfg["num_bins"], False)
    for i, s in enumerate(q.values()):
        out[f"_Qs.params.{i}"] = (cfg["num_q"],) + s
    out["log_std_min"] = ()
    out["log_std_dif"] = ()
    return out


def make_weights(cfg, generator: torch.Generator):
    """Seeded weights, from one normal draw on the generator's device in
    ``param_shapes`` order: each weight matrix (a head's, in the ensemble)
    with variance 1 over its fan-in, the LayerNorms' scales 1 + 0.1·N,
    every other vector 0.1·N; the log-std range's buffers as configured."""
    shapes = param_shapes(cfg)
    q_ln = {f"_Qs.params.{i}" for i in (2, 6)}      # the heads' LN scales
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=generator, device=generator.device)
    out, i = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[i:i + n].view(shape)
        i += n
        matrix = len(shape) == (3 if name.startswith("_Qs") else 2)
        if name == "log_std_min":
            x = torch.full((), float(cfg["log_std_min"]), device=x.device)
        elif name == "log_std_dif":
            x = torch.full((), float(cfg["log_std_max"] - cfg["log_std_min"]),
                           device=x.device)
        elif matrix:
            x = x / math.sqrt(shape[-1])
        elif name.endswith(".ln.weight") or name in q_ln:
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x
    return out


# --- the networks ------------------------------------------------------------

def simnorm(x, cfg):
    """A softmax over each group of ``simnorm_dim`` consecutive features."""
    shp = x.shape
    x = x.view(*shp[:-1], -1, cfg["simnorm_dim"])
    return F.softmax(x, dim=-1).view(shp)


def normed_linear(p, pre, x, act):
    """Linear → LayerNorm → ``act``."""
    x = F.linear(x, p[f"{pre}.weight"], p[f"{pre}.bias"])
    x = F.layer_norm(x, x.shape[-1:], p[f"{pre}.ln.weight"],
                     p[f"{pre}.ln.bias"], LN_EPS)
    return act(x)


def mlp(p, pre, x, layers, last=None):
    """``layers`` − 1 NormedLinear (Mish) layers, then a NormedLinear with
    ``last`` or, without one, a plain Linear."""
    for i in range(layers - 1):
        x = normed_linear(p, f"{pre}.{i}", x, F.mish)
    i = layers - 1
    if last is not None:
        return normed_linear(p, f"{pre}.{i}", x, last)
    return F.linear(x, p[f"{pre}.{i}.weight"], p[f"{pre}.{i}.bias"])


def encode(p, obs, cfg):
    n = max(cfg["num_enc_layers"] - 1, 1) + 1
    return mlp(p, "_encoder.state", obs, n, lambda x: simnorm(x, cfg))


def next_latent(p, z, a, cfg):
    return mlp(p, "_dynamics", torch.cat([z, a], dim=-1), 3,
               lambda x: simnorm(x, cfg))


def reward_logits(p, z, a):
    return mlp(p, "_reward", torch.cat([z, a], dim=-1), 3)


def pi(p, z, eps):
    """(tanh(μ), tanh(μ + ε·exp(log σ))), log σ = min + dif·(tanh(x) + 1)/2."""
    mu, log_std = mlp(p, "_pi", z, 3).chunk(2, dim=-1)
    log_std = p["log_std_min"] + 0.5 * p["log_std_dif"] * (
        torch.tanh(log_std) + 1)
    return torch.tanh(mu), torch.tanh(mu + eps * log_std.exp())


def q_logits(p, z, a, cfg):
    """Every head's logits, (num_q, ..., num_bins): each head its own MLP
    on z‖a, its parameters the k-th slices of ``_Qs.params``."""
    x = torch.cat([z, a], dim=-1)
    w = [p[f"_Qs.params.{i}"] for i in range(10)]
    out = []
    for k in range(cfg["num_q"]):
        h = x
        for j in (0, 4):
            h = F.linear(h, w[j][k], w[j + 1][k])
            h = F.mish(F.layer_norm(h, h.shape[-1:], w[j + 2][k],
                                    w[j + 3][k], LN_EPS))
        out.append(F.linear(h, w[8][k], w[9][k]))
    return torch.stack(out)


def two_hot_inv(x, cfg):
    """Softmax over the bins on [vmin, vmax], the expected bin, symexp."""
    bins = torch.linspace(cfg["vmin"], cfg["vmax"], cfg["num_bins"],
                          device=x.device, dtype=x.dtype)
    x = torch.sum(F.softmax(x, dim=-1) * bins, dim=-1, keepdim=True)
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def discount(cfg):
    frac = cfg["episode_length"] / cfg["discount_denom"]
    return min(max((frac - 1) / frac, cfg["discount_min"]),
               cfg["discount_max"])


# --- the planner -------------------------------------------------------------

def estimate_value(p, z, actions, eps, pair, cfg):
    """Values (B, S): z (B, Z) or (B, S, Z), actions (H, B, S, A); the
    discounted rewards of the horizon, then Q 'avg' (the mean of the heads
    ``pair`` (B, 2)) of the policy's action (ε (B, S, A)) at the last
    latent."""
    H, B, S, _ = actions.shape
    if z.dim() == 2:
        z = z[:, None].expand(B, S, z.shape[-1])
    G, disc = 0, 1
    for t in range(H):
        reward = two_hot_inv(reward_logits(p, z, actions[t]), cfg)
        z = next_latent(p, z, actions[t], cfg)
        G = G + disc * reward
        disc = disc * discount(cfg)
    a = pi(p, z, eps)[1]
    q = two_hot_inv(q_logits(p, z, a, cfg), cfg)         # (num_q, B, S, 1)
    env = torch.arange(B, device=z.device)
    q_avg = (q[pair[:, 0], env] + q[pair[:, 1], env]) / 2
    return (G + disc * q_avg)[..., 0]


def pi_trajectories(p, z, eps, cfg):
    """The policy's ``num_pi_trajs`` trajectories from z (B, Z), ε
    (H, B, P, A): (H, B, P, A)."""
    H, B, P, _ = eps.shape
    z = z[:, None].expand(B, P, z.shape[-1])
    out = []
    for t in range(H):
        a = pi(p, z, eps[t])[1]
        out.append(a)
        if t < H - 1:
            z = next_latent(p, z, a, cfg)
    return torch.stack(out)


def warm_start(prev_mean, t0):
    """mean[:-1] = prev_mean[1:] per env (B, H, A), the last step 0; all 0
    where ``t0``."""
    mean = torch.zeros_like(prev_mean)
    keep = ~t0
    mean[keep, :-1] = prev_mean[keep, 1:]
    return mean


def sample(mean, std, r):
    """mean, std (B, H, A), r (H, B, S', A): clamp(μ + σ·r, −1, 1), (H, B,
    S', A)."""
    return (mean.transpose(0, 1)[:, :, None] +
            std.transpose(0, 1)[:, :, None] * r).clamp(-1, 1)


def refit(value, actions, cfg):
    """One env at a time: the top ``num_elites`` values and their actions,
    score = exp(temperature·(v − max)) normalised, the mean and std they
    refit, the std clamped. Returns a dict of (B, ...) tensors:
    ``elite_value`` (B, E), ``elite_actions`` (H, B, E, A), ``score``
    (B, E), ``mean`` and ``std`` (B, H, A)."""
    out = {k: [] for k in ("elite_value", "elite_actions", "score", "mean",
                           "std")}
    for b in range(value.shape[0]):
        v = value[b][:, None]                               # (S, 1)
        idx = torch.topk(v.squeeze(1), cfg["num_elites"], dim=0).indices
        ev, ea = v[idx], actions[:, b][:, idx]              # (E, 1), (H, E, A)
        score = torch.exp(cfg["temperature"] * (ev - ev.max(0).values))
        score = score / score.sum(0)
        mean = (score.unsqueeze(0) * ea).sum(dim=1) / (score.sum(0) + 1e-9)
        std = ((score.unsqueeze(0) * (ea - mean.unsqueeze(1)) ** 2)
               .sum(dim=1) / (score.sum(0) + 1e-9)).sqrt()
        std = std.clamp(cfg["min_std"], cfg["max_std"])
        for k, x in (("elite_value", ev[:, 0]), ("elite_actions", ea),
                     ("score", score[:, 0]), ("mean", mean), ("std", std)):
            out[k].append(x)
    res = {k: torch.stack(v) for k, v in out.items()}
    res["elite_actions"] = res["elite_actions"].transpose(0, 1)
    return res


def gumbel_pick(score, gumbel):
    """``gumbel_softmax_sample`` per env, on the handed Gumbel noise."""
    return ((score.log() + gumbel) / 1.0).softmax(-1).argmax(-1)


def select(elite_actions, score, gumbel):
    """The chosen elite's first action, clamped: (B, A)."""
    idx = gumbel_pick(score, gumbel)
    env = torch.arange(score.shape[0], device=score.device)
    return elite_actions[0, env, idx].clamp(-1, 1)


def plan(p, obs, t0, prev_mean, noise, cfg):
    """A whole plan for B envs on the handed draws (``noise``: ``samples``
    (I, H, B, S − P, A), ``pi_trajs`` (H, B, P, A), ``pi_value``
    (I, B, S, A), ``q_pair`` (I, B, 2), ``gumbel`` (B, E)): (the executed
    action (B, A), the mean (B, H, A))."""
    samples, pi_eps, value_eps, pairs, gumbel = noise
    P = cfg["num_pi_trajs"]
    z = encode(p, obs, cfg)
    pi_actions = pi_trajectories(p, z, pi_eps, cfg)
    mean = warm_start(prev_mean, t0)
    std = torch.full_like(mean, cfg["max_std"])
    for i in range(cfg["iterations"]):
        actions = torch.cat([pi_actions, sample(mean, std, samples[i])],
                            dim=2)
        value = estimate_value(p, z, actions, value_eps[i], pairs[i],
                               cfg).nan_to_num(0)
        fit = refit(value, actions, cfg)
        mean, std = fit["mean"], fit["std"]
    return select(fit["elite_actions"], fit["score"], gumbel), mean


# --- the control's precision -------------------------------------------------

aten = torch.ops.aten
_OPERANDS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
             aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}


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
