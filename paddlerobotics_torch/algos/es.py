"""Evolution-strategy solvers (PyTorch port of the JAX package's
``algos/es.py``).

SimpleGA, SimpleES, OpenES, PEPG and CMA-ES with the same state tuples and
ask / tell / result / reset semantics (alg/es.py, estool lineage):
centred-rank fitness shaping (es.py:20-27) and L2 weight decay added to
the raw fitness (es.py:29-31). States are tuples of tensors on the device
given to ``init`` (the card unless the caller asks for the CPU). ``ask``
draws from an explicit ``torch.Generator`` or takes its draws pre-drawn
(``noise``), so a test can feed JAX's. Sorts are stable, as ``jnp.argsort``
is, so ties keep their order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from paddlerobotics_torch.core.device import resolve_device

F32 = torch.float32


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def _start(n: int, param, device) -> Tuple[torch.Tensor, torch.device]:
    device = resolve_device(device)
    p0 = torch.zeros(n, device=device) if param is None else _t(param, device)
    return p0, device


def _normal(shape, generator, device, noise):
    if noise is not None:
        return _t(noise, device)
    return torch.randn(shape, generator=generator, device=device)


def _decay(x, limit, decay):
    return torch.where(x > limit, x * decay, x)


def compute_centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """(es.py:20-27) ranks in [-0.5, 0.5]; ties ranked in index order."""
    n = x.shape[0]
    ranks = torch.argsort(torch.argsort(x, stable=True), stable=True)
    return ranks.to(F32) / (n - 1) - 0.5


def compute_weight_decay(weight_decay: float, solutions: torch.Tensor
                         ) -> torch.Tensor:
    """(es.py:29-31) −λ·mean(θ²) per solution."""
    return -weight_decay * torch.mean(solutions * solutions, dim=1)


def _adam(state, grad, beta1, beta2):
    """The solvers' own Adam step on the mean (es.py:76-90)."""
    t = state.adam_t + 1.0
    m = beta1 * state.adam_m + (1 - beta1) * grad
    v = beta2 * state.adam_v + (1 - beta2) * grad * grad
    a = state.lr * torch.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
    return state.mu - a * m / (torch.sqrt(v) + 1e-8), m, v, t


# =============================== SimpleGA ====================================

class SimpleGAState(NamedTuple):
    """(es.py:214-326) elite + crossover GA with σ-anneal."""

    elite_params: torch.Tensor   # (E, n)
    elite_rewards: torch.Tensor  # (E,)
    sigma: torch.Tensor          # ()
    best_param: torch.Tensor     # (n,)
    curr_best_param: torch.Tensor
    best_reward: torch.Tensor    # ()
    curr_best_reward: torch.Tensor
    first_iteration: torch.Tensor  # () bool
    solutions: torch.Tensor      # (P, n) last asked


class SimpleGA:
    def __init__(self, num_params: int, sigma_init=0.1, sigma_decay=0.999,
                 sigma_limit=0.01, popsize=256, elite_ratio=0.1,
                 forget_best=False, weight_decay=0.01):
        self.n = num_params
        self.popsize = popsize
        self.elite_popsize = max(1, int(popsize * elite_ratio))
        self.sigma_init = sigma_init
        self.sigma_decay = sigma_decay
        self.sigma_limit = sigma_limit
        self.forget_best = forget_best
        self.weight_decay = weight_decay

    def init(self, param=None, device=None) -> SimpleGAState:
        p0, dev = _start(self.n, param, device)
        z = lambda *s: torch.zeros(s, device=dev)
        return SimpleGAState(
            elite_params=z(self.elite_popsize, self.n),
            elite_rewards=z(self.elite_popsize),
            sigma=_t(self.sigma_init, dev), best_param=p0,
            curr_best_param=p0, best_reward=z(), curr_best_reward=z(),
            first_iteration=torch.ones((), dtype=torch.bool, device=dev),
            solutions=z(self.popsize, self.n))

    def reset(self, state: SimpleGAState, param) -> SimpleGAState:
        """(es.py:249-252) restart from a param, keep σ."""
        param = _t(param, state.sigma.device)
        return state._replace(best_param=param, curr_best_param=param,
                              first_iteration=torch.ones_like(
                                  state.first_iteration))

    def ask(self, state: SimpleGAState,
            generator: Optional[torch.Generator] = None, noise=None
            ) -> Tuple[torch.Tensor, SimpleGAState]:
        """(es.py:257-281) elite crossover + Gaussian noise. ``noise``:
        dict of the draws ``eps`` (P,n) standard normal, ``idx_a`` and
        ``idx_b`` (P,) elite indices, ``u`` (P,n) uniform in [0, 1)."""
        P, n, E = self.popsize, self.n, self.elite_popsize
        dev = state.sigma.device
        if noise is None:
            g = dict(generator=generator, device=dev)
            noise = {"eps": torch.randn((P, n), **g),
                     "idx_a": torch.randint(0, E, (P,), **g),
                     "idx_b": torch.randint(0, E, (P,), **g),
                     "u": torch.rand((P, n), **g)}
        eps = _t(noise["eps"], dev) * state.sigma
        idx_a = torch.as_tensor(noise["idx_a"], device=dev).long()
        idx_b = torch.as_tensor(noise["idx_b"], device=dev).long()
        mask = _t(noise["u"], dev) > 0.5
        child = torch.where(mask, state.elite_params[idx_b],
                            state.elite_params[idx_a])
        base = torch.where(state.first_iteration, state.best_param[None, :],
                           child)
        solutions = base + eps
        return solutions, state._replace(solutions=solutions)

    def tell(self, state: SimpleGAState, rewards: torch.Tensor
             ) -> SimpleGAState:
        """(es.py:283-314)."""
        reward_table = _t(rewards, state.sigma.device)
        if self.weight_decay > 0:
            reward_table = reward_table + compute_weight_decay(
                self.weight_decay, state.solutions)
        if self.forget_best:
            pool_r, pool_p = reward_table, state.solutions
        else:
            # concat with elites; on the first iteration the zero-valued
            # elites are masked to −inf so they cannot win
            elite_r = torch.where(state.first_iteration,
                                  torch.full_like(state.elite_rewards,
                                                  -math.inf),
                                  state.elite_rewards)
            pool_r = torch.cat([reward_table, elite_r])
            pool_p = torch.cat([state.solutions, state.elite_params])
        order = torch.argsort(-pool_r, stable=True)[: self.elite_popsize]
        elite_rewards = pool_r[order]
        elite_params = pool_p[order]
        curr_best_reward = elite_rewards[0]
        curr_best_param = elite_params[0]
        improved = state.first_iteration | (curr_best_reward
                                            > state.best_reward)
        return SimpleGAState(
            elite_params=elite_params, elite_rewards=elite_rewards,
            sigma=_decay(state.sigma, self.sigma_limit, self.sigma_decay),
            best_param=torch.where(improved, curr_best_param,
                                   state.best_param),
            curr_best_param=curr_best_param,
            best_reward=torch.where(improved, curr_best_reward,
                                    state.best_reward),
            curr_best_reward=curr_best_reward,
            first_iteration=torch.zeros_like(state.first_iteration),
            solutions=state.solutions)

    def result(self, state: SimpleGAState):
        """(best, best_reward, curr_best_reward, sigma, curr_best) —
        matching es.py:325-326."""
        return (state.best_param, state.best_reward, state.curr_best_reward,
                state.sigma, state.curr_best_param)


# =============================== SimpleES ====================================

class SimpleESState(NamedTuple):
    """(es.py:145-210) softmax-weighted mean ES."""

    mu: torch.Tensor
    sigma: torch.Tensor
    best_mu: torch.Tensor
    best_reward: torch.Tensor
    curr_best_mu: torch.Tensor
    curr_best_reward: torch.Tensor
    first_iteration: torch.Tensor
    solutions: torch.Tensor


class SimpleES:
    def __init__(self, num_params, popsize=256, sigma_init=0.1,
                 sigma_decay=0.999, sigma_limit=0.01, weight_decay=0.01):
        self.n = num_params
        self.popsize = popsize
        self.sigma_init = sigma_init
        self.sigma_decay = sigma_decay
        self.sigma_limit = sigma_limit
        self.weight_decay = weight_decay

    def init(self, param=None, device=None) -> SimpleESState:
        mu, dev = _start(self.n, param, device)
        z = torch.zeros((), device=dev)
        return SimpleESState(
            mu=mu, sigma=_t(self.sigma_init, dev), best_mu=mu,
            best_reward=z, curr_best_mu=mu, curr_best_reward=z,
            first_iteration=torch.ones((), dtype=torch.bool, device=dev),
            solutions=torch.zeros((self.popsize, self.n), device=dev))

    def ask(self, state, generator=None, noise=None):
        """``noise``: the (P,n) standard normal draw."""
        eps = _normal((self.popsize, self.n), generator, state.mu.device,
                      noise)
        solutions = state.mu[None, :] + eps * state.sigma
        return solutions, state._replace(solutions=solutions)

    def tell(self, state, rewards):
        reward = _t(rewards, state.mu.device) + compute_weight_decay(
            self.weight_decay, state.solutions)
        best_i = torch.argmax(reward)
        curr_best_reward = reward[best_i]
        curr_best_mu = state.solutions[best_i]
        improved = state.first_iteration | (curr_best_reward
                                            > state.best_reward)
        # softmax weighting after [0,3] range normalisation (es.py:198-207)
        lo, hi = torch.min(reward), torch.max(reward)
        scaled = torch.where(hi - lo > 1e-2, 3.0 * (reward - lo) / (hi - lo),
                             reward)
        w = torch.softmax(scaled, dim=0)
        return SimpleESState(
            mu=torch.sum(w[:, None] * state.solutions, dim=0),
            sigma=_decay(state.sigma, self.sigma_limit, self.sigma_decay),
            best_mu=torch.where(improved, curr_best_mu, state.best_mu),
            best_reward=torch.where(improved, curr_best_reward,
                                    state.best_reward),
            curr_best_mu=curr_best_mu, curr_best_reward=curr_best_reward,
            first_iteration=torch.zeros_like(state.first_iteration),
            solutions=state.solutions)

    def result(self, state):
        return (state.best_mu, state.best_reward, state.curr_best_reward,
                state.sigma)


# ================================ OpenES =====================================

class OpenESState(NamedTuple):
    """(es.py:328-444) rank-centred NES with Adam."""

    mu: torch.Tensor
    sigma: torch.Tensor
    lr: torch.Tensor
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: torch.Tensor
    best_mu: torch.Tensor
    best_reward: torch.Tensor
    curr_best_mu: torch.Tensor
    curr_best_reward: torch.Tensor
    first_iteration: torch.Tensor
    epsilon: torch.Tensor
    solutions: torch.Tensor


def _grad_state(cls, n, popsize, eps_rows, mu, sigma, lr, dev):
    z, zn = torch.zeros((), device=dev), torch.zeros(n, device=dev)
    return cls(
        mu=mu, sigma=sigma, lr=_t(lr, dev), adam_m=zn, adam_v=zn, adam_t=z,
        best_mu=mu, best_reward=z, curr_best_mu=mu, curr_best_reward=z,
        first_iteration=torch.ones((), dtype=torch.bool, device=dev),
        epsilon=torch.zeros((eps_rows, n), device=dev),
        solutions=torch.zeros((popsize, n), device=dev))


class OpenES:
    def __init__(self, num_params, sigma_init=0.1, sigma_decay=0.999,
                 sigma_limit=0.01, learning_rate=0.01,
                 learning_rate_decay=0.9999, learning_rate_limit=0.001,
                 popsize=256, antithetic=False, weight_decay=0.01,
                 rank_fitness=True, forget_best=True,
                 beta1=0.99, beta2=0.999):
        self.n = num_params
        self.popsize = popsize
        self.sigma_init = sigma_init
        self.sigma_decay = sigma_decay
        self.sigma_limit = sigma_limit
        self.lr_init = learning_rate
        self.lr_decay = learning_rate_decay
        self.lr_limit = learning_rate_limit
        self.antithetic = antithetic
        self.weight_decay = weight_decay
        self.rank_fitness = rank_fitness
        self.forget_best = True if rank_fitness else forget_best
        self.beta1, self.beta2 = beta1, beta2
        if antithetic and popsize % 2:
            raise ValueError("antithetic OpenES needs an even popsize")

    def init(self, param=None, device=None) -> OpenESState:
        mu, dev = _start(self.n, param, device)
        return _grad_state(OpenESState, self.n, self.popsize, self.popsize,
                           mu, _t(self.sigma_init, dev), self.lr_init, dev)

    def ask(self, state, generator=None, noise=None):
        """``noise``: the standard normal draw, (P/2,n) when antithetic,
        else (P,n)."""
        rows = self.popsize // 2 if self.antithetic else self.popsize
        eps = _normal((rows, self.n), generator, state.mu.device, noise)
        if self.antithetic:
            eps = torch.cat([eps, -eps])
        solutions = state.mu[None, :] + eps * state.sigma
        return solutions, state._replace(epsilon=eps, solutions=solutions)

    def tell(self, state, rewards):
        reward = _t(rewards, state.mu.device)
        if self.rank_fitness:
            reward = compute_centered_ranks(reward)
        if self.weight_decay > 0:
            reward = reward + compute_weight_decay(self.weight_decay,
                                                   state.solutions)
        best_i = torch.argmax(reward)
        curr_best_reward = reward[best_i]
        curr_best_mu = state.solutions[best_i]
        improved = (state.first_iteration | self.forget_best
                    | (curr_best_reward > state.best_reward))
        norm_r = (reward - torch.mean(reward)) / (
            torch.std(reward, correction=0) + 1e-8)
        grad = -(1.0 / (self.popsize * state.sigma)) * (state.epsilon.T
                                                        @ norm_r)
        # Adam only (the reference applies an SGD and an Adam step; the
        # Adam step dominates — the effective published behaviour)
        mu, m, v, t = _adam(state, grad, self.beta1, self.beta2)
        return state._replace(
            mu=mu, sigma=_decay(state.sigma, self.sigma_limit,
                                self.sigma_decay),
            lr=_decay(state.lr, self.lr_limit, self.lr_decay),
            adam_m=m, adam_v=v, adam_t=t,
            best_mu=torch.where(improved, curr_best_mu, state.best_mu),
            best_reward=torch.where(improved, curr_best_reward,
                                    state.best_reward),
            curr_best_mu=curr_best_mu, curr_best_reward=curr_best_reward,
            first_iteration=torch.zeros_like(state.first_iteration))

    def result(self, state):
        return (state.best_mu, state.best_reward, state.curr_best_reward,
                state.sigma)


# ================================= PEPG ======================================

class PEPGState(NamedTuple):
    """(es.py:446-619) antithetic PEPG with adaptive per-param σ."""

    mu: torch.Tensor
    sigma: torch.Tensor          # (n,)
    lr: torch.Tensor
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: torch.Tensor
    best_mu: torch.Tensor
    best_reward: torch.Tensor
    curr_best_mu: torch.Tensor
    curr_best_reward: torch.Tensor
    first_iteration: torch.Tensor
    epsilon: torch.Tensor        # (batch, n)
    solutions: torch.Tensor


class PEPG:
    def __init__(self, num_params, sigma_init=0.1, sigma_alpha=0.2,
                 sigma_decay=0.999, sigma_limit=0.01, sigma_max_change=0.2,
                 learning_rate=0.01, learning_rate_decay=0.9999,
                 learning_rate_limit=0.01, elite_ratio=0, popsize=256,
                 average_baseline=True, weight_decay=0.01,
                 rank_fitness=True, forget_best=True,
                 beta1=0.99, beta2=0.999):
        self.n = num_params
        self.popsize = popsize
        self.average_baseline = average_baseline
        if average_baseline != (popsize % 2 == 0):
            raise ValueError("PEPG needs an even popsize with the average "
                             "baseline and an odd one without")
        self.batch_size = popsize // 2 if average_baseline \
            else (popsize - 1) // 2
        self.elite_popsize = int(popsize * elite_ratio)
        self.use_elite = self.elite_popsize > 0
        self.sigma_init = sigma_init
        self.sigma_alpha = sigma_alpha
        self.sigma_decay = sigma_decay
        self.sigma_limit = sigma_limit
        self.sigma_max_change = sigma_max_change
        self.lr_init = learning_rate
        self.lr_decay = learning_rate_decay
        self.lr_limit = learning_rate_limit
        self.weight_decay = weight_decay
        self.rank_fitness = rank_fitness
        self.forget_best = True if rank_fitness else forget_best
        self.beta1, self.beta2 = beta1, beta2

    def init(self, param=None, device=None) -> PEPGState:
        mu, dev = _start(self.n, param, device)
        return _grad_state(PEPGState, self.n, self.popsize, self.batch_size,
                           mu, torch.ones(self.n, device=dev)
                           * self.sigma_init, self.lr_init, dev)

    def ask(self, state, generator=None, noise=None):
        """``noise``: the (popsize//2, n) standard normal draw."""
        dev = state.mu.device
        eps = _normal((self.batch_size, self.n), generator, dev, noise) \
            * state.sigma[None, :]
        all_eps = torch.cat([eps, -eps])
        if not self.average_baseline:
            all_eps = torch.cat([torch.zeros((1, self.n), device=dev),
                                 all_eps])
        solutions = state.mu[None, :] + all_eps
        return solutions, state._replace(epsilon=eps, solutions=solutions)

    def tell(self, state, rewards):
        reward_table = _t(rewards, state.mu.device)
        if self.rank_fitness:
            reward_table = compute_centered_ranks(reward_table)
        if self.weight_decay > 0:
            reward_table = reward_table + compute_weight_decay(
                self.weight_decay, state.solutions)
        if self.average_baseline:
            b = torch.mean(reward_table)
            reward = reward_table
        else:
            b = reward_table[0]
            reward = reward_table[1:]

        best_i = torch.argmax(reward)
        best_reward_cand = reward[best_i]
        eps_full = torch.cat([state.epsilon, -state.epsilon])
        take_cand = (best_reward_cand > b) | self.average_baseline
        curr_best_mu = torch.where(take_cand, state.mu + eps_full[best_i],
                                   state.mu)
        curr_best_reward = torch.where(take_cand, best_reward_cand, b)
        improved = (state.first_iteration | self.forget_best
                    | (curr_best_reward > state.best_reward))

        # mean update
        h = self.batch_size
        if self.use_elite:
            order = torch.argsort(-reward, stable=True)[: self.elite_popsize]
            mu = state.mu + torch.mean(eps_full[order], dim=0)
            m, v, t = state.adam_m, state.adam_v, state.adam_t
        else:
            rT = reward[:h] - reward[h:]
            mu, m, v, t = _adam(state, -(rT @ state.epsilon), self.beta1,
                                self.beta2)

        # adaptive sigma (es.py:585-601)
        sigma = state.sigma
        if self.sigma_alpha > 0:
            stdev = 1.0 if self.rank_fitness else \
                torch.std(reward, correction=0) + 1e-8
            S = (state.epsilon ** 2 - (sigma ** 2)[None, :]) / sigma[None, :]
            rS = (reward[:h] + reward[h:]) / 2.0 - b
            delta_sigma = (rS @ S) / (2 * h * stdev)
            change = torch.clamp(self.sigma_alpha * delta_sigma,
                                 -self.sigma_max_change * sigma,
                                 self.sigma_max_change * sigma)
            sigma = sigma + change
        if self.sigma_decay < 1:
            sigma = _decay(sigma, self.sigma_limit, self.sigma_decay)
        lr = _decay(state.lr, self.lr_limit, self.lr_decay) \
            if self.lr_decay < 1 else state.lr
        return state._replace(
            mu=mu, sigma=sigma, lr=lr, adam_m=m, adam_v=v, adam_t=t,
            best_mu=torch.where(improved, curr_best_mu, state.best_mu),
            best_reward=torch.where(improved, curr_best_reward,
                                    state.best_reward),
            curr_best_mu=curr_best_mu, curr_best_reward=curr_best_reward,
            first_iteration=torch.zeros_like(state.first_iteration))

    def result(self, state):
        return (state.best_mu, state.best_reward, state.curr_best_reward,
                state.sigma)


# ================================ CMA-ES =====================================

class CMAESState(NamedTuple):
    """Standard (μ/μ_w, λ)-CMA-ES state (the reference wraps pycma,
    es.py:92-143)."""

    mean: torch.Tensor       # (n,)
    sigma: torch.Tensor      # ()
    C: torch.Tensor          # (n,n) covariance
    p_sigma: torch.Tensor    # (n,)
    p_c: torch.Tensor        # (n,)
    gen: torch.Tensor        # ()
    best_param: torch.Tensor
    best_reward: torch.Tensor
    solutions: torch.Tensor
    z: torch.Tensor          # (P,n) standard normals of the last ask


class CMAES:
    def __init__(self, num_params, sigma_init=0.1, popsize=255,
                 weight_decay=0.01):
        """The strategy constants are float32, computed in the order of the
        JAX solver (0-d tensors on the CPU)."""
        self.n = n = num_params
        self.popsize = popsize
        self.sigma_init = sigma_init
        self.weight_decay = weight_decay
        self.mu = mu = popsize // 2
        w = (torch.log(torch.tensor(mu + 0.5, dtype=F32))
             - torch.log(torch.arange(1, mu + 1, dtype=F32)))
        self.weights = w / torch.sum(w)
        self.mu_eff = 1.0 / torch.sum(self.weights ** 2)
        self.c_sigma = (self.mu_eff + 2) / (n + self.mu_eff + 5)
        self.d_sigma = 1 + 2 * max(0.0, float(torch.sqrt(
            (self.mu_eff - 1) / (n + 1))) - 1) + self.c_sigma
        self.c_c = (4 + self.mu_eff / n) / (n + 4 + 2 * self.mu_eff / n)
        self.c_1 = 2 / ((n + 1.3) ** 2 + self.mu_eff)
        self.c_mu = min(1 - self.c_1,
                        2 * (self.mu_eff - 2 + 1 / self.mu_eff) /
                        ((n + 2) ** 2 + self.mu_eff))
        self.chi_n = n ** 0.5 * (1 - 1 / (4 * n) + 1 / (21 * n ** 2))

    def init(self, param=None, device=None) -> CMAESState:
        mean, dev = _start(self.n, param, device)
        zn = torch.zeros(self.n, device=dev)
        return CMAESState(
            mean=mean, sigma=_t(self.sigma_init, dev),
            C=torch.eye(self.n, device=dev), p_sigma=zn, p_c=zn,
            gen=torch.zeros((), device=dev), best_param=mean,
            best_reward=_t(-math.inf, dev),
            solutions=torch.zeros((self.popsize, self.n), device=dev),
            z=torch.zeros((self.popsize, self.n), device=dev))

    @staticmethod
    def sqrt_cov(C: torch.Tensor) -> torch.Tensor:
        """A with A·Aᵀ = C from the symmetric eigendecomposition (columns
        up to the sign ``eigh`` picks)."""
        evals, evecs = torch.linalg.eigh(C)
        return evecs * torch.sqrt(torch.clamp(evals, min=1e-12))[None, :]

    def ask(self, state, generator=None, noise=None):
        """``noise``: the (P,n) standard normal draw z; y = z·Aᵀ."""
        z = _normal((self.popsize, self.n), generator, state.mean.device,
                    noise)
        y = z @ self.sqrt_cov(state.C).T
        solutions = state.mean[None, :] + state.sigma * y
        return solutions, state._replace(solutions=solutions, z=z)

    def tell(self, state, rewards):
        dev = state.mean.device
        weights = self.weights.to(dev)
        reward = _t(rewards, dev) + compute_weight_decay(self.weight_decay,
                                                         state.solutions)
        order = torch.argsort(-reward, stable=True)[: self.mu]
        y = (state.solutions - state.mean[None, :]) / state.sigma
        y_sel = y[order]
        y_w = torch.sum(weights[:, None] * y_sel, dim=0)
        mean = state.mean + state.sigma * y_w

        evals, evecs = torch.linalg.eigh(state.C)
        evals = torch.clamp(evals, min=1e-12)
        C_inv_sqrt = (evecs / torch.sqrt(evals)[None, :]) @ evecs.T
        cs, cc = self.c_sigma, self.c_c
        p_sigma = (1 - cs) * state.p_sigma + torch.sqrt(
            cs * (2 - cs) * self.mu_eff) * (C_inv_sqrt @ y_w)
        gen = state.gen + 1
        norm_ps = torch.linalg.norm(p_sigma)
        sigma = state.sigma * torch.exp(
            (cs / self.d_sigma) * (norm_ps / self.chi_n - 1))
        h_sigma = (norm_ps / torch.sqrt(1 - (1 - cs) ** (2 * gen))
                   < (1.4 + 2 / (self.n + 1)) * self.chi_n).to(F32)
        p_c = (1 - cc) * state.p_c + h_sigma * torch.sqrt(
            cc * (2 - cc) * self.mu_eff) * y_w
        rank_mu = torch.einsum("i,ij,ik->jk", weights, y_sel, y_sel)
        delta_h = (1 - h_sigma) * cc * (2 - cc)
        C = ((1 - self.c_1 - self.c_mu) * state.C +
             self.c_1 * (torch.outer(p_c, p_c) + delta_h * state.C) +
             self.c_mu * rank_mu)

        best_i = torch.argmax(reward)
        improved = reward[best_i] > state.best_reward
        return CMAESState(
            mean=mean, sigma=sigma, C=C, p_sigma=p_sigma, p_c=p_c, gen=gen,
            best_param=torch.where(improved, state.solutions[best_i],
                                   state.best_param),
            best_reward=torch.where(improved, reward[best_i],
                                    state.best_reward),
            solutions=state.solutions, z=state.z)

    def result(self, state):
        return (state.best_param, state.best_reward, state.best_reward,
                state.sigma)


SOLVERS = {
    "simple_ga": SimpleGA,
    "simple_es": SimpleES,
    "open_es": OpenES,
    "pepg": PEPG,
    "cma_es": CMAES,
}
