"""Port parity of the ES solvers, the batched ETG fit and the seed files.

Each solver's state after ``ask`` (JAX's, carried over) and ``tell`` on a
fixed fitness with ties agrees with JAX to 1e-6 in every field, and so do
the solutions of a second ``ask`` fed JAX's draws (SimpleGA: its first
iteration and after ``reset``). CMA-ES takes C^½ from ``eigh``, whose
eigenvector signs are the library's choice, so its ``ask`` is held by
A·Aᵀ = C (1e-5) and by the statistics of many solutions; its ``tell`` is
sign-free and held at 1e-6. ``batched_opt_with_points`` agrees with JAX's
vmapped fit to 1e-5 (one 6×6 solve in float32 per coordinate).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.algos import es as jes
from paddlerobotics_tpu.core.config import ETGConfig as JETGConfig
from paddlerobotics_tpu.etg import fit as jfit
from paddlerobotics_tpu.etg import seeds as jseeds

from paddlerobotics_torch.algos import es
from paddlerobotics_torch.core.config import ETGConfig
from paddlerobotics_torch.etg import fit, seeds

N, P = 12, 20
ATOL = 1e-6


def _to_port(state, cls):
    return cls(*[torch.as_tensor(np.array(x)) for x in state])


def _assert_state(ts, js, atol=ATOL):
    for name, a, b in zip(js._fields, ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=1e-6, err_msg=name)


def _fitness(seed):
    f = np.random.default_rng(seed).standard_normal(P).astype(np.float32)
    f[3] = f[7] = f[11]                  # ties
    return f


def _normal(key, shape):
    return torch.as_tensor(np.asarray(jax.random.normal(key, shape)))


def test_centered_ranks_with_ties():
    x = np.array([0.3, -1.0, 0.3, 2.0, 0.3, -1.0], np.float32)
    np.testing.assert_array_equal(
        es.compute_centered_ranks(torch.as_tensor(x)).numpy(),
        np.asarray(jes.compute_centered_ranks(jnp.asarray(x))))


def _noise_simple_ga(solver, key):
    k_eps, k_a, k_b, k_mask = jax.random.split(key, 4)   # es.py ask
    E = solver.elite_popsize
    idx = lambda k: torch.as_tensor(np.asarray(
        jax.random.randint(k, (P,), 0, E)))
    return {"eps": _normal(k_eps, (P, N)), "idx_a": idx(k_a),
            "idx_b": idx(k_b),
            "u": torch.as_tensor(np.asarray(jax.random.uniform(
                k_mask, (P, N))))}


_SOLVERS = {
    # name: (JAX solver, port solver, state type, draws of ask)
    "simple_ga": (jes.SimpleGA(N, popsize=P, weight_decay=0.005),
                  es.SimpleGA(N, popsize=P, weight_decay=0.005),
                  es.SimpleGAState, _noise_simple_ga),
    "simple_es": (jes.SimpleES(N, popsize=P), es.SimpleES(N, popsize=P),
                  es.SimpleESState, lambda s, k: _normal(k, (P, N))),
    "open_es": (jes.OpenES(N, popsize=P), es.OpenES(N, popsize=P),
                es.OpenESState, lambda s, k: _normal(k, (P, N))),
    "pepg": (jes.PEPG(N, popsize=P), es.PEPG(N, popsize=P), es.PEPGState,
             lambda s, k: _normal(k, (P // 2, N))),
    "cma_es": (jes.CMAES(N, popsize=P), es.CMAES(N, popsize=P),
               es.CMAESState, lambda s, k: _normal(k, (P, N))),
}


@pytest.mark.parametrize("name", list(_SOLVERS))
def test_tell_and_ask_match_jax(name):
    jsolver, tsolver, cls, draws = _SOLVERS[name]
    param = np.linspace(-0.1, 0.1, N).astype(np.float32)
    jstate = jsolver.init(jnp.asarray(param))
    _assert_state(tsolver.init(torch.as_tensor(param), device="cpu"), jstate)
    _, jstate = jsolver.ask(jstate, jax.random.key(1))
    tstate = _to_port(jstate, cls)
    for gen in range(2):
        f = _fitness(gen)
        jstate = jsolver.tell(jstate, jnp.asarray(f))
        tstate = tsolver.tell(tstate, torch.as_tensor(f))
        _assert_state(tstate, jstate)
        if gen == 0 and name != "cma_es":
            key = jax.random.key(10 + gen)
            sol_j, jstate = jsolver.ask(jstate, key)
            sol_t, tstate = tsolver.ask(tstate, noise=draws(tsolver, key))
            np.testing.assert_allclose(sol_t.numpy(), np.asarray(sol_j),
                                       atol=ATOL)
        elif gen == 0:
            # sign-free: carry JAX's solutions over, as after the first ask
            _, jstate = jsolver.ask(jstate, jax.random.key(10))
            tstate = _to_port(jstate, cls)
    sol, _ = tsolver.ask(tstate, generator=torch.Generator().manual_seed(0))
    assert sol.shape == (P, N) and torch.isfinite(sol).all()


def test_simple_ga_first_iteration_and_reset_match_jax():
    jsolver, tsolver = jes.SimpleGA(N, popsize=P), es.SimpleGA(N, popsize=P)
    jstate = jsolver.init(jnp.full(N, 0.05))
    tstate = tsolver.init(torch.full((N,), 0.05), device="cpu")
    for step in range(3):
        key = jax.random.key(step)
        sol_j, jstate = jsolver.ask(jstate, key)
        sol_t, tstate = tsolver.ask(tstate,
                                    noise=_noise_simple_ga(tsolver, key))
        np.testing.assert_allclose(sol_t.numpy(), np.asarray(sol_j),
                                   atol=ATOL)
        f = _fitness(step)
        jstate = jsolver.tell(jstate, jnp.asarray(f))
        tstate = tsolver.tell(tstate, torch.as_tensor(f))
        _assert_state(tstate, jstate)
        if step == 1:
            best = np.asarray(jstate.best_param) + 0.01
            jstate = jsolver.reset(jstate, jnp.asarray(best))
            tstate = tsolver.reset(tstate, torch.as_tensor(best))
            assert bool(tstate.first_iteration)
    # first iteration: every solution is best_param + noise, and the
    # zero elites of init never win
    fresh = tsolver.init(torch.zeros(N), device="cpu")
    sol, fresh = tsolver.ask(fresh, generator=torch.Generator().manual_seed(1))
    told = tsolver.tell(fresh, -torch.ones(P))
    assert float(told.elite_rewards.max()) < 0


def test_cma_es_ask_is_a_square_root_of_c():
    jsolver, tsolver = jes.CMAES(N, popsize=P), es.CMAES(N, popsize=P)
    jstate = jsolver.init(jnp.zeros(N))
    for gen in range(3):
        _, jstate = jsolver.ask(jstate, jax.random.key(gen))
        jstate = jsolver.tell(jstate, jnp.asarray(_fitness(gen)))
    C = torch.as_tensor(np.asarray(jstate.C))
    assert float((C - torch.eye(N)).abs().max()) > 1e-3   # not the identity
    A = es.CMAES.sqrt_cov(C)
    np.testing.assert_allclose((A @ A.T).numpy(), C.numpy(), atol=1e-5)
    # solutions of many asks: mean ≈ mean, covariance ≈ σ²·C
    big = es.CMAES(N, popsize=20000)
    tstate = _to_port(jstate, es.CMAESState)._replace(
        solutions=torch.zeros(20000, N), z=torch.zeros(20000, N))
    sol, _ = big.ask(tstate, generator=torch.Generator().manual_seed(0))
    y = (sol - tstate.mean) / tstate.sigma
    np.testing.assert_allclose(y.mean(0).numpy(), 0.0, atol=0.05)
    cov = (y.T @ y / y.shape[0]).numpy()
    np.testing.assert_allclose(cov, C.numpy(), atol=0.05 * float(C.max()))


def test_batched_opt_with_points_matches_jax():
    jcfg, cfg = JETGConfig(), ETGConfig()
    w0, b0 = jfit.opt_with_points(jcfg)
    pts = (jfit.prior_points(jcfg)[None]
           + 0.02 * np.random.default_rng(0).standard_normal((5, 6, 2))
           ).astype(np.float32)
    w_j, b_j = jfit.batched_opt_with_points(jcfg, jnp.asarray(pts), w0, b0)
    w_t, b_t = fit.batched_opt_with_points(
        cfg, torch.as_tensor(pts), torch.as_tensor(np.asarray(w0)),
        torch.as_tensor(np.asarray(b0)), device="cpu")
    assert w_t.shape == (5, 3, cfg.H) and b_t.shape == (5, 3)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-5)


def test_seed_files_are_the_jax_packages():
    assert seeds.available() == jseeds.available() and seeds.available()
    for task in seeds.available():
        with open(seeds.seed_path(task), "rb") as a, \
                open(jseeds.seed_path(task), "rb") as b:
            assert a.read() == b.read(), task
        np.testing.assert_array_equal(seeds.load_seed_param(task),
                                      jseeds.load_seed_param(task))
    assert seeds.seed_path("ground") is None
    assert os.path.dirname(seeds.SEED_DIR).endswith(
        os.path.join("paddlerobotics_torch", "assets"))
