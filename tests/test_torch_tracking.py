"""Port parity of the tracking stack: the re-ID encoder
(``hri/perception/reid.MarsSmall128``), the exact assignment
(``ops/lap``), the Kalman filter and the Deep-SORT tracker
(``hri/tracker``), each against the JAX package on the same seeded numpy
inputs.

The assignment is compared for equality: the port copies the JAX
algorithm's float32 operation order, so the same costs give the same
columns, at scipy's optimum to float32 rounding. The tracker runs 30 frames of
synthetic walkers whose costs keep a margin from every gate, so its
discrete outputs (statuses, ids, per-detection ids) must be equal and its
means agree to float32 rounding in another summation order (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from scipy.optimize import linear_sum_assignment

from paddlerobotics_tpu.hri import tracker as j_trk
from paddlerobotics_tpu.hri.perception import reid as j_reid
from paddlerobotics_tpu.ops import lap as j_lap

from paddlerobotics_torch import convert
from paddlerobotics_torch.hri import tracker as trk
from paddlerobotics_torch.hri.utils import l2_normalize
from paddlerobotics_torch.ops import lap

KF_RTOL, KF_ATOL = 1e-5, 1e-6
MEAN_TOL = 1e-4
# the solve's duals are float32: where two assignments' costs differ by an
# ulp (0.3 + 0.6 against 0.8 + 0.1 in float32) it may take either, in both
# packages
COST_RTOL = 1e-6


def _t(x):
    return torch.tensor(np.array(x))


def reid_variables(seed: int = 0) -> dict:
    """Flax MarsSmall128 variables from a numpy seed, every BatchNorm scale,
    bias, mean and variance perturbed (fresh statistics would hide a wrong
    mapping of them)."""
    shapes = jax.eval_shape(j_reid.MarsSmall128().init, jax.random.key(0),
                            jnp.zeros((1, 128, 64, 3)))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_dict(shapes).items():
        if k[-1] == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif k[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        flat[k] = v.astype(np.float32)
    return unflatten_dict(flat)


def test_mars_small128_matches_flax():
    var = reid_variables(3)
    crops = np.random.default_rng(3).random((4, 128, 64, 3), np.float32)
    out_j = np.asarray(jax.jit(j_reid.MarsSmall128().apply)(var, crops))
    enc = convert.reid_from_flax(var, device="cpu")
    with torch.no_grad():
        out_t = enc(_t(crops)).numpy()
    assert out_t.shape == (4, 128)
    np.testing.assert_allclose(np.linalg.norm(out_t, axis=-1), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=1e-5)


def _costs(kind: str, rng, R, C):
    if kind == "random":
        return rng.random((R, C)).astype(np.float32)
    if kind == "tied":                          # exact ties everywhere
        return rng.integers(0, 3, (R, C)).astype(np.float32)
    return np.round(rng.random((R, C)), 1).astype(np.float32)


_solve_j = jax.jit(j_lap.solve_lap)


@pytest.mark.parametrize("kind", ["random", "tied", "decimal"])
def test_solve_lap_equal_to_jax_and_optimal(kind):
    rng = np.random.default_rng({"random": 0, "tied": 1, "decimal": 2}[kind])
    for n in (1, 2, 3, 5, 8, 13, 20, 32):
        c = _costs(kind, rng, n, n)
        col_j = np.asarray(_solve_j(jnp.asarray(c)))
        col_t = lap.solve_lap(_t(c)).numpy()
        np.testing.assert_array_equal(col_t, col_j)
        r, cc = linear_sum_assignment(c)
        np.testing.assert_allclose(c[np.arange(n), col_t].sum(dtype=np.float64),
                                   c[r, cc].sum(dtype=np.float64), rtol=COST_RTOL)


_match_j = jax.jit(j_lap.min_cost_match, static_argnums=1)


@pytest.mark.parametrize("kind", ["random", "tied", "decimal"])
def test_min_cost_match_equal_to_jax(kind):
    """Rectangular costs both ways, masked rows and columns, costs at the
    threshold and at the clip constant."""
    rng = np.random.default_rng(10 + len(kind))
    for R, C in ((3, 7), (7, 3), (32, 20), (1, 1)):
        for max_cost in (0.3, 1.0):
            c = _costs(kind, rng, R, C)
            c.flat[::5] = np.float32(max_cost)
            c.flat[::7] = np.float32(max_cost + 1e-5)
            rv = (rng.random(R) < 0.8).astype(np.float32)
            cv = (rng.random(C) < 0.8).astype(np.float32)
            a_j = np.asarray(_match_j(jnp.asarray(c), max_cost,
                                      jnp.asarray(rv), jnp.asarray(cv)))
            a_t = lap.min_cost_match(_t(c), max_cost, _t(rv), _t(cv))
            assert a_t.dtype == torch.int32
            np.testing.assert_array_equal(a_t.numpy(), a_j)


def test_min_cost_match_without_gates_is_scipy_optimal():
    rng = np.random.default_rng(20)
    for R, C in ((5, 9), (9, 5), (32, 20)):
        c = rng.random((R, C)).astype(np.float32)
        a = lap.min_cost_match(_t(c), 10.0, torch.ones(R),
                               torch.ones(C)).numpy()
        r, cc = linear_sum_assignment(c)
        ours = c[np.arange(R)[a >= 0], a[a >= 0]].sum(dtype=np.float64)
        np.testing.assert_allclose(ours, c[r, cc].sum(dtype=np.float64),
                                   rtol=COST_RTOL)


def test_track_match_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(30)
    T, D = trk.MAX_TRACKS, 20
    args = (_t(rng.random((T, D)).astype(np.float32)),
            _t(rng.random((T, D)).astype(np.float32)),
            _t(rng.integers(0, 3, T).astype(np.int32)),
            _t(rng.integers(0, 4, T).astype(np.int32)),
            _t(rng.random(D) < 0.8))
    launches = lap.track_match.launches
    work = torch.zeros(2, dtype=torch.int32)
    a, m = lap.track_match(*args, work=work)
    a_p, m_p = lap.track_match_plain(*args)
    assert lap.track_match.launches == launches
    np.testing.assert_array_equal(a.numpy(), a_p.numpy())
    np.testing.assert_array_equal(m.numpy(), m_p.numpy())
    assert int(work[1]) >= 1 and int(work[0]) >= 32 * int(work[1]) // 2
    # the matched mask is the set of columns taken
    taken = np.zeros(D, bool)
    taken[a.numpy()[a.numpy() >= 0]] = True
    np.testing.assert_array_equal(m.numpy(), taken)


def _tracks(rng, n=3):
    lo = rng.uniform(0, 300, (n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(20, 120, (n, 2))], 1)
    m = np.asarray(j_trk.xyxy_to_cah(jnp.asarray(boxes, jnp.float32)))
    mean = np.concatenate([m, rng.normal(0, 2, (n, 4))], 1).astype(
        np.float32)
    a = rng.normal(0, 1, (n, 8, 8))
    cov = (a @ a.transpose(0, 2, 1) + 8 * np.eye(8)).astype(np.float32)
    return mean, cov, boxes.astype(np.float32)


def test_kalman_functions_match():
    rng = np.random.default_rng(40)
    mean, cov, boxes = _tracks(rng)
    meas = np.asarray(j_trk.xyxy_to_cah(jnp.asarray(boxes)))
    np.testing.assert_allclose(trk.xyxy_to_cah(_t(boxes)).numpy(), meas,
                               rtol=1e-6)
    np.testing.assert_allclose(trk.cah_to_xyxy(_t(meas)).numpy(),
                               np.asarray(j_trk.cah_to_xyxy(jnp.asarray(
                                   meas))), rtol=1e-6, atol=1e-4)
    check = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=KF_RTOL, atol=KF_ATOL *
        np.abs(np.asarray(want)).max())
    for i in range(len(mean)):            # one track, as the JAX functions
        m, c, z = jnp.asarray(mean[i]), jnp.asarray(cov[i]), meas[i]
        for got, want in zip(trk.kf_initiate(_t(z)),
                             j_trk.kf_initiate(jnp.asarray(z))):
            check(got, want)
        for fn in ("kf_predict", "kf_project"):
            for got, want in zip(getattr(trk, fn)(_t(mean[i]), _t(cov[i])),
                                 getattr(j_trk, fn)(m, c)):
                check(got, want)
        for got, want in zip(trk.kf_update(_t(mean[i]), _t(cov[i]),
                                           _t(meas[(i + 1) % len(meas)])),
                             j_trk.kf_update(m, c, jnp.asarray(
                                 meas[(i + 1) % len(meas)]))):
            check(got, want)
        check(trk.kf_gating_distance(_t(mean[i]), _t(cov[i]), _t(meas)),
              j_trk.kf_gating_distance(m, c, jnp.asarray(meas)))
    # all tracks at once, as the tracker calls them
    gate_j = jax.vmap(lambda m, c: j_trk.kf_gating_distance(
        m, c, jnp.asarray(meas)))(jnp.asarray(mean), jnp.asarray(cov))
    check(trk.kf_gating_distance(_t(mean), _t(cov), _t(meas)), gate_j)
    for got, want in zip(trk.kf_predict(_t(mean), _t(cov)),
                         jax.vmap(j_trk.kf_predict)(jnp.asarray(mean),
                                                    jnp.asarray(cov))):
        check(got, want)


def test_greedy_match_equal():
    rng = np.random.default_rng(50)
    for R, C in ((4, 6), (6, 4), (32, 20)):
        c = rng.random((R, C)).astype(np.float32)
        rv = (rng.random(R) < 0.8).astype(np.float32)
        cv = (rng.random(C) < 0.8).astype(np.float32)
        a_j = np.asarray(j_trk.greedy_match(jnp.asarray(c), 0.6,
                                            jnp.asarray(rv), jnp.asarray(cv)))
        a_t = trk.greedy_match(_t(c), 0.6, _t(rv), _t(cv)).numpy()
        np.testing.assert_array_equal(a_t, a_j)
    # the instance where greedy is strictly worse than the exact match
    c = np.array([[0.0, 1.0], [0.1, 10.0]], np.float32)
    np.testing.assert_array_equal(
        trk.greedy_match(_t(c), 100.0, torch.ones(2), torch.ones(2)).numpy(),
        [0, 1])


def walkers(frames: int, n: int = 5, D: int = 8, seed: int = 0):
    """Synthetic walkers: n boxes in constant-velocity motion with 1 px of
    box noise, each a fixed unit feature plus noise; walker 2 is hidden in
    frames 8-11 (the cascade's older levels), a clutter box with a random
    feature shows every fourth frame. → per frame (boxes (D,4), features
    (D,128), valid (D,)) as float32 / bool numpy arrays."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, 128))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    start = np.stack([60 + 110 * np.arange(n), 40 + 20 * np.arange(n)], 1)
    vel = rng.uniform(-3, 3, (n, 2))
    size = np.stack([rng.uniform(40, 60, n), rng.uniform(100, 140, n)], 1)
    out = []
    for f in range(frames):
        boxes = np.zeros((D, 4), np.float32)
        feats = np.zeros((D, 128), np.float32)
        valid = np.zeros(D, bool)
        for k in range(n):
            if k == 2 and 8 <= f < 12:
                continue
            lo = start[k] + vel[k] * f + rng.normal(0, 1, 2)
            boxes[k] = np.concatenate([lo, lo + size[k]])
            feats[k] = base[k] + 0.02 * rng.standard_normal(128)
            valid[k] = True
        if f % 4 == 3:
            lo = rng.uniform(0, 500, 2)
            boxes[n] = np.concatenate([lo, lo + 50])
            feats[n] = rng.standard_normal(128)
            valid[n] = True
        out.append((boxes, feats, valid))
    return out


def test_tracker_update_walkers_match_jax():
    j_step = jax.jit(lambda s, b, f, v: j_trk.tracker_update(
        j_trk.tracker_predict(s), b, f, v))
    sj = j_trk.init_tracker()
    st = trk.init_tracker(device="cpu")
    confirmed_ids = {}
    for f, (boxes, feats, valid) in enumerate(walkers(30)):
        sj, tid_j = j_step(sj, jnp.asarray(boxes), jnp.asarray(feats),
                           jnp.asarray(valid))
        pred = trk.tracker_predict(st)
        # the premise of an exact match: no appearance cost of a confirmed
        # track sits near the gate
        cost = 1 - l2_normalize(pred.feature) @ l2_normalize(_t(feats)).T
        live = (pred.status == trk.CONFIRMED)[:, None] & _t(valid)[None]
        assert (abs(cost[live] - 0.2) > 0.05).all()
        st, tid_t = trk.tracker_update(pred, _t(boxes), _t(feats), _t(valid))
        np.testing.assert_array_equal(tid_t.numpy(), np.asarray(tid_j))
        for name in ("status", "hits", "time_since_update", "track_id"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(sj, name)),
                                          err_msg=f"frame {f}: {name}")
        assert int(st.next_id) == int(sj.next_id)
        live = st.status.numpy() > 0
        np.testing.assert_allclose(st.mean.numpy()[live],
                                   np.asarray(sj.mean)[live],
                                   rtol=MEAN_TOL, atol=MEAN_TOL)
        for k in range(5):
            if f >= 3 and valid[k]:
                confirmed_ids.setdefault(k, set()).add(int(tid_t[k]))
    # every walker keeps one id once confirmed, the hidden one included
    assert all(len(ids) == 1 and 0 not in ids
               for ids in confirmed_ids.values()), confirmed_ids
    assert len({i for ids in confirmed_ids.values() for i in ids}) == 5

