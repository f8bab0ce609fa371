"""Port parity of the gait, export and deployment helpers.

The A1 leg kinematics (FK, IK, all-legs FK/IK, the analytic Jacobian), the
ETG model's per-env functions (``foot_deltas``, ``etg_joint_residual``) and
``gait_table``, the Bezier gait generator and the velocity estimator are
held against the JAX package's at 1e-5 (float32 transcendental functions
in two libraries; measured ≤ 1e-6). ``gait_table`` is held bit-equal to
the residual the port's one-env batched env applies step by step (it runs
that function). The ``export_gait`` CLI writes the table;
``export_policy_fn`` on an actor converted from flax agrees with JAX's
policy at 1e-5 and its ``torch.export`` with the eager policy exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.algos.sac import SAC as JSAC
from paddlerobotics_tpu.core.config import QuadrupedConfig as JConfig
from paddlerobotics_tpu.deploy import bezier as jbezier
from paddlerobotics_tpu.deploy import estimator as jestimator
from paddlerobotics_tpu.deploy import policy_export as jexport
from paddlerobotics_tpu.etg import fit as jfit
from paddlerobotics_tpu.etg import model as jmodel
from paddlerobotics_tpu.sim import a1_model as ja1

from paddlerobotics_torch import convert
from paddlerobotics_torch.cli import export_gait
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.deploy import bezier, estimator, policy_export
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.etg import fit, model
from paddlerobotics_torch.sim import a1_model as a1

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _close(ours, theirs, atol=ATOL, err=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=atol, err_msg=err)


def test_leg_kinematics_match_jax():
    rng = np.random.default_rng(0)
    q = (a1.INIT_MOTOR_ANGLES + 0.3 * rng.standard_normal((6, 12))
         ).astype(np.float32)
    legs = q.reshape(6, 4, 3)
    signs = a1.HIP_SIGNS.astype(np.float32)
    fk_t = a1.foot_position_in_hip_frame(_t(legs), _t(signs))
    _close(fk_t, ja1.foot_position_in_hip_frame(jnp.asarray(legs),
                                                jnp.asarray(signs)), err="fk")
    _close(a1.foot_position_in_hip_frame_to_joint_angle(fk_t, _t(signs)),
           ja1.foot_position_in_hip_frame_to_joint_angle(
               jnp.asarray(fk_t.numpy()), jnp.asarray(signs)), err="ik")
    feet_t = a1.foot_positions_in_base_frame(_t(q))
    _close(feet_t, ja1.foot_positions_in_base_frame(jnp.asarray(q)),
           err="all-legs fk")
    _close(a1.joint_angles_from_foot_positions(feet_t),
           ja1.joint_angles_from_foot_positions(jnp.asarray(feet_t.numpy())),
           err="all-legs ik")
    # the IK inverts the FK on this range of angles
    _close(a1.joint_angles_from_foot_positions(feet_t), q, atol=1e-4)
    _close(a1.analytical_leg_jacobian(_t(legs), _t(signs)),
           ja1.analytical_leg_jacobian(jnp.asarray(legs), jnp.asarray(signs)),
           err="jacobian")


@pytest.mark.parametrize("pairing", ["trot", "bound"])
def test_etg_model_matches_jax(pairing):
    jcfg = dataclasses.replace(JConfig().etg, pairing=pairing, step_y=0.07)
    tcfg = dataclasses.replace(QuadrupedConfig().etg, pairing=pairing,
                               step_y=0.07)
    w, b = jfit.opt_with_points(jcfg)
    w = np.asarray(w) + 0.01 * np.random.default_rng(1).standard_normal(
        w.shape).astype(np.float32)
    b = np.asarray(b)
    va_j, vb_j = jmodel.phase_tables(jcfg, 30)
    va_t, vb_t = model.phase_tables(tcfg, 30, device="cpu")
    _close(va_t, va_j, err="V(t)")
    _close(vb_t, vb_j, err="V(t+T/2)")
    for k in (0, 7, 19):
        _close(model.foot_deltas(_t(w), _t(b), va_t[k], vb_t[k], tcfg),
               jmodel.foot_deltas(jnp.asarray(w), jnp.asarray(b), va_j[k],
                                  vb_j[k], jcfg), err=f"deltas {k}")
        _close(model.etg_joint_residual(_t(w), _t(b), va_t[k], vb_t[k], tcfg),
               jmodel.etg_joint_residual(jnp.asarray(w), jnp.asarray(b),
                                         va_j[k], vb_j[k], jcfg),
               err=f"residual {k}")
    _close(model.gait_table(_t(w), _t(b), tcfg, 30),
           jmodel.gait_table(jnp.asarray(w), jnp.asarray(b), jcfg, 30),
           err="table")


def test_gait_table_is_the_env_residual():
    cfg = QuadrupedConfig()
    w, b = fit.opt_with_points(cfg.etg, device="cpu")
    table = model.gait_table(w, b, cfg.etg, 40)
    env = BatchedQuadrupedEnv(cfg, 1, device="cpu")
    for t in range(40):
        r = env._etg_residual(w[..., None], b[:, None],
                              torch.full((1,), t, dtype=torch.int32))[0]
        assert torch.equal(table[t], r[:, 0]), t


def test_export_gait_cli_and_policy_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    table = export_gait.main(["--steps", "24", "--suffix", "t",
                              "--device", "cpu"])
    saved = np.load(tmp_path / "gait_action_list_ETG_t.npy")
    assert saved.shape == (24, 12) and np.array_equal(saved, table)
    jcfg = JConfig()
    _close(saved, jexport.export_gait_table(jcfg, *jfit.opt_with_points(
        jcfg.etg), 24))
    # 'gallop' resolves pairing='auto' to the bound gait
    gallop = export_gait.main(["--steps", "24", "--save", "0",
                               "--task_mode", "gallop", "--device", "cpu"])
    jgal = dataclasses.replace(jcfg, task=dataclasses.replace(
        jcfg.task, task_mode="gallop"))
    _close(gallop, jexport.export_gait_table(jgal, *jfit.opt_with_points(
        jgal.etg), 24))
    assert not np.allclose(gallop, saved)

    sac_j = JSAC(49, 12, jcfg.sac)
    params = sac_j.init(jax.random.key(0)).actor_params
    params = jax.tree.map(lambda x: 3.0 * x, params)   # actions off zero
    bound = np.full(12, 0.3, np.float32)
    pol_j = jexport.export_policy_fn(
        sac_j, sac_j.init(jax.random.key(0))._replace(actor_params=params),
        saved, bound)
    actor = convert.actor_from_flax(jax.tree.map(np.asarray, params),
                                    device="cpu")
    pol_t = policy_export.export_policy_fn(actor, saved, bound, device="cpu")
    aot = policy_export.aot_compile_policy(pol_t, 49)
    obs = np.random.default_rng(2).standard_normal((5, 49)).astype(np.float32)
    for k, i in enumerate((0, 3, 23, 24, 51)):
        out_t = pol_t(_t(obs[k]), i)
        _close(out_t, pol_j(jnp.asarray(obs[k]), jnp.asarray(i)),
               err=f"policy at {i}")
        assert torch.equal(aot(_t(obs[k]), torch.tensor(i)), out_t)


def test_bezier_sequence_matches_jax():
    feet_j = jnp.asarray(jmodel.default_foot_positions())
    feet_t = _t(model.default_foot_positions())
    sj, st = jbezier.init_state(), bezier.init_state(device="cpu")
    kj, kt = jbezier.stepper_init(), bezier.stepper_init(device="cpu")
    for tick in range(40):
        yaw = 0.3 if tick >= 20 else 0.0
        kj = jbezier.stepper_ramp(kj, 0.04, 0.5, yaw, 0.1)
        kt = bezier.stepper_ramp(kt, 0.04, 0.5, yaw, 0.1)
        fj, sj = jbezier.generate_trajectory(
            sj, feet_j, kj.step_length, kj.lateral_fraction, kj.yaw_rate,
            kj.step_velocity, dt=0.01)
        ft, st = bezier.generate_trajectory(
            st, feet_t, kt.step_length, kt.lateral_fraction, kt.yaw_rate,
            kt.step_velocity, dt=0.01)
        _close(ft, fj, err=f"feet at tick {tick}")
        for a, b_ in zip(st, sj):
            _close(a, b_, err=f"state at tick {tick}")
    phase = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    for ours, theirs in ((bezier.bezier_swing(_t(phase), 0.05, 0.2, 0.05),
                          jbezier.bezier_swing(jnp.asarray(phase), 0.05, 0.2,
                                               0.05)),
                         (bezier.sine_stance(_t(phase), 0.05, 0.2, 0.01),
                          jbezier.sine_stance(jnp.asarray(phase), 0.05, 0.2,
                                              0.01))):
        for a, b_ in zip(ours, theirs):
            _close(a, b_)


def test_estimator_sequence_matches_jax():
    rng = np.random.default_rng(3)
    wj, wt = jestimator.window_init(4, 2), estimator.window_init(
        4, 2, device="cpu")
    for _ in range(9):
        v = rng.standard_normal(2).astype(np.float32)
        mj, wj = jestimator.window_update(wj, jnp.asarray(v))
        mt, wt = estimator.window_update(wt, _t(v))
        _close(mt, mj)
    sj = jestimator.estimator_init(window_size=10)
    st = estimator.estimator_init(window_size=10, device="cpu")
    for k in range(30):
        acc = (0.3 * rng.standard_normal(3)).astype(np.float32)
        q = (a1.INIT_MOTOR_ANGLES + 0.1 * rng.standard_normal(12)
             ).astype(np.float32)
        qd = rng.standard_normal(12).astype(np.float32)
        con = rng.random(4) > (0.9 if k % 7 else 1.1)   # none every 7th
        mj, sj = jestimator.estimator_update(
            sj, jnp.asarray(acc), jnp.asarray(q), jnp.asarray(qd),
            jnp.asarray(con), dt=0.01)
        mt, st = estimator.estimator_update(
            st, _t(acc), _t(q), _t(qd), torch.as_tensor(con), dt=0.01)
        _close(mt, mj, err=f"mean {k}")
        _close(st.estimate, sj.estimate, err=f"estimate {k}")
        _close(st.variance, sj.variance, err=f"variance {k}")
