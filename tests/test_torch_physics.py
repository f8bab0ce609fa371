"""Port parity: the PyTorch plain physics against the JAX SoA path.

The same inputs (numpy, fixed seed) go through the JAX package's
``sim/sbatch.control_step`` and the port's ``ops/physics_step.control_step``,
which on CPU tensors runs the plain version ``sim/sbatch.control_step``.
Tolerances: positions, orientation and joint angles to 1e-5 and torques
to 1e-4, as ``tests/test_pallas_physics.py`` holds the two JAX paths;
velocities to 1e-4, because XLA and ATen round sin/cos/sqrt (and contract
products) differently on the CPU and the velocity is the integrated
quantity one derivative up (a 1e-5 velocity difference is a 2.6e-8 angle
difference after one 2.6 ms substep).
"""

import jax
import numpy as np
import pytest

from paddlerobotics_tpu.core.config import SimConfig as JSimConfig
from paddlerobotics_tpu.envs import randomize as jrandomize
from paddlerobotics_tpu.sim import sbatch as jsb

from paddlerobotics_torch.core.config import SimConfig, TaskConfig
from paddlerobotics_torch.ops import physics_step
from paddlerobotics_torch.sim import terrain

from torch_parity import assert_match, run_both, target


def test_control_step_matches_jax_with_pallas_interpret():
    """test_pallas_physics' first case, plus the Pallas kernel itself run
    as its tests run it on the CPU (interpret mode)."""
    B = 8
    rb = jsb.init_robot(B, height=0.30)
    p = jsb.BDynParams.default(B)
    rb_j, rb_t = run_both(rb, p, target(B, 0.03), steps=3)
    assert_match(rb_j, rb_t)
    rb_pal, rb_t2 = run_both(rb, p, target(B, 0.03), steps=1, pallas=True)
    assert_match(rb_pal, rb_t2)


def test_substep_ring_matches_jax():
    B = 4
    rb_j, rb_t = run_both(jsb.init_robot(B, height=0.30),
                          jsb.BDynParams.default(B), target(B, 0.05))
    assert_match(rb_j, rb_t)


def test_hybrid_matches_jax():
    B = 4
    qd_ref = 0.3 * np.broadcast_to(np.sin(np.arange(12.0))[:, None], (12, B))
    tau_ff = 1.5 * np.broadcast_to(np.cos(np.arange(12.0))[:, None], (12, B))
    rb_j, rb_t = run_both(jsb.init_robot(B, height=0.30),
                          jsb.BDynParams.default(B), target(B, 0.02),
                          steps=3, qd_ref=qd_ref.astype(np.float32),
                          tau_ff=tau_ff.astype(np.float32))
    assert_match(rb_j, rb_t)


def test_pd_latency_matches_jax():
    B = 4
    rb_j, rb_t = run_both(jsb.init_robot(B, height=0.30),
                          jsb.BDynParams.default(B), target(B, 0.1),
                          sim_kw={"pd_latency": 1.5 * JSimConfig().substep_dt},
                          steps=2)
    assert_match(rb_j, rb_t)


@pytest.mark.parametrize("L", [2, 3])
def test_short_ring_matches_jax(L):
    B = 4
    rb_j, rb_t = run_both(jsb.init_robot(B, height=0.30, hist_len=L),
                          jsb.BDynParams.default(B), target(B, 0.05),
                          steps=2)
    assert_match(rb_j, rb_t)
    assert rb_t.hist_head == L - 1
    np.testing.assert_allclose(rb_t.obs_hist[-1, :12].numpy(),
                               rb_t.s.q.numpy(), atol=1e-6)


def test_torque_mode_matches_jax():
    B = 4
    rng = np.random.default_rng(3)
    tau = (5.0 * rng.standard_normal((12, B))).astype(np.float32)
    rb_j, rb_t = run_both(jsb.init_robot(B, height=0.30),
                          jsb.BDynParams.default(B), tau, steps=2,
                          torque_mode=True)
    assert_match(rb_j, rb_t)


def test_random_dynamics_long_ring_matches_jax():
    """Non-default randomized BDynParams (JAX's own draws, half the DR
    range) on the DR ring length L=40 (long-ring block writes)."""
    B = 8
    keys = jax.random.split(jax.random.key(7), B)
    dp = jax.vmap(lambda k: jrandomize.sample_dynamics(k, scale=0.5))(keys)
    p = jsb.BDynParams.from_leading(dp)
    rb = jsb.init_robot(B, height=0.30, hist_len=40)
    rb_j, rb_t = run_both(rb, p, target(B, 0.03), steps=2)
    assert rb_t.obs_hist.shape[0] == 40
    assert_match(rb_j, rb_t)


def test_on_rack_matches_jax():
    B = 4
    rb_j, rb_t = run_both(jsb.init_robot(B, height=0.30),
                          jsb.BDynParams.default(B), target(B, 0.1),
                          sim_kw={"on_rack": True}, steps=2)
    assert_match(rb_j, rb_t)
    # the base stays welded in place
    np.testing.assert_array_equal(rb_t.s.pos[2].numpy(), np.float32(0.30))
    np.testing.assert_array_equal(rb_t.s.v.numpy(), 0.0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The kernel wrapper's argument checks (the CUDA path's marshaling,
    exercised on CPU tensors)."""
    from paddlerobotics_torch.sim import sbatch

    B = 4
    rb = sbatch.init_robot(B, 0.3)
    p = sbatch.BDynParams.default(B)
    h = terrain.height_fn(TaskConfig())
    act = rb.s.q.clone()
    ptrs, floats, ints, outs, _ = physics_step.launch_args(
        rb, act, p, SimConfig(), h, False, None, None)
    assert len(ptrs) == physics_step.N_PTRS
    assert ints == [B, 10, 10, 0, 1, 0, 0, 0, 0, 0]
    assert outs[-1].shape == (10, 31, B)
    with pytest.raises(ValueError, match="contiguous"):
        physics_step.launch_args(rb, act.T.contiguous().T, p, SimConfig(), h,
                                 False, None, None)
    with pytest.raises(TypeError, match="float32"):
        physics_step.launch_args(rb, act.double(), p, SimConfig(), h,
                                 False, None, None)
    with pytest.raises(ValueError, match="shape"):
        physics_step.launch_args(rb, act[:6], p, SimConfig(), h, False,
                                 None, None)
