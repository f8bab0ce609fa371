"""Shared helpers of the port's parity tests: the JAX and PyTorch physics
stepped from the same start, compared at stated tolerances (see
test_torch_physics for the reasons)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.core.config import SimConfig as JSimConfig
from paddlerobotics_tpu.core.config import TaskConfig as JTaskConfig
from paddlerobotics_tpu.ops.pallas.physics_step import control_step_pallas
from paddlerobotics_tpu.sim import a1_model as ja1
from paddlerobotics_tpu.sim import sbatch as jsb
from paddlerobotics_tpu.sim import terrain as jterrain

from paddlerobotics_torch import convert
from paddlerobotics_torch.core.config import SimConfig, TaskConfig
from paddlerobotics_torch.ops import physics_step
from paddlerobotics_torch.sim import terrain

POS_ATOL = 1e-5     # pos, quat, q
VEL_ATOL = 1e-4     # w, v, qd
TAU_ATOL = 1e-4
# obs_hist rows [q | qd | quat | w] and their tolerances
_HIST_ROWS = ((slice(0, 12), POS_ATOL), (slice(12, 24), VEL_ATOL),
              (slice(24, 28), POS_ATOL), (slice(28, 31), VEL_ATOL))

_jit_step = jax.jit(jsb.control_step,
                    static_argnames=("cfg", "h_fn", "torque_mode"))


def robot_np(rb) -> dict:
    """A JAX BRobot as numpy arrays under its field names."""
    s, c = rb.s, rb.contact
    out = {f: np.asarray(getattr(s, f)) for f in ("pos", "quat", "w", "v",
                                                  "q", "qd")}
    out.update(last_action=np.asarray(rb.last_action),
               tau=np.asarray(rb.tau), foot_pos=np.asarray(c.foot_pos),
               foot_contact=np.asarray(c.foot_contact),
               knee_contact=np.asarray(c.knee_contact),
               base_contact=np.asarray(c.base_contact),
               obs_hist=np.asarray(rb.obs_hist),
               hist_head=int(rb.hist_head))
    return out


def dyn_np(p) -> dict:
    return {f: np.asarray(getattr(p, f)) for f in jsb.BDynParams._fields}


def run_both(rb_j, p_j, target, sim_kw=None, task_kw=None, steps=1,
             torque_mode=False, qd_ref=None, tau_ff=None, pallas=False):
    """Step the JAX and torch paths from the same start; return both."""
    jcfg = JSimConfig(**(sim_kw or {}))
    tcfg = SimConfig(**(sim_kw or {}))
    jh = jterrain.height_fn(JTaskConfig(**(task_kw or {})))
    th = terrain.height_fn(TaskConfig(**(task_kw or {})))
    rb_t = convert.robot_from_numpy(robot_np(rb_j), device="cpu")
    p_t = convert.dyn_from_numpy(dyn_np(p_j), device="cpu")
    tt = lambda x: None if x is None else torch.as_tensor(np.asarray(x))
    jx = lambda x: None if x is None else jnp.asarray(x)
    launches = physics_step.control_step.launches
    for _ in range(steps):
        if pallas:
            rb_j = control_step_pallas(rb_j, jnp.asarray(target), p_j, jcfg,
                                       jh, torque_mode=torque_mode,
                                       qd_ref=jx(qd_ref), tau_ff=jx(tau_ff),
                                       block_b=rb_j.s.q.shape[-1],
                                       interpret=True)
        else:
            rb_j = _jit_step(rb_j, jnp.asarray(target), p_j, jcfg, jh,
                             torque_mode=torque_mode, qd_ref=jx(qd_ref),
                             tau_ff=jx(tau_ff))
        rb_t = physics_step.control_step(rb_t, tt(target), p_t, tcfg, th,
                                         torque_mode=torque_mode,
                                         qd_ref=tt(qd_ref), tau_ff=tt(tau_ff))
    # CPU tensors take the plain version: no kernel launch
    assert physics_step.control_step.launches == launches
    return rb_j, rb_t


def assert_match(rb_j, rb_t):
    for f in ("pos", "quat", "w", "v", "q", "qd"):
        np.testing.assert_allclose(
            getattr(rb_t.s, f).numpy(), np.asarray(getattr(rb_j.s, f)),
            atol=VEL_ATOL if f in ("w", "v", "qd") else POS_ATOL, err_msg=f)
    np.testing.assert_allclose(rb_t.tau.numpy(), np.asarray(rb_j.tau),
                               atol=TAU_ATOL)
    np.testing.assert_array_equal(rb_t.contact.foot_contact.numpy(),
                                  np.asarray(rb_j.contact.foot_contact))
    np.testing.assert_array_equal(rb_t.contact.knee_contact.numpy(),
                                  np.asarray(rb_j.contact.knee_contact))
    np.testing.assert_array_equal(rb_t.contact.base_contact.numpy(),
                                  np.asarray(rb_j.contact.base_contact))
    np.testing.assert_allclose(rb_t.contact.foot_pos.numpy(),
                               np.asarray(rb_j.contact.foot_pos),
                               atol=POS_ATOL)
    assert rb_t.hist_head == int(rb_j.hist_head)
    for rows, atol in _HIST_ROWS:
        np.testing.assert_allclose(rb_t.obs_hist[:, rows].numpy(),
                                   np.asarray(rb_j.obs_hist)[:, rows],
                                   atol=atol)


def target(B, offset):
    return (np.broadcast_to(ja1.INIT_MOTOR_ANGLES[:, None], (12, B))
            + offset).astype(np.float32)


def _flax_leaf(tree, path):
    tree = tree.get("params", tree)
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def assert_module_matches(module, params, atol, err=""):
    """Every parameter of a port module against its flax leaf."""
    for prm, path, transposed in convert.flax_leaves(module):
        p = prm.detach().cpu().numpy()
        np.testing.assert_allclose(p.T if transposed else p,
                                   _flax_leaf(params, path), atol=atol,
                                   err_msg=f"{err} {'/'.join(path)}")


def assert_adam_matches(opt, module, adam, atol, err=""):
    """A torch Adam's moments and step against optax's ScaleByAdamState
    (``module`` names the flax paths; None for the scalar log_alpha)."""
    params = opt.param_groups[0]["params"]
    leaves = (convert.flax_leaves(module) if module is not None
              else [(params[0], (), False)])
    for prm, path, transposed in leaves:
        st = opt.state[prm]
        assert float(st["step"]) == int(np.asarray(adam.count)), err
        for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            t = st[ours].detach().cpu().numpy()
            j = _flax_leaf(theirs, path) if path else np.asarray(theirs)
            np.testing.assert_allclose(t.T if transposed else t, j,
                                       atol=atol,
                                       err_msg=f"{err} {ours} {path}")


def assert_sac_matches(ts, js, atol):
    """A port SACState against a JAX SACState: weights, targets, the three
    Adam states and log_alpha."""
    assert_module_matches(ts.actor, js.actor_params, atol, "actor")
    assert_module_matches(ts.critic, js.critic_params, atol, "critic")
    assert_module_matches(ts.target_critic, js.target_critic_params, atol,
                          "target")
    assert_adam_matches(ts.actor_opt, ts.actor, js.actor_opt[0], atol,
                        "actor_opt")
    assert_adam_matches(ts.critic_opt, ts.critic, js.critic_opt[0], atol,
                        "critic_opt")
    assert_adam_matches(ts.alpha_opt, None, js.alpha_opt[0], atol,
                        "alpha_opt")
    np.testing.assert_allclose(float(ts.log_alpha.detach()),
                               float(js.log_alpha),
                               atol=atol)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for a test (imported by a test file, it applies
    to each of its tests): the suite's workers share the cores, and
    spinning thread pools slow every worker by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
