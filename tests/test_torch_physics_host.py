"""The physics kernel's own stages, built for the CPU, against JAX.

``ops/csrc/physics_step.cu`` compiles under a host compiler too (``g++ -x
c++``). Its host entry ``prt_control_step_host`` runs the stage functions
of the CUDA kernel (motor law, leg passes 1 and 2, the leg-order sum and
base solve, leg pass 3, integration, the snapshot and pd-ring stores) env
by env, with the legs in a loop and the leg-to-base exchange through an
array in leg order. Driven through the wrapper's ``launch_args`` on CPU
tensors, it is held against JAX's ``sim/sbatch.control_step`` at
``test_torch_physics``' tolerances (1e-5 positions and angles, 1e-4
velocities and torques). ``on_rack`` is held against the port's plain
version, which the kernel follows where the JAX megakernel has no on_rack
branch (ROADMAP Queue C).
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.core.config import SimConfig as JSimConfig
from paddlerobotics_tpu.core.config import TaskConfig as JTaskConfig
from paddlerobotics_tpu.envs import randomize as jrandomize
from paddlerobotics_tpu.sim import sbatch as jsb
from paddlerobotics_tpu.sim import terrain as jterrain

from paddlerobotics_torch import convert
from paddlerobotics_torch.core.config import SimConfig, TaskConfig
from paddlerobotics_torch.ops import physics_step
from paddlerobotics_torch.sim import sbatch, terrain

from torch_parity import _jit_step, assert_match, dyn_np, robot_np, target

B = 8


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """physics_step.cu built with the host compiler and loaded."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel's host entry")
    d = tmp_path_factory.mktemp("physics_host")
    (d / "physics_consts.h").write_text(physics_step.consts_header())
    so = d / "libphysics_host.so"
    res = subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
         "-shared", "-fPIC", "-I", str(d), "-o", str(so),
         str(physics_step.SOURCE)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.prt_control_step_host.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    lib.prt_control_step_host.restype = ctypes.c_int
    lib.prt_launch_plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.prt_launch_plan.restype = None
    return lib


def host_step(lib, rb, action, p, cfg, h_fn, torque_mode=False, qd_ref=None,
              tau_ff=None):
    """One control step through the host entry, marshaled by the wrapper."""
    ptrs, floats, ints, outs, keep = physics_step.launch_args(
        rb, action, p, cfg, h_fn, torque_mode, qd_ref, tau_ff)
    c_p, c_f, c_i = physics_step.c_arrays(ptrs, floats, ints)
    assert lib.prt_control_step_host(c_p, len(ptrs), c_f, len(floats), c_i,
                                     len(ints)) == 0
    del keep
    return physics_step.robot_from_outputs(rb, action, outs)


def _obstacle_start():
    """Bases spread over the obstacle field, standing on its heights."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 3.0, B).astype(np.float32)
    y = rng.uniform(-0.4, 0.4, B).astype(np.float32)
    h = jterrain.height_fn(JTaskConfig(task_mode="obstacle",
                                       terrain_start=0.0))
    z = 0.30 + np.asarray(h(jnp.asarray(x), jnp.asarray(y)))
    rb = jsb.init_robot(B, height=jnp.asarray(z, jnp.float32))
    pos = jnp.stack([jnp.asarray(x), jnp.asarray(y), rb.s.pos[2]])
    return rb.replace(s=rb.s.replace(pos=pos))


def _dr_params():
    keys = jax.random.split(jax.random.key(7), B)
    dp = jax.vmap(lambda k: jrandomize.sample_dynamics(k, scale=0.5))(keys)
    return jsb.BDynParams.from_leading(dp)


_rng = np.random.default_rng(3)
_TORQUE = (5.0 * _rng.standard_normal((12, B))).astype(np.float32)
_QD_REF = (0.3 * np.broadcast_to(np.sin(np.arange(12.0))[:, None], (12, B))
           ).astype(np.float32)
_TAU_FF = (1.5 * np.broadcast_to(np.cos(np.arange(12.0))[:, None], (12, B))
           ).astype(np.float32)

# name: (start robot, params, action, sim kwargs, task kwargs, step kwargs)
_CASES = {
    "default": lambda: (jsb.init_robot(B, height=0.30),
                        jsb.BDynParams.default(B), target(B, 0.03), {}, {},
                        {}),
    "dr_long_ring": lambda: (jsb.init_robot(B, height=0.30, hist_len=40),
                             _dr_params(), target(B, 0.03), {}, {}, {}),
    "torque": lambda: (jsb.init_robot(B, height=0.30),
                       jsb.BDynParams.default(B), _TORQUE, {}, {},
                       {"torque_mode": True}),
    "hybrid": lambda: (jsb.init_robot(B, height=0.30),
                       jsb.BDynParams.default(B), target(B, 0.02), {}, {},
                       {"qd_ref": _QD_REF, "tau_ff": _TAU_FF}),
    "pd_latency": lambda: (jsb.init_robot(B, height=0.30),
                           jsb.BDynParams.default(B), target(B, 0.1),
                           {"pd_latency": 1.5 * JSimConfig().substep_dt},
                           {}, {}),
    "obstacle": lambda: (_obstacle_start(), jsb.BDynParams.default(B),
                         target(B, 0.03), {},
                         {"task_mode": "obstacle", "terrain_start": 0.0}, {}),
    "on_rack": lambda: (jsb.init_robot(B, height=0.30),
                        jsb.BDynParams.default(B), target(B, 0.1),
                        {"on_rack": True}, {}, {}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_host_build_of_the_kernel_matches(host_lib, case):
    rb_j, p_j, act, sim_kw, task_kw, kw = _CASES[case]()
    cfg = SimConfig(**sim_kw)
    h_fn = terrain.height_fn(TaskConfig(**task_kw))
    rb_h = convert.robot_from_numpy(robot_np(rb_j), device="cpu")
    p_h = convert.dyn_from_numpy(dyn_np(p_j), device="cpu")
    tt = lambda x: None if x is None else torch.as_tensor(np.asarray(x))
    act_t = tt(act)
    qd_ref, tau_ff = tt(kw.get("qd_ref")), tt(kw.get("tau_ff"))
    torque = kw.get("torque_mode", False)
    if case == "on_rack":
        # the reference: the port's plain version on the same start
        rb_r = rb_h
        step_ref = lambda rb: sbatch.control_step(rb, act_t, p_h, cfg, h_fn,
                                                  torque)
    else:
        rb_r = rb_j
        jcfg = JSimConfig(**sim_kw)
        jh = jterrain.height_fn(JTaskConfig(**task_kw))
        jx = lambda x: None if x is None else jnp.asarray(x)
        step_ref = lambda rb: _jit_step(rb, jnp.asarray(act), p_j, jcfg, jh,
                                        torque_mode=torque,
                                        qd_ref=jx(kw.get("qd_ref")),
                                        tau_ff=jx(kw.get("tau_ff")))
    for _ in range(2):
        rb_r = step_ref(rb_r)
        rb_h = host_step(host_lib, rb_h, act_t, p_h, cfg, h_fn, torque,
                         qd_ref, tau_ff)
    assert_match(rb_r, rb_h)
    if case == "on_rack":
        np.testing.assert_array_equal(rb_h.s.v.numpy(), 0.0)
    if case == "obstacle":
        # the field is exercised: some feet stand on an obstacle
        h = np.asarray(terrain.height_fn(TaskConfig(**task_kw))(
            rb_h.contact.foot_pos[0], rb_h.contact.foot_pos[1]))
        assert (h > 0).any()


def test_launch_plan_matches_the_source(host_lib):
    """The wrapper reports the plan the source launches: a warp per leg and
    a lane per env, the fewest blocks that cover B, and the legs' 33
    floats per env in shared memory, double-buffered."""
    for n in (1, 32, 33, 4093, 4096):
        out = (ctypes.c_int * 4)()
        host_lib.prt_launch_plan(n, out)
        plan = physics_step.launch_plan(n, lib=host_lib)
        assert list(out) == [plan[k] for k in physics_step.PLAN_NAMES]
        envs = plan["threads"] // plan["threads_per_env"]
        assert (plan["threads_per_env"], envs) == (4, 32)
        assert (plan["blocks"] - 1) * envs < n <= plan["blocks"] * envs
        assert plan["smem_bytes"] == 2 * 4 * 33 * envs * 4


def test_a_nan_made_in_the_kernel_reaches_its_outputs(host_lib):
    """Env 0 without base or leg mass makes NaN inside the step (a singular
    articulated inertia). The kernel's max / min / clamp return NaN as
    torch.clamp does, so its outputs hold NaN where the plain version's do
    (fmaxf and fminf would clamp a NaN velocity back into range) and the
    other envs are untouched."""
    rb = sbatch.init_robot(B, 0.30, hist_len=2)
    p = sbatch.BDynParams.default(B)
    base, leg = p.base_mass_scale.clone(), p.leg_mass_scale.clone()
    base[0] = 0.0
    leg[:, 0] = 0.0
    p = p._replace(base_mass_scale=base, leg_mass_scale=leg)
    cfg, h_fn = SimConfig(), terrain.height_fn(TaskConfig())
    act = rb.s.q.clone()
    got = host_step(host_lib, rb, act, p, cfg, h_fn)
    want = sbatch.control_step(rb, act, p, cfg, h_fn)
    for f in ("pos", "quat", "w", "v", "q", "qd"):
        g, w = getattr(got.s, f), getattr(want.s, f)
        np.testing.assert_array_equal(g.isnan().numpy(), w.isnan().numpy(),
                                      err_msg=f)
        assert g[:, 0].isnan().all(), f
        assert g[:, 1:].isfinite().all(), f
    np.testing.assert_array_equal(got.obs_hist.isnan().numpy(),
                                  want.obs_hist.isnan().numpy())
