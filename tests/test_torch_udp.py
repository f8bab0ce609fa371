"""Port parity of the robot I/O tools: the UDP bridge (``deploy/
udp_bridge``), the exercise probe (``cli/robot_exercise``) and the episode
renderer (``deploy/visualize``).

Packets are the JAX package's bytes. The port's emulator and the JAX
emulator take the same command sequence over their sockets (nominal
dynamics; the blend to the init pose and a hip sinusoid, mild as the
parity tests of the physics draw them, ROADMAP Queue C), and their state
packets agree at 1e-4 absolute and relative (a torque is kp = 100 times a
joint error, so its drift is the joints' times 100), as do the exercise
traces they give ``run_exercise``. On the CPU the emulator runs the plain
physics and launches no kernel.
"""

import dataclasses
import functools

import numpy as np
import pytest

from paddlerobotics_tpu.cli import robot_exercise as j_exercise
from paddlerobotics_tpu.deploy import udp_bridge as jub
from paddlerobotics_tpu.deploy import visualize as j_vis

from paddlerobotics_torch.cli import robot_exercise
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.deploy import udp_bridge as ub
from paddlerobotics_torch.deploy import visualize
from paddlerobotics_torch.deploy.realtime import SimRobotIO
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.ops import physics_step
from paddlerobotics_torch.sim import a1_model as a1
from torch_parity import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
INIT = np.asarray(a1.INIT_MOTOR_ANGLES, np.float32)


def test_packets_are_the_jax_bytes():
    rng = np.random.default_rng(0)
    cmd = rng.standard_normal(60).astype(np.float32)
    pkt = ub.pack_command(42, cmd)
    assert pkt == jub.pack_command(42, cmd) and len(pkt) == 252
    seq, out = ub.unpack_command(pkt)
    assert seq == 42 and np.array_equal(out, cmd)
    bad = bytearray(pkt)
    bad[10] ^= 0xFF
    assert ub.unpack_command(bytes(bad)) is None
    assert ub.unpack_command(b"XXX\x01" + pkt[4:]) is None
    parts = [rng.standard_normal(n).astype(np.float32)
             for n in (4, 3, 3, 12, 12, 12, 4)]
    st = ub.pack_state(7, 2 ** 32 + 130, *parts)
    assert st == jub.pack_state(7, 2 ** 32 + 130, *parts) and len(st) == 216
    a, b = ub.unpack_state(st), jub.unpack_state(st)
    assert a.keys() == b.keys() and a["tick"] == 130
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    q = np.linspace(-1, 1, 12).astype(np.float32)
    np.testing.assert_array_equal(ub.position_command(q),
                                  jub.position_command(q))
    np.testing.assert_array_equal(ub.torque_command(q), jub.torque_command(q))
    with pytest.raises(ValueError):
        ub.pack_command(1, np.zeros(59, np.float32))


def _commands(n_blend=10, n_sin=20):
    """A blend from a crouch to the init pose, then a hip sinusoid with a
    feed-forward torque and a velocity target (the hybrid law's terms)."""
    crouch = INIT * np.float32(1.1)
    cmds = [ub.position_command(crouch + (INIT - crouch) * min(t / 6, 1.0))
            for t in range(n_blend)]
    for t in range(n_sin):
        q = INIT.copy()
        q[1::3] += 0.2 * np.sin(0.3 * t)
        c = ub.position_command(q)
        c[2::5] = 0.1 * np.cos(0.3 * t)
        c[4::5] = 0.5
        cmds.append(c)
    return cmds


@pytest.fixture(scope="module")
def emulators():
    j = jub.A1EmulatorServer()
    t = ub.A1EmulatorServer(device="cpu")
    yield j, t
    j.close()
    t.close()


def test_emulator_states_match_jax(emulators):
    """The same commands through both emulators, wake handshakes included:
    every state packet's floats within 1e-4, seq and tick equal; the zero
    command steps nothing; no kernel launch on the CPU."""
    js, ts = emulators
    jc = jub.A1UdpClient(js.addr, timeout=60.0)
    tc = ub.A1UdpClient(ts.addr, timeout=60.0, device="cpu")
    launches = physics_step.control_step.launches
    try:
        t0 = tc.send_command(np.zeros(60, np.float32))["tick"]
        assert tc.send_command(np.zeros(60, np.float32))["tick"] == t0
        jc.send_command(np.zeros(60, np.float32))
        jc.send_command(np.zeros(60, np.float32))
        for cmd in _commands():
            a, b = tc.send_command(cmd), jc.send_command(cmd)
            assert (a["seq"], a["tick"]) == (b["seq"], b["tick"])
            for k in ("quat_wxyz", "gyro", "accel", "q", "dq", "tau_est",
                      "foot_force"):
                np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=TOL,
                                           err_msg=f"{k} at seq {a['seq']}")
        ra, rb = tc.read_state(), jc.read_state()
        for k in ("q", "qd", "quat", "rpy", "drpy", "foot_contact", "v"):
            np.testing.assert_allclose(ra[k], rb[k], atol=TOL, rtol=TOL,
                                       err_msg=k)
    finally:
        jc.close()
        tc.close()
    ts.check()
    assert physics_step.control_step.launches == launches


def test_exercise_over_udp_matches_jax(emulators, tmp_path):
    """run_exercise through each package's client and emulator: the npz
    traces have the JAX file's keys and agree at 1e-4."""
    js, ts = emulators
    jc = jub.A1UdpClient(js.addr, timeout=60.0)
    tc = ub.A1UdpClient(ts.addr, timeout=60.0, device="cpu")
    try:
        rec_j = j_exercise.run_exercise(jc, steps=20, blend_steps=6, dt=0.0)
        rec_t = robot_exercise.run_exercise(tc, steps=20, blend_steps=6)
    finally:
        jc.close()
        tc.close()
    rec_j.save(str(tmp_path / "j_obs_sin.npz"))
    rec_t.save(str(tmp_path / "t_obs_sin.npz"))
    dj, dt = (np.load(tmp_path / f"{s}_obs_sin.npz") for s in "jt")
    assert set(dt.files) == set(dj.files) == {
        "motor_angle", "motor_velocity", "foot_contact", "v", "imu", "rpy",
        "action"}
    for k in dj.files:
        assert dt[k].shape == dj[k].shape, k
        np.testing.assert_allclose(dt[k], dj[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    hip = dt["motor_angle"][:, 1]
    assert hip.max() - hip.min() > 0.05


def test_exercise_on_the_rack_and_the_cli(tmp_path, monkeypatch):
    """The SimRobotIO path on the rack (the JAX test's checks: the hips
    follow the sinusoid, the base does not move) and the CLI over a local
    emulator, which writes <suffix>_obs_sin.npz."""
    cfg = QuadrupedConfig()
    cfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, on_rack=True),
        etg=dataclasses.replace(cfg.etg, step_y=0.0))
    io = SimRobotIO(BatchedQuadrupedEnv(cfg, 1, device="cpu"))
    rec = robot_exercise.run_exercise(io, steps=20, blend_steps=4, freq=4.0)
    q = np.asarray(rec.rows["motor_angle"])
    assert q.shape == (20, 12)
    assert q[:, 1].max() > INIT[1] + 0.05 and q[:, 1].min() < INIT[1] - 0.05
    cmd = np.asarray(rec.rows["action"])[:, 1]
    assert np.abs(cmd - q[:, 1]).mean() < 0.15
    assert np.abs(np.asarray(rec.rows["v"])).max() < 1e-3
    monkeypatch.chdir(tmp_path)
    # the CLI blends over 300 commands first, as the reference does: 2 here
    monkeypatch.setattr(robot_exercise, "run_exercise", functools.partial(
        robot_exercise.run_exercise, blend_steps=2))
    robot_exercise.main(["--udp", "emulator", "--device", "cpu", "--steps",
                         "4", "--suffix", "cli"])
    assert np.load(tmp_path / "cli_obs_sin.npz")["motor_angle"].shape == \
        (4, 12)


def test_visualize_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    pos = np.array([0.3, -0.1, 0.29])
    quat = rng.standard_normal(4)
    quat /= np.linalg.norm(quat)
    q = INIT + 0.2 * rng.standard_normal(12)
    a, b = visualize._fk_points(pos, quat, q), j_vis._fk_points(pos, quat, q)
    for k in ("hip", "knee", "foot", "R"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-12, err_msg=k)
    from paddlerobotics_torch.core.config import TaskConfig
    from paddlerobotics_torch.sim import terrain

    h_fn = terrain.height_fn(TaskConfig(task_mode="up_stair",
                                        terrain_start=0.0))
    frame = visualize.render_frame(pos, np.array([1.0, 0, 0, 0]), INIT,
                                   h_fn=h_fn, contacts=[1, 0, 1, 0])
    assert frame.shape == (480, 640, 3) and frame.dtype == np.uint8
    assert frame.std() > 5
    states = [(np.tile(pos[:, None], (1, 2)), np.tile([[1.0], [0], [0], [0]],
                                                     (1, 2)),
               np.tile(INIT[:, None], (1, 2)), None)] * 3
    n = visualize.render_episode(states, str(tmp_path / "ep.mp4"),
                                 env_index=1)
    assert n == 3 and (tmp_path / "ep.mp4").stat().st_size > 0
