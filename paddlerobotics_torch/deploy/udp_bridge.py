"""UDP low-level robot bridge: the RobotIO protocol over a real socket
(port of the JAX package's ``deploy/udp_bridge.py``; the packets are the
same bytes).

The reference drives hardware through the Unitree SDK's compiled
``RobotInterface`` (a1_robot.py:38,170-171): 60-float low-level motor
commands out (``[q, kp, dq, kd, tau] × 12``), IMU/motor/foot state back.
The bridge is an open UDP protocol with the same payload semantics:

    A1UdpClient (RobotIO) ──UDP──► A1EmulatorServer (the physics, B=1)

- **Command packet** (252 B): ``b'A1C' ver=1 | u32 seq | 60×f32 |
  u32 crc32``. Rows per motor i: ``cmd[5i]=q_des, [5i+1]=kp,
  [5i+2]=qd_des, [5i+3]=kd, [5i+4]=tau_ff``. The all-zero command is the
  SDK's wake handshake and only asks for a state.
- **State packet** (216 B; the JAX module's docstring says 220):
  ``b'A1S' ver=1 | u32 seq | u32 tick | quat wxyz 4f | gyro 3f |
  accel 3f | q 12f | dq 12f | tau_est 12f | foot_force 4f | u32 crc32``.

The client is lock-step (each command solicits one state reply);
``read_state`` returns the reference's derived channels (xyzw quaternion,
rpy, drpy, the Kalman-filtered velocity of ``deploy/estimator``). The
emulator steps ``ops/physics_step.control_step`` once per non-zero command:
the CUDA kernel on the card, the plain ``sim/sbatch`` on the CPU.
"""

from __future__ import annotations

import contextlib
import socket
import struct
import threading
import zlib

import numpy as np
import torch

from paddlerobotics_torch.core.config import SimConfig, TaskConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.deploy import estimator
from paddlerobotics_torch.ops import physics_step
from paddlerobotics_torch.sim import a1_model as a1
from paddlerobotics_torch.sim import sbatch, terrain

CMD_MAGIC = b"A1C\x01"
STATE_MAGIC = b"A1S\x01"
NUM_MOTORS = 12
_CMD_BODY = struct.Struct("<I60f")
_STATE_BODY = struct.Struct("<II50f")
STATE_FLOATS = 50        # quat4 + gyro3 + acc3 + q12 + dq12 + tau12 + foot4
STANCE_LOAD = 50.0       # N reported per foot in contact
CONTACT_FORCE = 5.0      # N above which a foot counts as in contact


def _frame(magic: bytes, body: bytes) -> bytes:
    blob = magic + body
    return blob + struct.pack("<I", zlib.crc32(blob))


def _unframe(magic: bytes, pkt: bytes) -> bytes | None:
    if len(pkt) < len(magic) + 4 or not pkt.startswith(magic):
        return None
    blob, (crc,) = pkt[:-4], struct.unpack("<I", pkt[-4:])
    if zlib.crc32(blob) != crc:
        return None
    return blob[len(magic):]


def pack_command(seq: int, cmd60: np.ndarray) -> bytes:
    cmd60 = np.asarray(cmd60, np.float32)
    if cmd60.shape != (60,):
        raise ValueError(f"a command is 60 floats, not {cmd60.shape}")
    return _frame(CMD_MAGIC, _CMD_BODY.pack(seq & 0xFFFFFFFF,
                                            *cmd60.tolist()))


def unpack_command(pkt: bytes):
    body = _unframe(CMD_MAGIC, pkt)
    if body is None or len(body) != _CMD_BODY.size:
        return None
    vals = _CMD_BODY.unpack(body)
    return vals[0], np.asarray(vals[1:], np.float32)


def pack_state(seq: int, tick: int, quat_wxyz, gyro, accel, q, dq,
               tau_est, foot_force) -> bytes:
    flat = np.concatenate([np.asarray(x, np.float32).ravel() for x in (
        quat_wxyz, gyro, accel, q, dq, tau_est, foot_force)])
    if flat.shape != (STATE_FLOATS,):
        raise ValueError(f"a state is {STATE_FLOATS} floats, not "
                         f"{flat.shape}")
    return _frame(STATE_MAGIC, _STATE_BODY.pack(
        seq & 0xFFFFFFFF, tick & 0xFFFFFFFF, *flat.tolist()))


def unpack_state(pkt: bytes) -> dict | None:
    body = _unframe(STATE_MAGIC, pkt)
    if body is None or len(body) != _STATE_BODY.size:
        return None
    vals = _STATE_BODY.unpack(body)
    f = np.asarray(vals[2:], np.float32)
    return {"seq": vals[0], "tick": vals[1], "quat_wxyz": f[0:4],
            "gyro": f[4:7], "accel": f[7:10], "q": f[10:22],
            "dq": f[22:34], "tau_est": f[34:46], "foot_force": f[46:50]}


def position_command(q_des, kp=None, kd=None) -> np.ndarray:
    """POSITION branch of ApplyAction (a1_robot.py:261-266)."""
    cmd = np.zeros(60, np.float32)
    cmd[0::5] = np.asarray(q_des, np.float32)
    cmd[1::5] = np.asarray(a1.MOTOR_KP if kp is None else kp, np.float32)
    cmd[3::5] = np.asarray(a1.MOTOR_KD if kd is None else kd, np.float32)
    return cmd


def torque_command(tau) -> np.ndarray:
    """TORQUE branch (a1_robot.py:267-269): feed-forward only."""
    cmd = np.zeros(60, np.float32)
    cmd[4::5] = np.asarray(tau, np.float32)
    return cmd


def quat_to_euler(q) -> np.ndarray:
    """wxyz quaternion → (roll, pitch, yaw), PyBullet's convention, float32
    (the JAX package's ``core/math3d.quat_to_euler``)."""
    w, x, y, z = np.asarray(q, np.float32)
    one, two = np.float32(1.0), np.float32(2.0)
    roll = np.arctan2(two * (w * x + y * z), one - two * (x * x + y * y))
    pitch = np.arcsin(np.clip(two * (w * y - z * x), -one, one))
    yaw = np.arctan2(two * (w * z + x * y), one - two * (y * y + z * z))
    return np.asarray([roll, pitch, yaw], np.float32)


class A1UdpClient:
    """RobotIO over the UDP protocol (lock-step command → state).

    ``read_state()`` returns the channels the deployment stack consumes:
    the quaternion as xyzw, rpy, drpy (gyro), q, qd, foot_contact, and the
    base velocity of the ``deploy/estimator`` Kalman filter, which runs on
    the card unless ``device`` says otherwise."""

    def __init__(self, addr, timeout: float = 2.0, dt: float = 0.026,
                 device=None):
        self.device = resolve_device(device)
        self.addr = addr
        self.dt = dt
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.settimeout(timeout)
        self.seq = 0
        self._last: dict | None = None
        self._est = estimator.estimator_init(device=self.device)
        self._vel = np.zeros(3, np.float32)
        # SDK wake handshake: one zero command (a1_robot.py:171)
        self.send_command(np.zeros(60, np.float32))

    def send_command(self, cmd60: np.ndarray) -> dict:
        self.seq += 1
        self.sock.sendto(pack_command(self.seq, cmd60), self.addr)
        while True:
            pkt, _ = self.sock.recvfrom(4096)
            st = unpack_state(pkt)
            if st is not None and st["seq"] == self.seq:
                break
        self._last = st
        self._update_estimator(st)
        return st

    def _update_estimator(self, st: dict) -> None:
        dev = self.device
        host = np.concatenate([st["accel"], st["q"], st["dq"],
                               st["foot_force"] > CONTACT_FORCE])
        x = torch.as_tensor(host, dtype=torch.float32, device=dev)
        vel, self._est = estimator.estimator_update(
            self._est, x[:3], x[3:15], x[15:27], x[27:31] > 0.5, self.dt)
        self._vel = vel.cpu().numpy()

    def apply_action(self, joint_targets: np.ndarray) -> None:
        self.send_command(position_command(joint_targets))

    def read_state(self) -> dict:
        if self._last is None:
            self.send_command(np.zeros(60, np.float32))
        st = self._last
        qw = st["quat_wxyz"]
        quat_xyzw = np.asarray([qw[1], qw[2], qw[3], qw[0]], np.float32)
        return {"q": st["q"], "qd": st["dq"], "quat": quat_xyzw,
                "rpy": quat_to_euler(qw), "drpy": st["gyro"],
                "foot_contact": (st["foot_force"]
                                 > CONTACT_FORCE).astype(np.float32),
                "v": self._vel, "seq": st["seq"], "tick": st["tick"]}

    def close(self) -> None:
        self.sock.close()


class A1EmulatorServer:
    """Sim-backed robot on the far end of the socket, on the card unless
    ``device`` says otherwise.

    Each non-zero command steps one control step at B=1 through
    ``ops/physics_step.control_step`` with the hybrid PD law: the packet's
    kp / kd as ``BDynParams.motor_kp`` / ``motor_kd``, its q_des, qd_des and
    tau_ff (kp = kd = 0 with tau is TORQUE; qd = tau = 0 is POSITION). The
    all-zero wake command steps nothing. One state packet per command.

    The kernel is built and stepped once before the socket opens. An
    exception on the serving thread stops it; ``check()`` and ``close()``
    raise it."""

    def __init__(self, sim_cfg: SimConfig | None = None,
                 height: float = 0.32, host: str = "127.0.0.1", device=None):
        self.device = dev = resolve_device(device)
        self.cfg = sim_cfg or SimConfig()
        self.h_fn = terrain.height_fn(TaskConfig())
        self.rb = sbatch.init_robot(1, height, device=dev)
        self.params = sbatch.BDynParams.default(1, device=dev)
        self.tick = 0
        self.error: BaseException | None = None
        z = torch.zeros(12, 1, device=dev)
        physics_step.control_step(self.rb, self.rb.s.q, self.params,
                                  self.cfg, self.h_fn, qd_ref=z, tau_ff=z)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, 0))
        self.addr = self.sock.getsockname()
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            while not self._stop:
                try:
                    pkt, peer = self.sock.recvfrom(4096)
                except OSError:
                    return
                parsed = unpack_command(pkt)
                if parsed is None:
                    continue        # bad magic or CRC: dropped, as UDP may
                seq, cmd = parsed
                try:
                    if np.any(cmd != 0.0):
                        self._apply(cmd)
                    reply = self._state_packet(seq)
                except Exception as e:     # recorded for check()
                    self.error = e
                    return
                self.sock.sendto(reply, peer)

    def _apply(self, cmd: np.ndarray) -> None:
        # rows q_des, kp, qd_des, kd, tau_ff, each (12, 1)
        c = torch.as_tensor(np.ascontiguousarray(cmd.reshape(12, 5).T),
                            device=self.device)[..., None]
        self.params = self.params._replace(motor_kp=c[1], motor_kd=c[3])
        self.rb = physics_step.control_step(self.rb, c[0], self.params,
                                            self.cfg, self.h_fn,
                                            qd_ref=c[2], tau_ff=c[4])
        self.tick += self.cfg.action_repeat

    def _state_packet(self, seq: int) -> bytes:
        s, rb = self.rb.s, self.rb
        host = torch.cat([s.quat[:, 0], s.w[:, 0], s.q[:, 0], s.qd[:, 0],
                          rb.tau[:, 0],
                          rb.contact.foot_contact[:, 0].to(torch.float32)
                          * STANCE_LOAD]).cpu().numpy()
        return pack_state(seq, self.tick, host[0:4], host[4:7],
                          np.zeros(3, np.float32), host[7:19], host[19:31],
                          host[31:43], host[43:47])

    def check(self) -> None:
        if self.error is not None:
            raise RuntimeError("the emulator's serving thread raised "
                               f"{type(self.error).__name__}: {self.error}"
                               ) from self.error

    def close(self) -> None:
        self._stop = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self._thread.join(timeout=2.0)
        self.check()
