"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points refuse to run quietly on the CPU."""

import os
import pathlib
import subprocess
import sys
import tempfile

import pytest
import torch

import numpy as np

from paddlerobotics_torch import convert, graft_entry
from paddlerobotics_torch.algos import es, replay
from paddlerobotics_torch.algos.bc import BC
from paddlerobotics_torch.algos.networks import Actor
from paddlerobotics_torch.algos.sac import SAC
from paddlerobotics_torch.cli import (bc_train, collect_act_emb,
                                      collect_data, dynamics_id, env_bench,
                                      eval_matrix, export_gait,
                                      parallel_train_attn, pretrain_etg,
                                      robot_exercise, serve_grpc,
                                      serving_bench, train_attention,
                                      train_bench)
from paddlerobotics_torch.core.config import ESConfig, QuadrupedConfig
from paddlerobotics_torch.deploy import (bezier, estimator, policy_export,
                                         realtime, udp_bridge)
from paddlerobotics_torch.envs import make_env
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.envs.quadruped_env import QuadrupedEnv
from paddlerobotics_torch.etg import fit
from paddlerobotics_torch.hri import data as hri_data
from paddlerobotics_torch.hri import export, synthetic_scene, tracker
from paddlerobotics_torch.hri.actions import (DiscreteController,
                                              SalutationClsTree)
from paddlerobotics_torch.hri import grpc_transport as gt
from paddlerobotics_torch.hri import pg_proto as pb
from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                     AttnCtrlConfig)
from paddlerobotics_torch.hri.native_pipeline import ServiceCallbacks
from paddlerobotics_torch.hri.perception import darknet, reid
from paddlerobotics_torch.hri.perception.backbones import MobileNetV2, ResNet
from paddlerobotics_torch.hri.perception.reid import MarsSmall128
from paddlerobotics_torch.hri.perception.scene import (DarknetSceneSensor,
                                                       SceneSensor)
from paddlerobotics_torch.hri.perception.utterance import (BoWEncoder,
                                                           ErnieConfig,
                                                           ErnieEncoder,
                                                           UtteranceEncoder)
from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                              ServiceConfig)
from paddlerobotics_torch.hri.r2plus1d import R2Plus1D18
from paddlerobotics_torch.hri.r2plus1d_train import R2Plus1DTrainer
from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                      synthetic_batch)
from paddlerobotics_torch.sim import sbatch
from paddlerobotics_torch.train.bc_train import BCTrainer
from paddlerobotics_torch.train.dynamics_id import DynamicsIdentifier
from paddlerobotics_torch.train.etg_rl import ETGRLTrainer
from paddlerobotics_torch.train.pretrain import ETGPretrainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
_OUTDIR = os.path.join(tempfile.gettempdir(), "torch_isolation_trainer")

_PROBE = """
import importlib, pkgutil, sys
import paddlerobotics_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "paddlerobotics_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    # a subprocess: tests/conftest.py has imported jax into this process
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 106, out.stdout
    assert bad == "[]", out.stdout


_MODULE_PROBE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "paddlerobotics_tpu"))
print(bad)
"""


@pytest.mark.parametrize("module", ["paddlerobotics_torch.cli.env_bench",
                                    "paddlerobotics_torch.graft_entry",
                                    "paddlerobotics_torch.utils.profiler"])
def test_bench_entry_and_profiler_import_no_jax(module):
    out = subprocess.run([sys.executable, "-c", _MODULE_PROBE, module],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_env_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedQuadrupedEnv(QuadrupedConfig(), 8)
    env = BatchedQuadrupedEnv(QuadrupedConfig(), 8, device="cpu")
    assert env.device.type == "cpu"


def _robot_fields() -> dict:
    rb = sbatch.init_robot(2, 0.3, device="cpu")
    c = rb.contact
    out = {f: getattr(rb.s, f).numpy()
           for f in ("pos", "quat", "w", "v", "q", "qd")}
    out.update(last_action=rb.last_action.numpy(), tau=rb.tau.numpy(),
               foot_pos=c.foot_pos.numpy(),
               foot_contact=c.foot_contact.numpy(),
               knee_contact=c.knee_contact.numpy(),
               base_contact=c.base_contact.numpy(),
               obs_hist=rb.obs_hist.numpy(), hist_head=rb.hist_head)
    return out


def _dyn_fields() -> dict:
    p = sbatch.BDynParams.default(2, device="cpu")
    return {f: getattr(p, f).numpy() for f in sbatch.BDynParams._fields}


_SMALL_CTRL = AttnCtrlConfig(num_actions=3, model_dim=8, num_decoder_blocks=1,
                             num_heads=2, ffn_dim=8, act_tr_dim=4)
_BUNDLE = os.path.join(tempfile.gettempdir(), "torch_isolation_bundle")


def _bundle(**kw):
    export.save_bundle(_BUNDLE, _SMALL_CTRL, AttentionController(
        _SMALL_CTRL, device="cpu").state_dict())
    return export.load_bundle(_BUNDLE, **kw).ctrl


_TINY_CFG = """
[net]
width=16

[convolutional]
filters=14
size=1
pad=1

[yolo]
mask=0,1
anchors=10,13, 16,30
classes=2
"""


def _handler_frame(make, **kw):
    """The frame a transport-free handler hands its decision function."""
    seen = []
    handle = make(lambda *a: seen.append(a) or {"ok": True}, device=kw.get(
        "device"))
    frame = np.zeros((416, 416, 3), np.float32).tobytes()
    if make is gt.greeting_handler:
        handle(pb.VideoRequest(cur_frame=frame).encode())
        return seen[0][0]
    handle(pb.EvalRequest(nframe=1, frames=frame).encode())
    return seen[0][0][0]


class _Closed:
    """What a test needs of a served object once it is closed: its device."""

    def __init__(self, obj):
        self.device = obj.device
        obj.close()


def _udp_client(**kw):
    server = udp_bridge.A1EmulatorServer(device="cpu")
    try:
        return _Closed(udp_bridge.A1UdpClient(server.addr, timeout=60.0,
                                              **kw))
    finally:
        server.close()


_TINY_R2P1D = dict(blocks=((8, (1, 1, 1)),), stem_kernel=3)
_TINY_ERNIE = ErnieConfig(vocab_size=10, hidden_size=8, num_layers=1,
                          num_heads=2, ffn_size=8, max_len=8)


_ENTRY_POINTS = {
    "Actor": lambda **kw: Actor(49, 12, 8, **kw),
    "actor_from_flax": lambda **kw: convert.actor_from_flax(
        {"Dense_0": {"kernel": torch.zeros(49, 8), "bias": torch.zeros(8)},
         "Dense_1": {"kernel": torch.zeros(8, 8), "bias": torch.zeros(8)},
         "Dense_2": {"kernel": torch.zeros(8, 12), "bias": torch.zeros(12)},
         "Dense_3": {"kernel": torch.zeros(8, 12), "bias": torch.zeros(12)}},
        **kw),
    "AttentionController": lambda **kw: AttentionController(_SMALL_CTRL, **kw),
    "SceneSensor": lambda **kw: SceneSensor(input_size=32, **kw),
    "ProactiveGreetingService": lambda **kw: ProactiveGreetingService(
        ServiceConfig(), None, AttentionController(_SMALL_CTRL, device="cpu"),
        **kw),
    "opt_with_points": lambda **kw: fit.opt_with_points(
        QuadrupedConfig().etg, **kw)[0],
    "dyn_from_numpy": lambda **kw: convert.dyn_from_numpy(
        _dyn_fields(), **kw).motor_kp,
    "robot_from_numpy": lambda **kw: convert.robot_from_numpy(
        _robot_fields(), **kw).s.q,
    "SAC": lambda **kw: SAC(49, 12, **kw),
    "replay.create": lambda **kw: replay.create(16, 49, 12, **kw),
    "ETGRLTrainer": lambda **kw: ETGRLTrainer(
        QuadrupedConfig(), num_envs=8, outdir=_OUTDIR, **kw),
    **{f"es.{name}.init": (lambda cls: lambda **kw: cls(12, popsize=4).init(
        **kw).sigma)(cls) for name, cls in es.SOLVERS.items()},
    "batched_opt_with_points": lambda **kw: fit.batched_opt_with_points(
        QuadrupedConfig().etg, torch.zeros(2, 6, 2), torch.zeros(3, 20),
        torch.zeros(3), **kw)[0],
    "ETGPretrainer": lambda **kw: ETGPretrainer(
        QuadrupedConfig(es=ESConfig(popsize=4)), num_envs=8, outdir=_OUTDIR,
        **kw),
    "BC": lambda **kw: BC(46, 12, hidden=8, **kw),
    "replay.bc_create": lambda **kw: replay.bc_create(16, 46, 49, **kw),
    "BCTrainer": lambda **kw: BCTrainer(
        QuadrupedConfig(), SAC(49, 12, device="cpu").init(None), num_envs=8,
        outdir=_OUTDIR, **kw),
    "DynamicsIdentifier": lambda **kw: DynamicsIdentifier(
        QuadrupedConfig(), np.zeros((5, 12)), np.zeros((5, 12)),
        np.zeros((5, 3)), popsize=4, outdir=_OUTDIR, **kw),
    # the loop's device is its env's
    "SimRobotIO": lambda **kw: realtime.SimRobotIO(
        BatchedQuadrupedEnv(QuadrupedConfig(), 1, **kw)).env,
    "export_policy_fn": lambda **kw: policy_export.export_policy_fn(
        Actor(49, 12, 8, device="cpu"), np.zeros((4, 12)), np.ones(12),
        **kw),
    "estimator_init": lambda **kw: estimator.estimator_init(**kw).estimate,
    "bezier.init_state": lambda **kw: bezier.init_state(**kw).time,
    "bezier.stepper_init": lambda **kw: bezier.stepper_init(
        **kw).step_length,
    "AttentionTrainer": lambda **kw: AttentionTrainer(_SMALL_CTRL, **kw),
    "synthetic_batch": lambda **kw: synthetic_batch(
        _SMALL_CTRL, np.random.RandomState(0), 1, **kw)["visual_tokens"],
    "generate_windows_device": lambda **kw: synthetic_scene.
    generate_windows_device(None, 2, _SMALL_CTRL, **kw)["visual_tokens"],
    "device_prototypes": lambda **kw: synthetic_scene.device_prototypes(
        _SMALL_CTRL, **kw)["person"],
    "load_bundle": _bundle,
    "SceneSensor_yolov3": lambda **kw: SceneSensor(input_size=32,
                                                   arch="yolov3", **kw),
    "DarknetSceneSensor": lambda **kw: DarknetSceneSensor(
        darknet.parse_cfg(_TINY_CFG), **kw),
    "MarsSmall128": lambda **kw: MarsSmall128(**kw),
    "init_tracker": lambda **kw: tracker.init_tracker(**kw).mean,
    "greeting_handler": lambda **kw: _handler_frame(gt.greeting_handler,
                                                    **kw),
    "eval_handler": lambda **kw: _handler_frame(gt.eval_handler, **kw),
    "ServiceCallbacks": lambda **kw: ServiceCallbacks(
        None, AttentionController(_SMALL_CTRL, device="cpu"), **kw),
    "serving_bench.build_models": lambda **kw: serving_bench.build_models(
        3, **kw)[1],
    "A1EmulatorServer": lambda **kw: _Closed(udp_bridge.A1EmulatorServer(
        **kw)),
    "A1UdpClient": _udp_client,
    "R2Plus1D18": lambda **kw: R2Plus1D18(3, **_TINY_R2P1D, **kw),
    "R2Plus1DTrainer": lambda **kw: R2Plus1DTrainer(3, **_TINY_R2P1D, **kw),
    "MobileNetV2": lambda **kw: MobileNetV2(width=0.35, **kw),
    "ResNet": lambda **kw: ResNet(depths=(1, 1, 1, 1), **kw),
    "import_tf_consts": lambda **kw: reid.import_tf_consts(dict(
        reid.export_tf_consts(MarsSmall128(
            device="cpu", generator=torch.Generator()))), **kw),
    "make_env": lambda **kw: make_env("Quadrupedal", **kw),
    "QuadrupedEnv": lambda **kw: QuadrupedEnv(QuadrupedConfig(), **kw),
    "UtteranceEncoder": lambda **kw: UtteranceEncoder(cfg=_TINY_ERNIE, **kw),
    "ErnieEncoder": lambda **kw: ErnieEncoder(_TINY_ERNIE, **kw),
    "BoWEncoder": lambda **kw: BoWEncoder(10, 8, **kw),
    "DiscreteController": lambda **kw: DiscreteController(8, 3, (4,), **kw),
    "SalutationClsTree": lambda **kw: SalutationClsTree(8, **kw),
    # PrefetchLoader's tokenize
    "WindowTokenizer": lambda **kw: hri_data.WindowTokenizer(None, **kw),
    # the example observation
    "graft_entry.entry": lambda **kw: graft_entry.entry(2, **kw)[1][2],
    # the bench's last observation
    "env_bench.bench_env": lambda **kw: env_bench.bench_env(
        "no_dr", 2, 1, 1, **kw)["final"][1],
}


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_entry_point_without_device_needs_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    make = _ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    obj = make(device="cpu")
    dev = (next(obj.parameters()).device if isinstance(obj, torch.nn.Module)
           else obj.device)
    assert dev.type == "cpu"


def _cli_argvs(tmp: pathlib.Path) -> dict:
    for name, shape in (("gait", (5, 12)), ("q", (5, 12)), ("gyro", (5, 3))):
        np.save(tmp / f"{name}.npy", np.zeros(shape, np.float32))
    (tmp / "acts.tsv").write_text("wave\tsmile\thi\tnull\n")
    return {
        "pretrain_etg": (pretrain_etg.main, [
            "--popsize", "4", "--num_envs", "8", "--generations", "1",
            "--outdir", str(tmp), "--save_path", str(tmp / "e.npz")]),
        "eval_matrix": (eval_matrix.main, ["--root", str(tmp)]),
        "bc_train": (bc_train.main, ["--expert_dir", str(tmp), "--outdir",
                                     str(tmp)]),
        "dynamics_id": (dynamics_id.main, [
            "--gait", str(tmp / "gait.npy"), "--real_q", str(tmp / "q.npy"),
            "--real_gyro", str(tmp / "gyro.npy"), "--outdir", str(tmp)]),
        "export_gait": (export_gait.main, ["--save", "0"]),
        # the JAX bench's flag is accepted; the bench needs the card
        "train_bench": (train_bench.main, ["--use_pallas", "1"]),
        "train_attention": (train_attention.main, [
            "--synthetic", "1", "--epochs", "1", "--outdir", str(tmp)]),
        "parallel_train_attn": (parallel_train_attn.main, [
            "--synthetic", "1", "--epochs", "1", "--outdir", str(tmp)]),
        "serve_grpc": (serve_grpc.main, ["--smoke", "--steps", "1"]),
        "collect_data": (collect_data.main, ["-d", str(tmp)]),
        "serving_bench": (serving_bench.main, ["--frames", "1"]),
        "env_bench": (env_bench.main, ["--num_envs", "2", "--steps", "1",
                                       "--reps", "1", "--regime", "both"]),
        "robot_exercise": (robot_exercise.main, ["--steps", "1"]),
        "robot_exercise_udp": (robot_exercise.main, ["--udp", "emulator"]),
        **{f"collect_act_emb_{enc}": (collect_act_emb.main, [
            "--catalog", str(tmp / "acts.tsv"), "--out", str(tmp / "w.npy"),
            "--encoder", enc]) for enc in ("bow", "ernie")},
    }


@pytest.mark.parametrize("name", ["pretrain_etg", "eval_matrix", "bc_train",
                                  "dynamics_id", "export_gait",
                                  "train_bench", "train_attention",
                                  "parallel_train_attn", "serve_grpc",
                                  "collect_data", "serving_bench",
                                  "env_bench",
                                  "robot_exercise", "robot_exercise_udp",
                                  "collect_act_emb_bow",
                                  "collect_act_emb_ernie"])
def test_cli_without_device_needs_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    main, argv = _cli_argvs(tmp_path)[name]
    with pytest.raises((RuntimeError, SystemExit), match="no CUDA device"):
        main(argv)


def test_train_bench_refuses_the_plain_physics():
    with pytest.raises(SystemExit, match="use_pallas 0"):
        train_bench.main(["--use_pallas", "0"])


_PARALLEL_PROBE = """
import sys
sys.path.insert(0, "tests")
import paddlerobotics_torch.parallel.dryrun
import paddlerobotics_torch.parallel.launch
import paddlerobotics_torch.parallel.sharding
import torch_dist_workers
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "paddlerobotics_tpu"))
print(bad)
"""


def test_parallel_and_its_rank_programs_import_no_jax():
    # the ranks re-import these modules in fresh processes
    out = subprocess.run([sys.executable, "-c", _PARALLEL_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.fixture
def cpu_mesh(tmp_path):
    """A 1×1 mesh over a one-rank gloo group in this process."""
    import torch.distributed as dist

    from paddlerobotics_torch.parallel import sharding

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield sharding.make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["ETGRLTrainer", "AttentionTrainer"])
def test_mesh_entry_point_needs_a_card(name, cpu_mesh):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    make = {"ETGRLTrainer": lambda **kw: ETGRLTrainer(
        QuadrupedConfig(), num_envs=8, outdir=_OUTDIR, **kw),
        "AttentionTrainer": lambda **kw: AttentionTrainer(_SMALL_CTRL,
                                                          **kw)}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(mesh=cpu_mesh)
    obj = make(mesh=cpu_mesh, device="cpu")
    assert obj.device.type == "cpu" and obj.mesh is cpu_mesh


@pytest.mark.parametrize("name", ["dryrun_multichip", "spawn"])
def test_parallel_entry_point_needs_a_card(name, cpu_mesh):
    """The mesh sweep and the rank launcher run on the cards (NCCL) unless
    asked for the CPU: inside a gloo group the sweep without ``device``
    raises instead of training on the CPU, and ``spawn`` starts no gloo
    ranks by default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from paddlerobotics_torch.parallel import dryrun, launch

    call = {"dryrun_multichip": dryrun.dryrun_multichip,
            "spawn": lambda: launch.spawn(print, 2)}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert launch.backend_for("cpu") == "gloo"


@pytest.mark.parametrize("argv", [["--mesh", "2x1"], ["--mesh", "1"],
                                  ["--distributed", "1"]])
def test_mesh_cli_needs_the_cards_and_does_not_fall_back(argv, tmp_path):
    """A mesh on the card needs as many cards as ranks: without them the
    CLIs raise (no gloo, no CPU, no run without a mesh)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from paddlerobotics_torch.cli import train_quadruped
    from paddlerobotics_torch.parallel import launch

    main = train_attention.main if argv[0] == "--distributed" else \
        train_quadruped.main
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv + ["--outdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(print, 2, device="cuda")
