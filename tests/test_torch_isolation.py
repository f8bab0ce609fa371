"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points refuse to run quietly on the CPU."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from paddlerobotics_torch import convert
from paddlerobotics_torch.algos.networks import Actor
from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv
from paddlerobotics_torch.etg import fit
from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                     AttnCtrlConfig)
from paddlerobotics_torch.hri.perception.scene import SceneSensor
from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                              ServiceConfig)

ROOT = pathlib.Path(__file__).resolve().parents[1]

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
    assert int(n) >= 44, out.stdout
    assert bad == "[]", out.stdout


def test_env_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedQuadrupedEnv(QuadrupedConfig(), 8)
    env = BatchedQuadrupedEnv(QuadrupedConfig(), 8, device="cpu")
    assert env.device.type == "cpu"


_SMALL_CTRL = AttnCtrlConfig(num_actions=3, model_dim=8, num_decoder_blocks=1,
                             num_heads=2, ffn_dim=8, act_tr_dim=4)
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
