"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points refuse to run quietly on the CPU."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from paddlerobotics_torch.core.config import QuadrupedConfig
from paddlerobotics_torch.envs.batched_env import BatchedQuadrupedEnv

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
    assert int(n) >= 25, out.stdout
    assert bad == "[]", out.stdout


def test_env_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedQuadrupedEnv(QuadrupedConfig(), 8)
    env = BatchedQuadrupedEnv(QuadrupedConfig(), 8, device="cpu")
    assert env.device.type == "cpu"
