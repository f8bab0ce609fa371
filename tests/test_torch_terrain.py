"""Port parity: terrain height fields and the physics on non-flat terrain.

``height_fn`` of every task mode against the JAX package's on a grid that
includes negative cells (the int32 hash of ``obstacle`` wraps and shifts
arithmetically; it must agree bit for bit), then one or two plain control
steps on stairs, obstacles, the balance beam and the slope pair with envs
spread over the course, held to the tolerances of test_torch_physics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerobotics_tpu.core.config import TaskConfig as JTaskConfig
from paddlerobotics_tpu.sim import sbatch as jsb
from paddlerobotics_tpu.sim import terrain as jterrain

from paddlerobotics_torch.core.config import TaskConfig
from paddlerobotics_torch.sim import terrain

from torch_parity import assert_match, run_both, target


def _grid():
    x, y = np.meshgrid(np.linspace(-3.3, 9.7, 131), np.linspace(-2.6, 2.4, 53))
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("mode", terrain.TASK_MODES)
def test_height_fn_matches_jax(mode):
    assert mode in jterrain.TASK_MODES
    task = dict(task_mode=mode, step_height=0.09, step_width=0.32,
                slope=0.3, terrain_start=0.4)
    x, y = _grid()
    h_j = np.asarray(jterrain.height_fn(JTaskConfig(**task))(
        jnp.asarray(x), jnp.asarray(y)))
    h_fn = terrain.height_fn(TaskConfig(**task))
    h_t = h_fn(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert h_t.dtype == np.float32
    if mode == "obstacle":
        np.testing.assert_array_equal(h_t, h_j)
        assert (h_t > 0).any() and (h_t == 0).any()
    else:
        np.testing.assert_allclose(h_t, h_j, atol=1e-6)
    assert h_fn.mode_id == terrain.MODE_IDS[mode]
    assert len(h_fn.params) == len(terrain.PARAM_NAMES)


def test_hash01_wraps_like_int32():
    ix, iy = np.meshgrid(np.arange(-70, 70, dtype=np.int32),
                         np.arange(-9, 11, dtype=np.int32))
    ix = np.concatenate([ix.ravel(), [2**31 - 1, -2**31]]).astype(np.int32)
    iy = np.concatenate([iy.ravel(), [-2**31, 2**31 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(
        terrain._hash01(torch.as_tensor(ix), torch.as_tensor(iy)).numpy(),
        np.asarray(jterrain._hash01(jnp.asarray(ix), jnp.asarray(iy))))


@pytest.mark.parametrize("mode,steps", [("up_stair", 1), ("obstacle", 2),
                                        ("balance_beam", 2),
                                        ("slopeslope", 1)])
def test_terrain_control_step_matches_jax(mode, steps):
    B = 8
    task = dict(task_mode=mode, terrain_start=0.0)
    h = jterrain.height_fn(JTaskConfig(**task))
    x = jnp.linspace(-0.2, 2.6, B)
    y = jnp.linspace(-0.25, 0.25, B)
    rb = jsb.init_robot(B, height=0.30)
    pos = jnp.stack([x, y, 0.30 + h(x, y)])
    rb = rb.replace(s=rb.s.replace(pos=pos))
    rb_j, rb_t = run_both(rb, jsb.BDynParams.default(B), target(B, 0.05),
                          task_kw=task, steps=steps)
    assert_match(rb_j, rb_t)
