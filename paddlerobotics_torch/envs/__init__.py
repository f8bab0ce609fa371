"""Quadruped environments: the batched env on the physics kernel and the
per-env functional env behind ``make_env``."""

from paddlerobotics_torch.envs.registry import make_env  # noqa: F401
