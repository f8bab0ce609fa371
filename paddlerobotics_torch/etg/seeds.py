"""Shipped per-task ETG seed artifacts (port of the JAX package's
``etg/seeds.py``).

Small npz files (``w``, ``b``, ``param``: the cli/pretrain_etg.py artifact
layout) under ``paddlerobotics_torch/assets/etg_seeds/<task_mode>.npz``, a
copy of the JAX package's files, resolved by the training CLI when
``--ETG_path auto`` (the default). Tasks without a seed start from the
zero-offset prior. The balance-beam preset sets ``ETG_path='None'``: its
seed is kept for provenance only.
"""

from __future__ import annotations

import os

import numpy as np

SEED_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "etg_seeds")


def seed_path(task_mode: str) -> str | None:
    """Path of the shipped seed npz for `task_mode`, or None."""
    p = os.path.join(SEED_DIR, f"{task_mode}.npz")
    return p if os.path.exists(p) else None


def load_seed_param(task_mode: str) -> np.ndarray | None:
    """The 12 control-point offsets ("param") for `task_mode`, or None
    when no seed is shipped (zero-offset prior applies)."""
    p = seed_path(task_mode)
    if p is None:
        return None
    return np.load(p)["param"].reshape(-1)


def available() -> list[str]:
    if not os.path.isdir(SEED_DIR):
        return []
    return sorted(f[:-4] for f in os.listdir(SEED_DIR)
                  if f.endswith(".npz"))
