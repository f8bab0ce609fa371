"""Carry weights and state from the JAX package's numpy arrays.

Takes plain numpy arrays (the caller does ``np.asarray`` on the JAX side)
and builds the port's modules and state types; imports nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from paddlerobotics_torch.algos.networks import Actor
from paddlerobotics_torch.sim.sbatch import (BContact, BDynParams, BQuadState,
                                             BRobot)


def actor_from_flax(params_np: Mapping, device: str | torch.device = "cpu"
                    ) -> Actor:
    """Flax actor tree (nested dicts of numpy arrays, ``Dense_0..Dense_3``
    with ``kernel`` (in, out) and ``bias``; an outer ``params`` level is
    accepted) → the port's Actor with ``weight = kernel.T``."""
    p = params_np.get("params", params_np)
    k0 = np.asarray(p["Dense_0"]["kernel"])
    k2 = np.asarray(p["Dense_2"]["kernel"])
    actor = Actor(k0.shape[0], k2.shape[1], hidden=k0.shape[1], device=device)
    with torch.no_grad():
        for i, lin in enumerate(actor.dense):
            d = p[f"Dense_{i}"]
            lin.weight.copy_(_t(np.asarray(d["kernel"]).T, device))
            lin.bias.copy_(_t(d["bias"], device))
    return actor


def _t(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype,
                           device=device)


def dyn_from_numpy(fields: Mapping, device: str | torch.device = "cpu"
                   ) -> BDynParams:
    """BDynParams from numpy arrays under the JAX field names (batch-last)."""
    return BDynParams(*[_t(fields[f], device) for f in BDynParams._fields])


def robot_from_numpy(fields: Mapping, device: str | torch.device = "cpu"
                     ) -> BRobot:
    """BRobot from numpy arrays with the JAX field names: ``pos``, ``quat``,
    ``w``, ``v``, ``q``, ``qd``, ``last_action``, ``tau``, ``foot_pos``,
    ``foot_contact``, ``knee_contact``, ``base_contact``, ``obs_hist`` and
    ``hist_head``."""
    s = BQuadState(*[_t(fields[f], device)
                     for f in ("pos", "quat", "w", "v", "q", "qd")])
    c = BContact(
        foot_pos=_t(fields["foot_pos"], device),
        foot_contact=_t(fields["foot_contact"], device, torch.bool),
        knee_contact=_t(fields["knee_contact"], device, torch.bool),
        base_contact=_t(fields["base_contact"], device, torch.bool))
    return BRobot(s=s, last_action=_t(fields["last_action"], device),
                  tau=_t(fields["tau"], device), contact=c,
                  obs_hist=_t(fields["obs_hist"], device),
                  hist_head=int(fields["hist_head"]))
