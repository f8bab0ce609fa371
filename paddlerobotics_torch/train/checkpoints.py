"""Checkpoints of the training state with ``torch.save``.

One file per save, ``outdir/itr_<step>.pt`` (the reference's .pt + .npz
pairs, train.py:386-390):

- ETG-RL (``save``): the SAC modules' and optimisers' state dicts,
  ``log_alpha`` with its optimiser, and the ETG ``etg_w``, ``etg_b`` and
  ``etg_param``;
- the HRI attention controller (``save_attn``): the controller's and its
  Adam's state dicts, the step counter and the controller's config.

The JAX package's Orbax checkpoints are not read here; weights come across
through ``convert.sac_from_flax`` and ``convert.attn_train_from_flax``.

On a mesh (``parallel/sharding``) a checkpoint holds the one-process layout:
every rank gathers the model shards of the SAC modules and of their Adam
moments (the learner is the same on every env rank), and rank 0 writes the
file. ``load_sac_state`` cuts a one-process dict to the rank's shards, so a
checkpoint saved on a mesh restores in one process and back onto a mesh,
and the reverse.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from paddlerobotics_torch.algos.sac import SACState
from paddlerobotics_torch.parallel import sharding

_MODULES = ("actor", "critic", "target_critic")
# each optimiser and the module whose parameters it holds (alpha's: none)
_OPTIMS = (("actor_opt", "actor"), ("critic_opt", "critic"),
           ("alpha_opt", None))


def sac_state_dict(state: SACState) -> Dict[str, Any]:
    """The SAC state's modules, optimisers and ``log_alpha`` in the
    one-process layout (model shards gathered: every rank of a mesh calls
    it)."""
    out = {k: sharding.full_state_dict(getattr(state, k)) for k in _MODULES}
    for k, m in _OPTIMS:
        opt = getattr(state, k)
        out[k] = (opt.state_dict() if m is None else
                  sharding.full_optim_state_dict(opt, getattr(state, m)))
    out["log_alpha"] = state.log_alpha.detach().clone()
    return out


def load_sac_state(state: SACState, sd: Dict[str, Any]) -> None:
    """Copy a ``sac_state_dict`` into ``state``'s modules and optimisers,
    in place (cut to the rank's model shards on a mesh)."""
    for k in _MODULES:
        m = getattr(state, k)
        m.load_state_dict(sharding.local_state_dict(m, sd[k]))
    for k, m in _OPTIMS:
        getattr(state, k).load_state_dict(
            sd[k] if m is None else
            sharding.local_optim_state_dict(getattr(state, m), sd[k]))
    with torch.no_grad():
        state.log_alpha.copy_(sd["log_alpha"])


def save(path: str, sac_state: SACState, etg_w, etg_b, etg_param,
         step: int) -> str:
    """Write ``path/itr_<step>.pt`` (on a mesh: every rank gathers, rank 0
    writes); returns its path."""
    sd = sac_state_dict(sac_state)
    target = os.path.join(os.path.abspath(path), f"itr_{step}.pt")
    if sharding.is_writer():
        os.makedirs(path, exist_ok=True)
        torch.save({"sac": sd, "etg_w": etg_w, "etg_b": etg_b,
                    "etg_param": etg_param, "step": step}, target)
    return target


def attn_state_dict(state) -> Dict[str, Any]:
    """An ``hri.train_attention.AttnTrainState`` as a dict: the
    controller's and its optimiser's state dicts and the step."""
    return {"model": state.model.state_dict(),
            "opt": state.opt.state_dict(), "step": int(state.step)}


def load_attn_state(state, sd: Dict[str, Any]) -> None:
    """Copy an ``attn_state_dict`` into ``state``, in place: weights, Adam
    moments and step counts, and the step counter."""
    state.model.load_state_dict(sd["model"])
    state.opt.load_state_dict(sd["opt"])
    state.step = int(sd["step"])


def save_attn(path: str, state) -> str:
    """Write ``path/itr_<state.step>.pt`` for an attention-controller
    trainer state; returns its path."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(os.path.abspath(path), f"itr_{state.step}.pt")
    torch.save({"attn": attn_state_dict(state),
                "ctrl_cfg": dataclasses.asdict(state.model.cfg),
                "step": int(state.step)}, target)
    return target


def restore(target: str, device=None) -> Dict[str, Any]:
    """The dict ``save`` wrote (``.pt`` may be left off ``target``), its
    tensors on ``device`` (default: where they were saved)."""
    if not target.endswith(".pt"):
        target += ".pt"
    return torch.load(target, map_location=device, weights_only=True)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("itr_"):
            try:
                steps.append(int(name[4:].split(".")[0]))
            except ValueError:
                pass
    return max(steps) if steps else None
