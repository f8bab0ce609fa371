"""Holding the program's env states and outputs against the reference's.

The program's state classes and the reference's frozen copies have the
same fields, so a state of one is carried into the other by field name,
and two states are compared field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from benchmark.harness import gap


def _ref_classes():
    from benchmark.reference import env as renv
    from benchmark.reference import sbatch as rs
    return {"BEnvState": renv.BEnvState, "BRobot": rs.BRobot,
            "BQuadState": rs.BQuadState, "BContact": rs.BContact,
            "BDynParams": rs.BDynParams}


def mirror(obj, classes=None):
    """The program's (nested) state as the reference's classes; tensors
    and numbers are shared, not copied."""
    classes = classes or _ref_classes()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = classes[type(obj).__name__]
        return cls(**{f.name: mirror(getattr(obj, f.name), classes)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = classes[type(obj).__name__]
        return cls(*[mirror(x, classes) for x in obj])
    return obj


def flatten(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor and number of a (nested) state by its dotted path;
    generators are left out."""
    out: Dict[str, torch.Tensor] = {}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = list(zip(obj._fields, obj))
    elif isinstance(obj, torch.Tensor):
        return {prefix: obj}
    elif isinstance(obj, (int, float, bool)):
        return {prefix: torch.tensor(float(obj))}
    else:
        return out
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def step_gaps(p_out, r_out) -> Dict[str, float]:
    """Gaps by field of an env step's (state, obs, reward, done), or of a
    reset's (state, obs); the step's info is not compared."""
    gaps = {}
    names = ("state", "obs", "reward", "done")
    for name, p, r in zip(names, p_out, r_out):
        fp, fr = flatten(p, name), flatten(r, name)
        if set(fp) != set(fr):
            raise ValueError(f"fields differ: {set(fp) ^ set(fr)}")
        for k in fp:
            gaps[k] = gap(fp[k], fr[k])
    return gaps


def generator_at(state_bytes: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state_bytes)
    return g


def reference_state(p_state, gen_bytes, device,
                    etg: Optional[tuple] = None):
    """The program's env state at a step as the reference's, with a fresh
    generator at the saved position and, where given, the reference's own
    ETG readout in place of the program's."""
    st = mirror(p_state)
    st = dataclasses.replace(st, rng=generator_at(gen_bytes, device))
    if etg is not None:
        st = dataclasses.replace(st, etg_w=etg[0], etg_b=etg[1])
    return st
