"""SAC inference (PyTorch port): the deterministic policy action.

Only ``predict`` of the JAX package's ``algos/sac.py`` is ported here; the
learner comes with the trainer.
"""

from __future__ import annotations

import torch

from paddlerobotics_torch.algos.networks import Actor


def predict(actor: Actor, obs: torch.Tensor) -> torch.Tensor:
    """Deterministic action = tanh(mean) (sac.py:60-63)."""
    mean, _ = actor(obs)
    return torch.tanh(mean)
