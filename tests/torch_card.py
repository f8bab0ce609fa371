"""What the port's card tests share (marked ``cuda``; JAX-free, so that
they run on the card's machine as ``python -m pytest --noconftest -m cuda
<files>``): the ``cuda`` fixture, ``plain_physics()`` and ``launched``."""

from __future__ import annotations

import contextlib

import pytest
import torch


@pytest.fixture(scope="session")
def cuda():
    """The card, with TF32 off; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run there "
                    "only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def plain_physics():
    """Route the env's physics call to the plain version
    (``sim/sbatch.control_step``) for the duration, and run every env step
    eagerly: a graph captured with the kernel would replay the kernel here,
    and one captured here would replay the plain version after."""
    from paddlerobotics_torch.envs import step_graph
    from paddlerobotics_torch.ops import physics_step
    from paddlerobotics_torch.sim import sbatch

    def plain(*a, **k):
        return sbatch.control_step(*a, **k)

    def eager(graphs, state, actions, donef, autoreset):
        return graphs.env._step(state, actions, donef, autoreset)

    plain.launches = 0                 # the kernel's count, read by callers
    kern, graphed = physics_step.control_step, step_graph.StepGraphs.step
    physics_step.control_step = plain
    step_graph.StepGraphs.step = eager
    try:
        yield
    finally:
        physics_step.control_step = kern
        step_graph.StepGraphs.step = graphed


def launched(fn):
    """(fn(), the physics kernel's launches during it)."""
    from paddlerobotics_torch.ops import physics_step

    torch.cuda.synchronize()
    physics_step.control_step.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, physics_step.control_step.launches


def ernie_catalog(n: int, seed: int) -> list:
    """``n`` catalog rows (act, exp, utterance, movement) of the v1 action
    space, utterances of 1 to 40 words (2 to 42 tokens of 64: most keys of
    most rows are padding)."""
    import numpy as np

    from paddlerobotics_torch.hri import actions

    rng = np.random.default_rng(seed)
    acts, exps = list(actions.ACTION_TO_ID), list(actions.EXPRESSION_TO_ID)
    words = ("hello", "hi", "welcome", "nice", "to", "see", "you", "good",
             "morning", "friend", "come", "here", "please", "thanks")
    return [(acts[rng.integers(len(acts))], exps[rng.integers(len(exps))],
             " ".join(rng.choice(words, rng.integers(1, 41))), "null")
            for _ in range(n)]


def ernie(dev, rows: int = 317, length: int = 64):
    """The full-width ERNIE encoder (~100 M parameters, seeded 30) and the
    token ids of ``ernie_catalog(rows, 0)`` padded to ``length``: (encoder,
    model, catalog, ids)."""
    from paddlerobotics_torch.hri.perception.utterance import (
        ErnieConfig, UtteranceEncoder)

    catalog = ernie_catalog(rows, seed=0)
    enc = UtteranceEncoder(cfg=ErnieConfig(), device=dev)
    model = enc.init(torch.Generator(dev).manual_seed(30))
    return enc, model, catalog, enc.token_ids([r[2] for r in catalog], length)
