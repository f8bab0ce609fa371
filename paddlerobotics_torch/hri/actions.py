"""Multimodal action space: id maps, discrete controllers and the action
embedding table (port of the JAX package's ``hri/actions.py``).

A multimodal action is (action, expression, utterance[, movement]); its
embedding is concat(one-hot act, one-hot exp, ERNIE(utterance)), the
``wae`` table the attention controller dots frame hiddens against. The id
maps are the serving contract and are kept verbatim. ``DiscreteController``
and ``SalutationClsTree`` carry flax's scope names (``Dense_i``,
``Conv_0``), so ``convert.load_flax`` carries weights across by path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.utils.init import flax_default_

ACTION_TO_ID = {
    "null": 0, "shake_hand": 1, "raise_hand": 2, "raise_left_hand": 3,
    "hug": 4, "give_me_five": 5, "twist_head": 6, "turn_head_to_left": 7,
    "turn_head_to_right": 8, "wave": 9, "altman": 10, "superman": 11,
}
ACTION_TO_ID_V2 = {
    "null": 0, "shake_hand": 1, "hug": 2, "wave": 3, "altman": 4,
    "superman": 5,
}
EXPRESSION_TO_ID = {
    "null": 0, "smile": 1, "embarrassed": 2, "shy": 3, "anthomaniac": 4,
    "nervous": 5, "shocked": 6, "cry": 7, "sleepy": 8, "blushed": 9,
    "depressed": 10, "thinking": 11, "blink": 12, "concentrated": 13,
    "collapse": 14, "despise": 15, "angry": 16, "watch": 17, "cool": 18,
    "desperate": 19, "snigger": 20, "sharp": 21, "think_of": 22,
    "proud": 23, "panic": 24, "sweat": 25, "fighting": 26, "confused": 27,
    "dizzy": 28, "bah": 29,
}
EXPRESSION_TO_ID_V2 = {"null": 0, "shuangzhayan": 1, "xinxin": 2, "shy": 3}
MOVEMENT_TO_ID = {
    "null": 0, "move_ahead": 1, "move_backward": 2, "move_left": 3,
    "move_right": 4, "turn_left": 5, "turn_right": 6,
}


def _invert(d):
    return {v: k for k, v in d.items()}


def action_to_id(a, version="v1"):
    return (ACTION_TO_ID if version == "v1" else ACTION_TO_ID_V2)[a]


def id_to_action(i, version="v1"):
    return _invert(ACTION_TO_ID if version == "v1" else ACTION_TO_ID_V2)[i]


def expression_to_id(e, version="v1"):
    return (EXPRESSION_TO_ID if version == "v1" else EXPRESSION_TO_ID_V2)[e]


def id_to_expression(i, version="v1"):
    return _invert(EXPRESSION_TO_ID if version == "v1"
                   else EXPRESSION_TO_ID_V2)[i]


def movement_to_id(m):
    return MOVEMENT_TO_ID[m]


def id_to_movement(i):
    return _invert(MOVEMENT_TO_ID)[i]


def action_set_size(version="v1"):
    return len(ACTION_TO_ID if version == "v1" else ACTION_TO_ID_V2)


def expression_set_size(version="v1"):
    return len(EXPRESSION_TO_ID if version == "v1" else EXPRESSION_TO_ID_V2)


def movement_set_size():
    return len(MOVEMENT_TO_ID)


@dataclasses.dataclass
class MultimodalAction:
    """One row of the action catalog (jetson/multimodal_act.hpp)."""

    act: str = "null"
    exp: str = "null"
    utterance: str = ""
    movement: str = "null"

    def one_hot(self, version="v1") -> np.ndarray:
        a = np.zeros(action_set_size(version))
        e = np.zeros(expression_set_size(version))
        a[action_to_id(self.act, version)] = 1.0
        e[expression_to_id(self.exp, version)] = 1.0
        return np.concatenate([a, e])



def build_action_embeddings(actions: List[MultimodalAction],
                            utterance_embs: np.ndarray,
                            version: str = "v1") -> np.ndarray:
    """(A, act_n + exp_n + 768) embedding table = the reference's
    raw_wae.npy (collect_act_emb.py:42-54)."""
    rows = [np.concatenate([a.one_hot(version), u])
            for a, u in zip(actions, utterance_embs)]
    return np.asarray(rows, np.float32)


class DiscreteController(nn.Module):
    """fc stack → logits over a discrete id space
    (interaction/common/discrete_ctrl.py semantics): ``Dense_i`` with relu
    between. On the card unless ``device`` says otherwise; ``generator``
    draws flax-default weights."""

    def __init__(self, in_dim: int, num_outputs: int,
                 hidden_dims: tuple = (256,), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dims = (in_dim, *hidden_dims, num_outputs)
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f"Dense_{i}", nn.Linear(dims[i], dims[i + 1],
                                                  device=device))
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        h = feat
        for i in range(self.n - 1):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n - 1}")(h)


class SalutationClsTree(nn.Module):
    """Salutation head over an instance feature map: 6 classes arranged as
    a (gender → age) tree (interaction/salutation_cls.py:4-60): [man,
    young_boy, uncle, woman, young_girl, aunt].

    Takes the feature map as flax does, NHWC (..., h, w, C). The 1×1
    ``Conv_0`` is a product over channels, flattened in (h, w, c) order as
    flax flattens its NHWC output, then ``Dense_0..`` with relu, 6 logits.
    """

    def __init__(self, in_channels: int, fm_hw: tuple = (5, 5),
                 hidden_dims: tuple = (512, 256), reduce_dim: int = 128,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv_0 = nn.Conv2d(in_channels, reduce_dim, 1, device=device)
        dims = (fm_hw[0] * fm_hw[1] * reduce_dim, *hidden_dims, 6)
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f"Dense_{i}", nn.Linear(dims[i], dims[i + 1],
                                                  device=device))
        if generator is not None:
            flax_default_(self, generator)

    def forward(self, fm: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        h = torch.relu(F.linear(fm, conv.weight.flatten(1), conv.bias))
        h = h.reshape(h.shape[:-3] + (-1,))
        for i in range(self.n - 1):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n - 1}")(h)


SALUTATIONS = ("man", "young_boy", "uncle", "woman", "young_girl", "aunt")
