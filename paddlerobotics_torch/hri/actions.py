"""Multimodal action space: the id maps and the action catalog row
(port of the JAX package's ``hri/actions.py``; its flax controllers are not
ported).

A multimodal action is (action, expression, utterance[, movement]); its
embedding is concat(one-hot act, one-hot exp, ERNIE(utterance)), the
``wae`` table the attention controller dots frame hiddens against. The id
maps are the serving contract and are kept verbatim.
"""

from __future__ import annotations

import dataclasses
import numpy as np

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


def action_to_id(a, version="v1"):
    return (ACTION_TO_ID if version == "v1" else ACTION_TO_ID_V2)[a]


def expression_to_id(e, version="v1"):
    return (EXPRESSION_TO_ID if version == "v1" else EXPRESSION_TO_ID_V2)[e]


def action_set_size(version="v1"):
    return len(ACTION_TO_ID if version == "v1" else ACTION_TO_ID_V2)


def expression_set_size(version="v1"):
    return len(EXPRESSION_TO_ID if version == "v1" else EXPRESSION_TO_ID_V2)


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

