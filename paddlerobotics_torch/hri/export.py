"""Deployable inference bundle for the HRI serving stack, in a format of
the port's own (the JAX package's ``hri/export.py`` stores flax msgpack,
which cannot be read without flax).

The bundle is a directory:

    manifest.json     "format": "paddlerobotics_torch.hri.bundle.v1",
                      ctrl_cfg (every AttnCtrlConfig field), scene (the
                      scene sensor's geometry), extra
                      (thresholds), has_scene_params, has_wae
    ctrl_state.pt     the attention controller's state dict
    scene_state.pt    the YOLOv4 scene sensor's state dict (optional)
    wae.npy           the multimodal action embedding table (optional)

``load_bundle`` builds the controller (and the ``SceneSensor``) on the card
unless ``device`` says otherwise: everything ``hri.serving.
ProactiveGreetingService`` needs to serve. A JAX bundle's params come
across through ``convert.ctrl_from_flax`` after flax has read them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                     AttnCtrlConfig)

FORMAT = "paddlerobotics_torch.hri.bundle.v1"
MANIFEST = "manifest.json"
CTRL_STATE = "ctrl_state.pt"
SCENE_STATE = "scene_state.pt"
WAE = "wae.npy"


class Bundle(NamedTuple):
    manifest: dict
    ctrl_cfg: AttnCtrlConfig
    ctrl: AttentionController
    scene: Optional[object]         # hri.perception.scene.SceneSensor
    wae: Optional[np.ndarray]


def save_bundle(path: str, ctrl_cfg: AttnCtrlConfig,
                ctrl_state: dict, scene=None,
                wae: Optional[np.ndarray] = None,
                extra: Optional[dict] = None) -> None:
    """Write a bundle: ``ctrl_state`` is the controller's state dict;
    ``scene`` a ``SceneSensor`` whose weights and geometry are kept."""
    os.makedirs(path, exist_ok=True)
    manifest = {
        "format": FORMAT,
        "ctrl_cfg": dataclasses.asdict(ctrl_cfg),
        "scene": {} if scene is None else {
            "num_classes": scene.num_classes,
            "input_size": scene.input_size, "arch": scene.arch},
        "extra": extra or {},
        "has_scene_params": scene is not None,
        "has_wae": wae is not None,
    }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    torch.save({k: v.detach().cpu() for k, v in ctrl_state.items()},
               os.path.join(path, CTRL_STATE))
    if scene is not None:
        torch.save({k: v.detach().cpu()
                    for k, v in scene.model.state_dict().items()},
                   os.path.join(path, SCENE_STATE))
    if wae is not None:
        np.save(os.path.join(path, WAE), np.asarray(wae))


def load_bundle(path: str, device=None) -> Bundle:
    """Read a bundle and build its modules on the card unless ``device``
    says otherwise."""
    device = resolve_device(device)
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"{path}: bundle format {manifest.get('format')!r}, expected "
            f"{FORMAT!r} (a JAX bundle's params come across through "
            "convert.ctrl_from_flax)")
    ctrl_cfg = AttnCtrlConfig(**manifest["ctrl_cfg"])
    ctrl = AttentionController(ctrl_cfg, device=device)
    ctrl.load_state_dict(torch.load(os.path.join(path, CTRL_STATE),
                                    map_location=device, weights_only=True))
    ctrl.eval()
    scene = None
    if manifest["has_scene_params"]:
        from paddlerobotics_torch.hri.perception.scene import SceneSensor

        s = manifest["scene"]
        scene = SceneSensor(s["num_classes"], s["input_size"], s["arch"],
                            device=device)
        scene.model.load_state_dict(torch.load(
            os.path.join(path, SCENE_STATE), map_location=device,
            weights_only=True))
    wae = np.load(os.path.join(path, WAE)) if manifest["has_wae"] else None
    return Bundle(manifest, ctrl_cfg, ctrl, scene, wae)
