"""Deployable inference bundle for the HRI serving stack, in a format of
the port's own (the JAX package's ``hri/export.py`` stores flax msgpack,
which cannot be read without flax).

The bundle is a directory:

    manifest.json     "format": "paddlerobotics_torch.hri.bundle.v1",
                      ctrl_cfg (every AttnCtrlConfig field), scene (the
                      scene sensor's arch and geometry; for a Darknet
                      sensor its cfg sections, feature-map layer and the
                      meta {"cfg", "weights"} it was built from), extra
                      (thresholds), has_scene_params, has_wae
    ctrl_state.pt     the attention controller's state dict
    scene_state.pt    the scene sensor's state dict (optional): YOLOv4,
                      YOLOv3 or a Darknet cfg network
    wae.npy           the multimodal action embedding table (optional)

``load_bundle`` builds the controller (and the scene sensor) on the card
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
    scene: Optional[object]         # a hri.perception.scene sensor
    wae: Optional[np.ndarray]


def save_bundle(path: str, ctrl_cfg: AttnCtrlConfig,
                ctrl_state: dict, scene=None,
                wae: Optional[np.ndarray] = None,
                extra: Optional[dict] = None,
                scene_meta: Optional[dict] = None) -> None:
    """Write a bundle: ``ctrl_state`` is the controller's state dict;
    ``scene`` a ``SceneSensor`` or ``DarknetSceneSensor`` whose weights and
    geometry are kept; ``scene_meta`` what a Darknet sensor was built from
    (``{"cfg": path, "weights": path}``)."""
    os.makedirs(path, exist_ok=True)
    scene_m = {}
    if scene is not None:
        scene_m = {"num_classes": scene.num_classes,
                   "input_size": scene.input_size, "arch": scene.arch}
        if scene.arch == "darknet":
            scene_m.update(sections=scene.sections, fm_layer=scene.fm_layer,
                           meta=scene_meta or {})
    manifest = {
        "format": FORMAT,
        "ctrl_cfg": dataclasses.asdict(ctrl_cfg),
        "scene": scene_m,
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
        from paddlerobotics_torch.hri.perception.scene import (
            DarknetSceneSensor, SceneSensor)

        s = manifest["scene"]
        if s["arch"] == "darknet":
            sections = tuple((t, tuple(tuple(kv) for kv in opts))
                             for t, opts in s["sections"])
            scene = DarknetSceneSensor(sections, s["input_size"],
                                       s["fm_layer"], device=device)
        else:
            scene = SceneSensor(s["num_classes"], s["input_size"], s["arch"],
                                device=device)
        scene.model.load_state_dict(torch.load(
            os.path.join(path, SCENE_STATE), map_location=device,
            weights_only=True))
    wae = np.load(os.path.join(path, WAE)) if manifest["has_wae"] else None
    return Bundle(manifest, ctrl_cfg, ctrl, scene, wae)
