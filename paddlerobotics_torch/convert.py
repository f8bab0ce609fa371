"""Carry weights and state from the JAX package's numpy arrays.

Takes plain numpy arrays (the caller does ``np.asarray`` on the JAX side)
and builds the port's modules and state types; imports nothing of JAX.
Modules whose submodules carry flax's scope names (the HRI controller,
YOLOv4 and YOLOv3, the Darknet network, the re-ID encoder, MobileNetV2 and
ResNet) load a flax variable tree by path with ``load_flax``; R(2+1)D keeps
torchvision's names and maps flax's scopes onto them
(``r2plus1d.flax_names``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from paddlerobotics_torch.algos.bc import BC, BCState
from paddlerobotics_torch.algos.networks import Actor, Critic
from paddlerobotics_torch.algos.sac import SAC, SACState
from paddlerobotics_torch.core.config import SACConfig
from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.actions import (DiscreteController,
                                              SalutationClsTree)
from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                     AttnCtrlConfig)
from paddlerobotics_torch.hri.perception.backbones import MobileNetV2, ResNet
from paddlerobotics_torch.hri.perception.reid import MarsSmall128
from paddlerobotics_torch.hri.perception.scene import (DarknetSceneSensor,
                                                       SceneSensor)
from paddlerobotics_torch.hri.perception.utterance import (BoWEncoder,
                                                           ErnieConfig,
                                                           ErnieEncoder)
from paddlerobotics_torch.hri.r2plus1d import (R2PLUS1D18_BLOCKS, R2Plus1D18,
                                               flax_names)
from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                      AttnTrainState)
from paddlerobotics_torch.sim.sbatch import (BContact, BDynParams, BQuadState,
                                             BRobot)


def actor_from_flax(params_np: Mapping,
                    device: str | torch.device | None = None) -> Actor:
    """Flax actor tree (nested dicts of numpy arrays, ``Dense_0..Dense_3``
    with ``kernel`` (in, out) and ``bias``; an outer ``params`` level is
    accepted) → the port's Actor with ``weight = kernel.T``, on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
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


def dyn_from_numpy(fields: Mapping,
                   device: str | torch.device | None = None) -> BDynParams:
    """BDynParams from numpy arrays under the JAX field names (batch-last),
    on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return BDynParams(*[_t(fields[f], device) for f in BDynParams._fields])


def robot_from_numpy(fields: Mapping,
                     device: str | torch.device | None = None) -> BRobot:
    """BRobot from numpy arrays with the JAX field names: ``pos``, ``quat``,
    ``w``, ``v``, ``q``, ``qd``, ``last_action``, ``tau``, ``foot_pos``,
    ``foot_contact``, ``knee_contact``, ``base_contact``, ``obs_hist`` and
    ``hist_head``; on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
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


def _flatten(tree: Mapping, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def load_flax(module: torch.nn.Module, variables: Mapping) -> None:
    """Copy a flax variable tree (``params`` and ``batch_stats``, numpy
    arrays) into ``module``, whose submodule paths are the flax scopes.

    Dense kernels (in, out) become ``weight`` (out, in); Conv kernels
    (spatial…, in, out) become (out, in, spatial…), HWIO → OIHW; ``scale``
    and Embed ``embedding`` → ``weight``; BatchNorm ``mean`` / ``var`` → ``running_mean`` /
    ``running_var``; any other leaf is a raw parameter
    of the same name. Every parameter and running statistic of ``module``
    must be set exactly once, with matching shapes."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {})
    targets = dict(module.named_parameters())
    targets.update((n, b) for n, b in module.named_buffers()
                   if n.rsplit(".", 1)[-1] in ("running_mean", "running_var"))
    leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "mean": "running_mean", "var": "running_var",
                 "embedding": "weight"}
    done = set()
    items = list(_flatten(params).items()) + list(_flatten(stats).items())
    with torch.no_grad():
        for path, arr in items:
            arr = np.asarray(arr, np.float32)
            leaf = path[-1]
            if leaf == "kernel":
                nd = arr.ndim
                arr = arr.transpose(nd - 1, nd - 2, *range(nd - 2))
            name = ".".join(path[:-1] + (leaf_name.get(leaf, leaf),))
            if name not in targets or name in done:
                raise KeyError(f"flax variable {'/'.join(path)} has no "
                               f"unset counterpart {name}")
            t = targets[name]
            if tuple(t.shape) != arr.shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, flax "
                                 f"{arr.shape}")
            t.copy_(torch.as_tensor(np.ascontiguousarray(arr)))
            done.add(name)
    missing = sorted(set(targets) - done)
    if missing:
        raise KeyError(f"not set from the flax tree: {missing[:5]}")


def ctrl_from_flax(params_np: Mapping, cfg: AttnCtrlConfig,
                   device: str | torch.device | None = None
                   ) -> AttentionController:
    """Flax ``AttentionController`` variables → the port's controller, on
    the card unless ``device`` says otherwise."""
    ctrl = AttentionController(cfg, device=device)
    load_flax(ctrl, params_np)
    return ctrl


def attn_train_from_flax(state_np, cfg: AttnCtrlConfig, lr: float = 1e-4,
                         weight_decay: float = 0.1,
                         device: str | torch.device | None = None
                         ) -> AttnTrainState:
    """A JAX ``AttnTrainState`` as numpy arrays (``jax.tree.map(np.asarray,
    s)``) → the port's trainer state, on the card unless ``device`` says
    otherwise: the controller's params, the Adam moments of the optax chain
    ``(add_decayed_weights: EmptyState, (ScaleByAdamState(count, mu, nu),
    EmptyState()))`` as torch Adam's ``exp_avg`` / ``exp_avg_sq`` / ``step``
    (kernels transposed), and the step counter."""
    trainer = AttentionTrainer(cfg, lr, weight_decay, device=device)
    state = trainer.new_state(ctrl_from_flax(state_np.params, cfg,
                                             device=trainer.device))
    _adam_state(state.opt, flax_leaves(state.model), state_np.opt_state[1][0])
    state.step = int(np.asarray(state_np.step))
    return state


def scene_from_flax(variables_np: Mapping, num_classes: int = 80,
                    input_size: int = 416, arch: str = "yolov4",
                    device: str | torch.device | None = None) -> SceneSensor:
    """Flax YOLOv4 or YOLOv3 variables (``params`` and ``batch_stats``) →
    the port's ``SceneSensor``, on the card unless ``device`` says
    otherwise."""
    scene = SceneSensor(num_classes, input_size, arch, device=device)
    load_flax(scene.model, variables_np)
    return scene


def darknet_from_flax(variables_np: Mapping, sections,
                      input_size: int | None = None,
                      fm_layer: int | None = None,
                      device: str | torch.device | None = None
                      ) -> DarknetSceneSensor:
    """Flax ``DarknetNet`` variables (``conv{i}`` / ``bn{i}``) → the port's
    ``DarknetSceneSensor``, on the card unless ``device`` says otherwise."""
    scene = DarknetSceneSensor(sections, input_size, fm_layer, device=device)
    load_flax(scene.model, variables_np)
    return scene


def reid_from_flax(variables_np: Mapping,
                   device: str | torch.device | None = None) -> MarsSmall128:
    """Flax ``MarsSmall128`` variables (``params`` and ``batch_stats``) →
    the port's encoder, on the card unless ``device`` says otherwise; its
    ``state_dict()`` is what ``cli.collect_data --encoder_params`` reads."""
    reid = MarsSmall128(device=device)
    load_flax(reid, variables_np)
    return reid


def mobilenet_from_flax(variables_np: Mapping, width: float = 1.0,
                        device: str | torch.device | None = None
                        ) -> MobileNetV2:
    """Flax ``MobileNetV2`` variables → the port's module, on the card
    unless ``device`` says otherwise."""
    net = MobileNetV2(width, device=device)
    load_flax(net, variables_np)
    return net


def resnet_from_flax(variables_np: Mapping, depths=(3, 4, 6, 3),
                     device: str | torch.device | None = None) -> ResNet:
    """Flax ``ResNet`` variables → the port's module, on the card unless
    ``device`` says otherwise."""
    net = ResNet(depths, device=device)
    load_flax(net, variables_np)
    return net


def r2plus1d_from_flax(variables_np: Mapping, num_classes: int,
                       blocks=R2PLUS1D18_BLOCKS, stem_kernel: int = 7,
                       device: str | torch.device | None = None
                       ) -> R2Plus1D18:
    """Flax ``R2Plus1D18`` variables (``params`` and ``batch_stats``) → the
    port's model under torchvision's names, on the card unless ``device``
    says otherwise; Conv3d kernels (t, h, w, in, out) become (out, in, t,
    h, w)."""
    model = R2Plus1D18(num_classes, blocks, stem_kernel, device=device)
    names = flax_names(blocks)

    def rename(tree):
        out: dict = {}
        for path, leaf in _flatten(tree).items():
            node = out
            for k in names["/".join(path[:-1])].split("."):
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out

    load_flax(model, {"params": rename(variables_np["params"]),
                      "batch_stats": rename(variables_np["batch_stats"])})
    return model


def critic_from_flax(params_np: Mapping, obs_dim: int, layer_norm: bool = False,
                     device: str | torch.device | None = None) -> Critic:
    """Flax twin-Q ``Critic`` params (``Dense_0..Dense_5``, ``LN_0..LN_3``
    with ``layer_norm``) → the port's Critic, on the card unless
    ``device`` says otherwise."""
    p = params_np.get("params", params_np)
    k0 = np.asarray(p["Dense_0"]["kernel"])
    critic = Critic(obs_dim, k0.shape[0] - obs_dim, hidden=k0.shape[1],
                    layer_norm=layer_norm, device=device)
    _load_leaves(critic, params_np)
    return critic


def flax_leaves(module: torch.nn.Module):
    """(parameter, flax path, transposed) for every parameter of
    ``module``, in ``module.parameters()`` order (the order of its
    optimiser's state). Linear ``weight`` ↔ ``kernel`` (transposed), 1×1
    Conv2d ``weight`` ↔ ``kernel`` (transposed: OIHW reversed is HWIO when
    H = W = 1), LayerNorm ``weight`` ↔ ``scale``, a parameter of
    ``module`` itself ↔ the leaf of its name; the Actor's ``dense.i`` ↔
    ``Dense_i``."""
    kinds = dict(module.named_modules())
    out = []
    for name, prm in module.named_parameters():
        mod, _, leaf = name.rpartition(".")
        kind = kinds[mod]
        if isinstance(kind, torch.nn.Conv2d) and kind.kernel_size != (1, 1):
            raise ValueError(f"{name}: only 1×1 convolutions map by transpose")
        kernel = leaf == "weight" and isinstance(
            kind, (torch.nn.Linear, torch.nn.Conv2d))
        if leaf == "weight":
            leaf = "kernel" if kernel else "scale"
        path = (tuple(mod.replace("dense.", "Dense_").split("."))
                if mod else ()) + (leaf,)
        out.append((prm, path, kernel))
    return out


def _leaf(tree: Mapping, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _adam_state(opt: torch.optim.Adam, leaves, adam) -> None:
    """Load optax ``ScaleByAdamState(count, mu, nu)`` into a torch Adam
    over the parameters of ``leaves`` (``flax_leaves`` order; an empty
    path for a bare array such as log_alpha)."""
    def moment(tree, path, transposed):
        a = _leaf(tree.get("params", tree), path) if path else \
            np.asarray(tree, np.float32)
        return a.T if transposed else a

    state = {}
    for i, (prm, path, transposed) in enumerate(leaves):
        state[i] = {"step": torch.tensor(float(np.asarray(adam.count)),
                                         dtype=torch.float32),
                    "exp_avg": _t(moment(adam.mu, path, transposed),
                                  prm.device),
                    "exp_avg_sq": _t(moment(adam.nu, path, transposed),
                                     prm.device)}
    opt.load_state_dict({"state": state,
                         "param_groups": opt.state_dict()["param_groups"]})


def _load_leaves(module: torch.nn.Module, params_np: Mapping) -> None:
    p = params_np.get("params", params_np)
    with torch.no_grad():
        for prm, path, transposed in flax_leaves(module):
            a = _leaf(p, path)
            prm.copy_(_t(a.T if transposed else a, prm.device))


def sac_from_flax(state_np, obs_dim: int, action_dim: int,
                  cfg: SACConfig = SACConfig(),
                  device: str | torch.device | None = None) -> SACState:
    """A JAX ``SACState`` as numpy arrays (``jax.tree.map(np.asarray, s)``)
    → the port's SAC state, on the card unless ``device`` says otherwise.

    Takes the actor, critic and target params, ``log_alpha``, and the three
    optax Adam states as optax builds them, ``(ScaleByAdamState(count, mu,
    nu), EmptyState())``: μ and ν become torch Adam's ``exp_avg`` and
    ``exp_avg_sq`` (Dense kernels transposed), count its ``step``."""
    state = SAC(obs_dim, action_dim, cfg, device=device).init(None)
    _load_leaves(state.actor, state_np.actor_params)
    _load_leaves(state.critic, state_np.critic_params)
    _load_leaves(state.target_critic, state_np.target_critic_params)
    with torch.no_grad():
        state.log_alpha.copy_(_t(state_np.log_alpha, state.log_alpha.device))
    _adam_state(state.actor_opt, flax_leaves(state.actor),
                state_np.actor_opt[0])
    _adam_state(state.critic_opt, flax_leaves(state.critic),
                state_np.critic_opt[0])
    _adam_state(state.alpha_opt, [(state.log_alpha, (), False)],
                state_np.alpha_opt[0])
    return state


def bc_from_flax(state_np, obs_dim: int, action_dim: int,
                 hidden: int = 256, actor_lr: float = 3e-4,
                 critic_lr: float = 3e-4,
                 device: str | torch.device | None = None) -> BCState:
    """A JAX ``BCState`` as numpy arrays (``jax.tree.map(np.asarray, s)``)
    → the port's BC state, on the card unless ``device`` says otherwise:
    the student's actor and critic params and both optax Adam states, as
    ``sac_from_flax`` carries them."""
    state = BC(obs_dim, action_dim, actor_lr, critic_lr, hidden,
               device=device).init(None)
    _load_leaves(state.actor, state_np.actor_params)
    _load_leaves(state.critic, state_np.critic_params)
    _adam_state(state.actor_opt, flax_leaves(state.actor),
                state_np.actor_opt[0])
    _adam_state(state.critic_opt, flax_leaves(state.critic),
                state_np.critic_opt[0])
    return state


def ernie_from_flax(variables_np: Mapping, cfg: ErnieConfig,
                    device: str | torch.device | None = None
                    ) -> ErnieEncoder:
    """Flax ``ErnieEncoder`` variables → the port's encoder, on the card
    unless ``device`` says otherwise. The attention's ``DenseGeneral``
    kernels, q/k/v (H, heads, hd) and out (heads, hd, H), become (H, H)
    Dense kernels and their (heads, hd) biases (H,), as
    ``import_ernie_params`` reshapes the Paddle weights."""
    H = cfg.hidden_size
    params = {k: dict(v) for k, v in
              variables_np.get("params", variables_np).items()}
    for i in range(cfg.num_layers):
        attn = params[f"attn_{i}"]
        params[f"attn_{i}"] = {
            proj: {"kernel": np.asarray(attn[proj]["kernel"]).reshape(H, H),
                   "bias": np.asarray(attn[proj]["bias"]).reshape(H)}
            for proj in ("query", "key", "value", "out")}
    model = ErnieEncoder(cfg, device=device)
    load_flax(model, {"params": params})
    return model


def bow_from_flax(params_np: Mapping, device: str | torch.device | None = None
                  ) -> BoWEncoder:
    """Flax ``BoWEncoder`` params (``Embed_0``) → the port's encoder, on the
    card unless ``device`` says otherwise."""
    emb = np.asarray(params_np.get("params", params_np)["Embed_0"]["embedding"])
    model = BoWEncoder(emb.shape[0], emb.shape[1], device=device)
    load_flax(model, params_np)
    return model


def discrete_ctrl_from_flax(params_np: Mapping,
                            device: str | torch.device | None = None
                            ) -> DiscreteController:
    """Flax ``DiscreteController`` params (``Dense_0..``) → the port's
    module, on the card unless ``device`` says otherwise."""
    p = params_np.get("params", params_np)
    ks = [np.asarray(p[f"Dense_{i}"]["kernel"]) for i in range(len(p))]
    model = DiscreteController(ks[0].shape[0], ks[-1].shape[1],
                               tuple(k.shape[1] for k in ks[:-1]),
                               device=device)
    load_flax(model, params_np)
    return model


def salutation_from_flax(params_np: Mapping, fm_hw: tuple = (5, 5),
                         device: str | torch.device | None = None
                         ) -> SalutationClsTree:
    """Flax ``SalutationClsTree`` params (``Conv_0``, ``Dense_0..``) → the
    port's module for (…, *fm_hw, C) feature maps, on the card unless
    ``device`` says otherwise."""
    p = params_np.get("params", params_np)
    conv = np.asarray(p["Conv_0"]["kernel"])               # (1, 1, C, R)
    n_dense = sum(k.startswith("Dense_") for k in p)
    hidden = tuple(np.asarray(p[f"Dense_{i}"]["kernel"]).shape[1]
                   for i in range(n_dense - 1))
    model = SalutationClsTree(conv.shape[2], fm_hw, hidden, conv.shape[3],
                              device=device)
    load_flax(model, params_np)
    return model
