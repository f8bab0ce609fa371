"""Attention-controller training (port of the JAX package's
``hri/train_attention.py``).

One train step is the controller's forward on the plain attention (the
attention kernel has no backward, in either package), ``controller_loss``,
a backward pass and ``torch.optim.Adam(lr, weight_decay=l2)``. Torch's Adam
adds ``l2·p`` to the gradient before its moments, which is what the JAX
package's ``optax.chain(add_decayed_weights(l2), adam(lr))`` computes, with
the same eps (1e-8). Training is deterministic, as the JAX step is.

``eval_step`` scores a batch through the hand-written attention kernel
(``ops/attention.flash_attention``) under ``torch.no_grad()``, as the
service's calls do: on the card the CUDA kernel, on the CPU its plain
version.

The state is updated in place, unlike JAX's functional carry:
``train_step`` returns only its losses.

On a mesh (``AttentionTrainer(mesh=)``, ``parallel/sharding``; the JAX
trainer's batch axis over "env", Fleet's all-reduce in the reference) each
env rank trains on its rows of the batch (``shard_batch``). Every term of
``controller_loss`` is a mean over the batch of per-window terms with fixed
counts (frames, tokens), so a rank's loss over its B/n rows divided by n is
its rows' part of the global loss; the gradients are all-reduced (SUM) over
env before Adam's step, and the reported losses likewise.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch
import torch.distributed as dist

from paddlerobotics_torch.core.device import resolve_device
from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                     AttnCtrlConfig,
                                                     controller_loss,
                                                     variant_token_keys)
from paddlerobotics_torch.parallel import sharding

INT_KEYS = ("frame_ids", "act_ids")


@dataclasses.dataclass
class AttnTrainState:
    """The controller, its optimiser and the count of train steps taken."""
    model: AttentionController
    opt: torch.optim.Adam
    step: int = 0


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors → tensors on ``device``: frame
    and action ids as int64, the rest as float32."""
    return {k: torch.as_tensor(
        v, device=device,
        dtype=torch.int64 if k in INT_KEYS else torch.float32)
        for k, v in batch.items()}


def synthetic_batch(cfg: AttnCtrlConfig, rng: np.random.RandomState,
                    batch_size: int, device=None) -> dict:
    """Random batch shaped for ``cfg.inputs_type`` (smoke and bench runs),
    drawn from ``rng`` in the JAX package's order, so one seed gives the
    same arrays in both packages; tensors on the card unless ``device``
    says otherwise. Its labels do not depend on its tokens."""
    device = resolve_device(device)
    B = batch_size
    T = cfg.num_frames * cfg.tokens_per_frame
    batch = {
        "frame_ids": np.tile(np.repeat(np.arange(1, cfg.num_frames + 1),
                                       cfg.tokens_per_frame), (B, 1)),
        "padding_mask": np.ones((B, T), np.float32),
        "has_act": rng.rand(B, cfg.num_frames) > 0.5,
        "act_ids": rng.randint(0, cfg.num_actions, (B, cfg.num_frames)),
        "is_obj": rng.rand(B, T) > 0.8,
    }
    if cfg.inputs_type == "visual_token":
        batch["visual_tokens"] = rng.randn(B, T, cfg.visual_token_dim)
    elif cfg.inputs_type == "inst_crop":
        batch["inst_crop_feat"] = rng.randn(B, T, 1280)
        batch["inst_cls"] = rng.randn(B, T, cfg.inst_cls_dim)
        batch["inst_pos_emb"] = rng.randn(B, T, cfg.inst_pos_dim)
    else:
        if cfg.inputs_type != "without_inst_fm":
            batch["inst_fm"] = rng.randn(B, T, 512, 5, 5)
        if cfg.inputs_type != "without_inst_cls":
            batch["inst_cls"] = rng.randn(B, T, cfg.inst_cls_dim)
        if cfg.inputs_type != "without_inst_pos":
            batch["inst_pos_emb"] = rng.randn(B, T, cfg.inst_pos_dim)
    return to_device(batch, device)


class AttentionTrainer:
    """Trains one ``AttentionController`` on the card unless ``device``
    says otherwise."""

    def __init__(self, cfg: AttnCtrlConfig, lr: float = 1e-4,
                 weight_decay: float = 0.1, mesh=None, device=None):
        """weight_decay mirrors the reference's L2 regularizer 0.1;
        ``mesh``: data parallelism over its env axis."""
        self.device = resolve_device(device)
        sharding.check_mesh(mesh, self.device)
        self.mesh = mesh
        self._group = sharding.env_group(mesh)
        self._n_env = sharding.axis_size(mesh, sharding.ENV)
        self.cfg = cfg
        self.lr = lr
        self.weight_decay = weight_decay

    def _variant_keys(self) -> tuple:
        """Token keys this ``cfg.inputs_type`` consumes."""
        return variant_token_keys(self.cfg.inputs_type)

    def _tokens(self, batch) -> dict:
        """This variant's token tensors from a batch, selected by
        ``inputs_type``, not by presence: a shared batch carrying every key
        feeds each variant only what its weights expect. A missing key
        raises."""
        missing = [k for k in self._variant_keys() if k not in batch]
        if missing:
            raise KeyError(
                f"batch lacks token keys {missing} required by "
                f"inputs_type={self.cfg.inputs_type!r}")
        return {k: batch[k] for k in self._variant_keys()}

    def dummy_tokens(self, batch_size: int = 1) -> dict:
        """Zero tokens matching ``cfg.inputs_type``."""
        cfg = self.cfg
        T = cfg.num_frames * cfg.tokens_per_frame
        shapes = {"visual_tokens": (cfg.visual_token_dim,),
                  "inst_fm": (512, 5, 5), "inst_crop_feat": (1280,),
                  "inst_cls": (cfg.inst_cls_dim,),
                  "inst_pos_emb": (cfg.inst_pos_dim,)}
        return {k: torch.zeros((batch_size, T) + shapes[k],
                               device=self.device)
                for k in self._variant_keys()}

    def new_state(self, model: AttentionController) -> AttnTrainState:
        """A state at step 0 around ``model``, with a fresh optimiser."""
        opt = torch.optim.Adam(model.parameters(), lr=self.lr, eps=1e-8,
                               weight_decay=self.weight_decay)
        return AttnTrainState(model, opt, 0)

    def init(self, generator: torch.Generator) -> AttnTrainState:
        """Flax-default weights drawn from ``generator`` (on the trainer's
        device)."""
        return self.new_state(AttentionController(
            self.cfg, device=self.device, generator=generator))

    def train_step(self, state: AttnTrainState, batch: dict) -> dict:
        """One update of ``state`` in place; returns the loss terms
        (``controller_loss``'s aux) as 0-d tensors, not read back. batch:
        the variant's tokens, frame_ids, padding_mask, has_act, act_ids,
        is_obj (B-leading tensors on the trainer's device; on a mesh this
        rank's rows, ``shard_batch``)."""
        out = state.model(self._tokens(batch), batch["frame_ids"],
                          batch["padding_mask"], use_kernel=False)
        loss, aux = controller_loss(self.cfg, out, batch["has_act"],
                                    batch["is_obj"], batch["act_ids"],
                                    batch["padding_mask"])
        state.opt.zero_grad(set_to_none=True)
        if self._group is None:
            loss.backward()
        else:
            # this rank's rows' part of the global batch mean
            (loss / self._n_env).backward()
            sharding.all_reduce_grads(state.model.parameters(), self._group)
        state.opt.step()
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        if self._group is not None:
            vals = torch.stack(list(aux.values())) / self._n_env
            dist.all_reduce(vals, group=self._group)
            aux = dict(zip(aux, vals))
        return aux

    @torch.no_grad()
    def eval_step(self, state: AttnTrainState, batch: dict) -> dict:
        """Final-frame trigger accuracy and action accuracy on triggering
        windows, through the attention kernel; 0-d tensors."""
        out = state.model(self._tokens(batch), batch["frame_ids"],
                          batch["padding_mask"], use_kernel=True)
        trigger_pred = torch.sigmoid(out["trigger_logits"])
        correct = ((trigger_pred[:, -1] > 0.5)
                   == (batch["has_act"][:, -1] > 0.5))
        act_pred = torch.argmax(out["act_logits"][:, -1], dim=-1)
        act_correct = act_pred == batch["act_ids"][:, -1]
        has = batch["has_act"][:, -1] > 0.5
        act_acc = ((act_correct & has).sum()
                   / torch.clamp(has.sum(), min=1))
        return {"trigger_acc": correct.float().mean(),
                "act_acc": act_acc.float()}

    def shard_batch(self, batch: dict) -> dict:
        """This env rank's rows of a global batch (JAX's placement over
        "env", ``hri/train_attention.py:193-201``); the batch itself without
        a mesh. The batch must divide over the env axis, as JAX's placement
        requires."""
        if self.mesh is None:
            return batch
        B = next(iter(batch.values())).shape[0]
        if B % self._n_env:
            raise ValueError(f"a batch of {B} does not divide over "
                             f"{self._n_env} env ranks")
        cols = sharding.columns(self.mesh, B)
        return {k: cols.cut(v, 0) for k, v in batch.items()}

