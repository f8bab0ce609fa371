"""Process meshes for the quadruped training stack over ``torch.distributed``
(PyTorch port of the JAX package's ``parallel/sharding.py``).

JAX's sharding only annotates placement: XLA computes the one-device function
and inserts the collectives. Here every rank runs the same program (SPMD) on
plain local tensors and calls the collectives itself, over a ``DeviceMesh``
with the dims ``("env", "model")``:

- **env axis (data parallelism).** A batch-minor env state keeps the rank's
  contiguous columns ``[off, off + w)`` of the global batch (``Columns``).
  Stepping is elementwise over the batch, so it needs no communication: each
  rank launches the physics kernel on its own columns. Every random draw of
  the env is made at the global shape and cut (``envs/batched_env``), so a
  sharded env is those columns of the one-process env. A mean over envs is
  each rank's partial sum over the global batch, all-reduced once.
- **model axis (tensor parallelism).** A ``Linear`` whose out-features divide
  keeps its dim-0 rows and its bias (torch stores ``(out, in)``, flax
  ``(in, out)``: JAX shards the kernel's last axis). Its input goes through
  ``copy_to_model`` (identity forward, all-reduce backward) and its output
  through ``gather_from_model`` (all-gather forward, the rank's slice
  backward), so the next layer and a LayerNorm see the whole vector. Every
  model rank then computes the same loss; a reduce-scatter backward
  (``torch.distributed.nn.functional.all_gather``'s) would sum that loss's
  gradient ``n_model`` times.
- **gradients.** The replay ring is split in row blocks over env
  (``algos/replay``); a sample is the global batch on every rank, and each
  env rank learns on its contiguous share of the batch positions
  (``columns``), its loss the partial sum over the global batch size;
  ``all_reduce_grads`` sums the gradients over env before each optimiser
  step, so every rank takes the one-process step.
- **ES population.** Candidates ride the env columns; a fitness is each
  rank's partial sum, all-reduced.

A leaf whose batch does not divide the env axis is replicated (JAX's
``:54-55``): every rank holds all of it, and nothing of it is reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.nn import functional as F

ENV, MODEL = "env", "model"


def make_mesh(n_env: int | None = None, n_model: int = 1,
              device_type: str | None = None):
    """A ``DeviceMesh`` over the process group's ranks with dims ``("env",
    "model")``; every rank on env by default. ``device_type`` defaults to
    ``cuda`` under NCCL and ``cpu`` under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks "
                           "with parallel/launch.py or torchrun")
    world = dist.get_world_size()
    if n_env is None:
        n_env = world // n_model
    if n_env * n_model != world:
        raise ValueError(f"mesh {n_env}x{n_model} does not cover a world of "
                         f"{world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_env, n_model),
                            mesh_dim_names=(ENV, MODEL))


def axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else mesh[name].size()


def axis_rank(mesh, name: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(name)


def check_mesh(mesh, device: torch.device) -> None:
    """Refuse a mesh whose ranks are not on ``device``'s type (a gloo mesh
    of CPU ranks for a trainer on the card, or the reverse)."""
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a mesh of {mesh.device_type} ranks for a "
                         f"{device.type} trainer")


def is_writer() -> bool:
    """True on the one process that writes metrics and checkpoints: rank 0,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


# -- collectives ---------------------------------------------------------------

def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum the gradients of ``params`` over ``group`` in place, in one
    collective; a parameter without a gradient joins with zeros."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, f in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(f)


# -- env axis ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Columns:
    """Columns ``[off, off + width)`` of a batch of ``total`` envs, held by
    this env rank. ``group`` is the env axis's process group, ``None`` when
    the columns are all of the batch in one process or replicated (then
    nothing is gathered or reduced)."""
    off: int
    width: int
    total: int
    group: Any = None

    def __deepcopy__(self, memo):
        return self

    def index(self, device) -> torch.Tensor:
        """The global column index of each local column."""
        return torch.arange(self.off, self.off + self.width, device=device)

    def cut(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's columns of a global-shaped ``x`` along ``dim``."""
        if x.shape[dim] == self.width:
            return x
        return x.narrow(dim, self.off, self.width)

    def part_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the global batch of ``x``'s elements (this rank's
        columns): ``torch.mean`` in one process, else this rank's partial sum
        over ``total`` (add the ranks' with ``reduce``)."""
        if self.group is None:
            return torch.mean(x)
        return torch.sum(x) / (x.numel() // self.width * self.total)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (a copy); ``x`` itself when
        unsharded or replicated."""
        if self.group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The global ``x`` from every rank's columns along ``dim``."""
        if self.group is None:
            return x
        return all_gather(x, self.group, dim)


def columns(mesh, total: int) -> Columns:
    """This rank's columns of a batch of ``total`` envs: contiguous blocks
    over the env axis, or all of them (replicated) when ``total`` does not
    divide. On a mesh the env group is kept even at one env rank, so a mesh
    run always takes the reducing path."""
    if mesh is None:
        return Columns(0, total, total)
    n = axis_size(mesh, ENV)
    if total % n:
        return Columns(0, total, total)
    w = total // n
    return Columns(axis_rank(mesh, ENV) * w, w, total, mesh.get_group(ENV))


def row_block(total: int, mesh) -> tuple:
    """Rows ``[lo, hi)`` of a ring of ``total`` rows held by this env rank
    (the whole ring without a mesh)."""
    n, r = axis_size(mesh, ENV), axis_rank(mesh, ENV)
    return r * total // n, (r + 1) * total // n


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dataclasses, named tuples,
    tuples, lists and dicts; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def shard_env_state(mesh, tree):
    """This rank's columns of a batch-minor env state: every tensor whose
    last axis is the batch (the last axis of the first tensor of one or more
    dims) keeps ``[off, off + width)``; the rest is kept whole. Returns
    ``(tree, off, width)``; ``(tree, 0, B)`` when B does not divide."""
    total = next(x.shape[-1] for x in tree_leaves(tree) if x.dim() >= 1)
    cols = columns(mesh, total)

    def place(x):
        if x.dim() >= 1 and x.shape[-1] == total:
            return cols.cut(x, -1).clone()
        return x

    return tree_map(place, tree), cols.off, cols.width


def replicate(mesh, tree):
    """The same values on every env rank: each tensor of ``tree`` (a tree,
    or an ``nn.Module``'s parameters and buffers) broadcast in place from the
    first env rank of its env group. Model shards stay each rank's own."""
    if mesh is None:
        return tree
    group = mesh.get_group(ENV)
    src = dist.get_global_rank(group, 0)
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, nn.Module) else tree_leaves(tree))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    return tree


def shard_replay(mesh, buf):
    """This env rank's row block of a replay buffer (``algos/replay``): the
    ring's rows ``row_block``; write pointer and fill level stay global."""
    total = buf.ring
    lo, hi = row_block(total, mesh)
    return dataclasses.replace(buf, data=buf.data[lo - buf.lo:hi - buf.lo]
                               .clone(), lo=lo, total=total,
                               group=env_group(mesh))


# -- model axis ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ColumnShard:
    """A column-parallel layer's place on the model axis: its rows are
    ``[rank·w, (rank+1)·w)`` of the full out-features ``size·w``."""
    group: Any
    size: int
    rank: int

    def __deepcopy__(self, memo):
        return self


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis backward
    (each rank's slice of a column-parallel layer sees the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the output features forward; this rank's slice of the
    gradient backward (every model rank computes the same loss)."""

    @staticmethod
    def forward(ctx, y, group, rank):
        ctx.rank, ctx.width = rank, y.shape[-1]
        return all_gather(y, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w].contiguous(), None, None


def copy_to_model(x: torch.Tensor, shard: ColumnShard) -> torch.Tensor:
    return _CopyToModel.apply(x, shard.group)


def gather_from_model(y: torch.Tensor, shard: ColumnShard) -> torch.Tensor:
    return _GatherFromModel.apply(y, shard.group, shard.rank)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``, column-parallel when ``shard_params_tp`` split the
    layer: the whole output on every model rank."""
    sh = getattr(layer, "tp", None)
    if sh is None:
        return layer(x)
    return gather_from_model(
        F.linear(copy_to_model(x, sh), layer.weight, layer.bias), sh)


def shard_params_tp(mesh, module: nn.Module) -> nn.Module:
    """Column-parallel placement over the model axis, in place: every
    ``nn.Linear`` whose out-features divide keeps its dim-0 rows of weight
    and bias and is marked ``layer.tp``; the others stay replicated. A module
    whose forward goes through ``linear`` computes the same function. Build
    optimisers after this (their parameters are replaced)."""
    n = axis_size(mesh, MODEL)
    if n == 1:
        return module
    r = axis_rank(mesh, MODEL)
    shard = ColumnShard(mesh.get_group(MODEL), n, r)
    for layer in module.modules():
        if (not isinstance(layer, nn.Linear) or layer.out_features % n
                or getattr(layer, "tp", None) is not None):
            continue
        w = layer.out_features // n
        for name in ("weight", "bias"):
            p = getattr(layer, name)
            if p is not None:
                setattr(layer, name, nn.Parameter(
                    p.detach()[r * w:(r + 1) * w].clone(),
                    requires_grad=p.requires_grad))
        layer.out_features = w
        layer.tp = shard
    return module


def _param_shards(module: nn.Module) -> list:
    """The ``ColumnShard`` (or None) of each of ``module.parameters()``."""
    of = {}
    for layer in module.modules():
        sh = getattr(layer, "tp", None)
        if sh is not None:
            for p in (layer.weight, layer.bias):
                if p is not None:
                    of[id(p)] = sh
    return [of.get(id(p)) for p in module.parameters()]


def _shard_names(module: nn.Module) -> dict:
    """``{state-dict key: ColumnShard}`` of the split layers' parameters."""
    out = {}
    for name, layer in module.named_modules():
        sh = getattr(layer, "tp", None)
        if sh is not None:
            for p in ("weight", "bias"):
                if getattr(layer, p) is not None:
                    out[f"{name}.{p}" if name else p] = sh
    return out


def _cut(x: torch.Tensor, sh: ColumnShard) -> torch.Tensor:
    w = x.shape[0] // sh.size
    return x[sh.rank * w:(sh.rank + 1) * w].clone()


def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with the model shards gathered (every model
    rank calls it): the one-process layout."""
    sd = module.state_dict()
    for key, sh in _shard_names(module).items():
        sd[key] = all_gather(sd[key], sh.group, 0)
    return sd


def local_state_dict(module: nn.Module, sd: dict) -> dict:
    """A one-process state dict cut to this rank's model shards."""
    out = dict(sd)
    for key, sh in _shard_names(module).items():
        out[key] = _cut(sd[key], sh)
    return out


def _map_optim(sd: dict, module: nn.Module, fn) -> dict:
    """``fn(tensor, shard)`` on the per-parameter state tensors of split
    layers in an optimiser state dict over ``module.parameters()``."""
    shards = _param_shards(module)
    if len(shards) != sum(len(g["params"]) for g in sd["param_groups"]):
        raise ValueError("the optimiser does not hold the module's "
                         "parameters in order")
    state = {i: {k: (fn(v, shards[i]) if shards[i] is not None
                     and torch.is_tensor(v) and v.dim() > 0 else v)
                 for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def full_optim_state_dict(opt: torch.optim.Optimizer,
                          module: nn.Module) -> dict:
    """An optimiser over ``module.parameters()`` as the one process's state
    dict: the moments of split layers gathered (every model rank calls
    it)."""
    return _map_optim(opt.state_dict(), module,
                      lambda v, sh: all_gather(v, sh.group, 0))


def local_optim_state_dict(module: nn.Module, sd: dict) -> dict:
    """A one-process optimiser state dict cut to this rank's shards (load
    it with ``opt.load_state_dict``)."""
    return _map_optim(sd, module, _cut)


def env_group(mesh) -> Optional[Any]:
    """The env axis's process group, None without a mesh."""
    return None if mesh is None else mesh.get_group(ENV)
