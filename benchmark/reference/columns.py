"""The one-process layout the reference runs in: every env column, every
batch position and every replay row in this process, each layer whole.

It stands in for the port's ``parallel/sharding`` under the names the frozen
copies call; a mesh is refused."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Columns:
    """All ``total`` columns of a batch, held here."""
    off: int
    width: int
    total: int
    group: None = None

    def index(self, device) -> torch.Tensor:
        return torch.arange(self.width, device=device)

    def cut(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return x

    def part_mean(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x


def check_mesh(mesh, device) -> None:
    if mesh is not None:
        raise ValueError("the reference runs in one process, without a mesh")


def columns(mesh, total: int) -> Columns:
    check_mesh(mesh, None)
    return Columns(0, total, total)


def shard_params_tp(mesh, module: nn.Module) -> nn.Module:
    check_mesh(mesh, None)
    return module


def replicate(mesh, module: nn.Module) -> nn.Module:
    check_mesh(mesh, None)
    return module


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return layer(x)


def row_block(capacity: int, mesh) -> tuple:
    check_mesh(mesh, None)
    return 0, capacity


def env_group(mesh):
    check_mesh(mesh, None)
    return None
