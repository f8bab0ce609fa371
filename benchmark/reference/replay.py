"""Device-resident replay buffer (PyTorch port of the JAX package's
``algos/replay.py``).

One preallocated (N, obs+act+1+obs+1) float32 tensor on the card holds the
transitions (1,000,000 × 112 floats = 448 MB at the default width), so
``sample_many`` gathers every row of K batches in one indexed read. The
write pointer and fill level are host integers: they follow from the batch
sizes alone, so no step reads them back from the card. Unlike JAX's
functional buffer, ``add_batch`` writes into the tensor and advances the
counters in place, and returns nothing.

On a mesh (``create(..., mesh=)``, ``parallel/sharding``) the global ring of
M rows is split in row blocks over the env axis (the JAX package's layout):
a rank holds rows ``[lo, hi)``, ``add_rows`` takes a step's global rows
(all-gathered by the caller) and writes the part of ``[ptr, ptr + B) mod M``
that falls in its block, and a sample draws global indices from the shared
generator, gathers the rows its block holds (zeros elsewhere) and sums the
ranks' parts in one all-reduce over env: every rank gets the one-process
batch exactly (each row is one rank's, added to zeros), and the learner
takes its share of the positions (``SAC.learn``).

The BC buffer (``bc_create`` / ``bc_add_batch`` / ``bc_sample``) pairs the
student's and the expert's view of each collected state
(BCreplay_buffer.py:21-78) in the same way: one (N, student+expert)
tensor on the card, host ``ptr`` and ``size``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from benchmark.reference.device import resolve_device
from benchmark.reference import columns as sharding

FIELDS = ("obs", "act", "rew", "next_obs", "terminal")


class _Ring:
    """A ring of rows whose block ``[lo, lo + len(data))`` this process
    holds; ``ptr`` and ``size`` count the whole ring; ``group`` is the env
    axis whose ranks hold the other blocks."""
    lo: int
    total: int
    group: Any

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def ring(self) -> int:
        """The global ring's rows (``capacity`` when this process holds
        all of them)."""
        return self.total or self.capacity

    @property
    def blocked(self) -> bool:
        """True when the ring is split in row blocks over a mesh."""
        return self.total > 0


@dataclasses.dataclass
class ReplayBuffer(_Ring):
    data: torch.Tensor      # (N, obs | act | rew | next_obs | terminal)
    obs_dim: int
    act_dim: int
    ptr: int                # next write slot of the global ring
    size: int               # valid rows of the global ring
    lo: int = 0             # first global row held here
    total: int = 0          # global rows on a mesh (0: all held here)
    group: Any = None       # the env axis on a mesh

    @property
    def device(self) -> torch.device:
        return self.data.device

    def split(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Rows (…, width) → views obs, act, rew (…,1), next_obs,
        terminal (…,1)."""
        o, a = self.obs_dim, self.act_dim
        cuts = (o, a, 1, o, 1)
        return dict(zip(FIELDS, torch.split(rows, cuts, dim=-1)))

    def fields(self) -> Dict[str, torch.Tensor]:
        """Views of every row: obs (N,o), act, rew (N,1), next_obs,
        terminal (N,1)."""
        return self.split(self.data)


def create(capacity: int, obs_dim: int, act_dim: int,
           device: str | torch.device | None = None,
           mesh=None) -> ReplayBuffer:
    """An empty buffer on the card unless ``device`` says otherwise; on a
    ``mesh``, this env rank's row block of a ring of ``capacity`` rows."""
    lo, hi = sharding.row_block(capacity, mesh)
    data = torch.zeros((hi - lo, 2 * obs_dim + act_dim + 2),
                       device=resolve_device(device))
    return ReplayBuffer(data, obs_dim, act_dim, 0, 0, lo,
                        capacity if mesh is not None else 0,
                        sharding.env_group(mesh))


def rows(obs, act, rew, next_obs, terminal) -> torch.Tensor:
    """B transitions as (B, width) rows; ``rew`` and ``terminal`` may be
    (B,) or (B, 1)."""
    B = obs.shape[0]
    return torch.cat([obs, act, rew.reshape(B, 1), next_obs,
                      terminal.reshape(B, 1)], dim=1)


def add_batch(buf: ReplayBuffer, obs, act, rew, next_obs, terminal) -> None:
    """Append B transitions at ``(ptr + arange(B)) % N`` (ring semantics),
    in place (``add_rows`` of ``rows``)."""
    add_rows(buf, rows(obs, act, rew, next_obs, terminal))


def add_rows(buf, rows: torch.Tensor) -> None:
    """Write a step's global ``rows`` at ``(ptr + arange(B)) % N``, the part
    that falls in this process's block, and advance the global counters. The
    positions follow from the host counters alone: at most two contiguous
    runs, each copied as a slice."""
    N, B = buf.ring, rows.shape[0]
    ptr = buf.ptr
    if B > N:                     # only the last N rows survive the wrap
        rows, ptr = rows[B - N:], (ptr + B - N) % N
    lo, hi = buf.lo, buf.lo + buf.capacity
    first = min(rows.shape[0], N - ptr)
    for start, src in ((ptr, rows[:first]), (0, rows[first:])):
        a, b = max(start, lo), min(start + src.shape[0], hi)
        if a < b:
            buf.data[a - lo:b - lo] = src[a - start:b - start]
    buf.ptr, buf.size = (buf.ptr + B) % N, min(buf.size + B, N)


def _indices(buf, n, idx, generator):
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (n,), generator=generator,
                            device=buf.device)
    return idx.to(buf.device)


def _take(buf, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rows at global ``idx``; on a blocked ring each rank gathers the
    rows of its block, zeros elsewhere, and one all-reduce adds them up."""
    if not buf.blocked:
        return buf.split(buf.data[idx])
    local = idx - buf.lo
    own = (local >= 0) & (local < buf.capacity)
    got = torch.where(own[..., None],
                      buf.data[local.clamp(0, buf.capacity - 1)], 0.0)
    dist.all_reduce(got, group=buf.group)
    return buf.split(got)


def sample(buf: ReplayBuffer, batch_size: int,
           generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Uniform batch over the valid rows ``[0, max(size, 1))``; ``idx``
    replaces the draw."""
    return _take(buf, _indices(buf, batch_size, idx, generator))


def sample_many(buf: ReplayBuffer, k: int, batch_size: int,
                generator: Optional[torch.Generator] = None,
                idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """K independent uniform batches in one gather of k·batch_size rows,
    leading axis k (distribution-identical to k ``sample`` calls: the
    buffer does not change between the K updates of a control step);
    ``idx`` (k·batch_size,) replaces the draw."""
    idx = _indices(buf, k * batch_size, idx, generator)
    return _take(buf, idx.reshape(k, batch_size))


# -- BC buffer ---------------------------------------------------------------

@dataclasses.dataclass
class BCReplayBuffer(_Ring):
    """Paired (student obs, expert obs) rows (BCreplay_buffer.py:21-78)."""
    data: torch.Tensor      # (N, obs | ref_obs)
    obs_dim: int
    ref_obs_dim: int
    ptr: int
    size: int
    lo: int = 0
    total: int = 0
    group: Any = None

    @property
    def device(self) -> torch.device:
        return self.data.device

    def split(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Rows (…, width) → views obs (…, obs_dim), ref_obs."""
        obs, ref = torch.split(rows, (self.obs_dim, self.ref_obs_dim), dim=-1)
        return {"obs": obs, "ref_obs": ref}


def bc_create(capacity: int, obs_dim: int, ref_obs_dim: int,
              device: str | torch.device | None = None) -> BCReplayBuffer:
    """An empty BC buffer on the card unless ``device`` says otherwise."""
    data = torch.zeros((capacity, obs_dim + ref_obs_dim),
                       device=resolve_device(device))
    return BCReplayBuffer(data, obs_dim, ref_obs_dim, 0, 0)


def bc_add_batch(buf: BCReplayBuffer, obs, ref_obs) -> None:
    """Append B pairs at ``(ptr + arange(B)) % N``, in place."""
    add_rows(buf, torch.cat([obs, ref_obs], dim=1))


def bc_sample(buf: BCReplayBuffer, batch_size: int,
              generator: Optional[torch.Generator] = None,
              idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Uniform batch over ``[0, max(size, 1))`` in one gather; ``idx``
    (batch_size,) replaces the draw."""
    return _take(buf, _indices(buf, batch_size, idx, generator))
