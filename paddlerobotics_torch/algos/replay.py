"""Device-resident replay buffer (PyTorch port of the JAX package's
``algos/replay.py``).

One preallocated (N, obs+act+1+obs+1) float32 tensor on the card holds the
transitions (1,000,000 × 112 floats = 448 MB at the default width), so
``sample_many`` gathers every row of K batches in one indexed read. The
write pointer and fill level are host integers: they follow from the batch
sizes alone, so no step reads them back from the card. Unlike JAX's
functional buffer, ``add_batch`` writes into the tensor and advances the
counters in place, and returns nothing.

The BC buffer (``bc_create`` / ``bc_add_batch`` / ``bc_sample``) pairs the
student's and the expert's view of each collected state
(BCreplay_buffer.py:21-78) in the same way: one (N, student+expert)
tensor on the card, host ``ptr`` and ``size``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from paddlerobotics_torch.core.device import resolve_device

FIELDS = ("obs", "act", "rew", "next_obs", "terminal")


@dataclasses.dataclass
class ReplayBuffer:
    data: torch.Tensor      # (N, obs | act | rew | next_obs | terminal)
    obs_dim: int
    act_dim: int
    ptr: int                # next write slot
    size: int               # valid rows

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

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
           device: str | torch.device | None = None) -> ReplayBuffer:
    """An empty buffer on the card unless ``device`` says otherwise."""
    data = torch.zeros((capacity, 2 * obs_dim + act_dim + 2),
                       device=resolve_device(device))
    return ReplayBuffer(data, obs_dim, act_dim, 0, 0)


def add_batch(buf: ReplayBuffer, obs, act, rew, next_obs, terminal) -> None:
    """Append B transitions at ``(ptr + arange(B)) % N`` (ring semantics),
    in place; ``rew`` and ``terminal`` may be (B,) or (B, 1)."""
    B = obs.shape[0]
    _ring_write(buf, torch.cat([obs, act, rew.reshape(B, 1), next_obs,
                                terminal.reshape(B, 1)], dim=1))


def _ring_write(buf, rows: torch.Tensor) -> None:
    """Write ``rows`` at ``(ptr + arange(B)) % N`` and advance the host
    counters."""
    N, B = buf.capacity, rows.shape[0]
    if buf.ptr + B <= N:
        buf.data[buf.ptr:buf.ptr + B] = rows
    else:
        idx = (buf.ptr + torch.arange(B, device=buf.device)) % N
        buf.data.index_copy_(0, idx, rows)
    buf.ptr, buf.size = (buf.ptr + B) % N, min(buf.size + B, N)


def _indices(buf, n, idx, generator):
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (n,), generator=generator,
                            device=buf.device)
    return idx.to(buf.device)


def sample(buf: ReplayBuffer, batch_size: int,
           generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Uniform batch over the valid rows ``[0, max(size, 1))``; ``idx``
    replaces the draw."""
    return buf.split(buf.data[_indices(buf, batch_size, idx, generator)])


def sample_many(buf: ReplayBuffer, k: int, batch_size: int,
                generator: Optional[torch.Generator] = None,
                idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """K independent uniform batches in one gather of k·batch_size rows,
    leading axis k (distribution-identical to k ``sample`` calls: the
    buffer does not change between the K updates of a control step);
    ``idx`` (k·batch_size,) replaces the draw."""
    rows = buf.data[_indices(buf, k * batch_size, idx, generator)]
    return buf.split(rows.reshape(k, batch_size, -1))


# -- BC buffer ---------------------------------------------------------------

@dataclasses.dataclass
class BCReplayBuffer:
    """Paired (student obs, expert obs) rows (BCreplay_buffer.py:21-78)."""
    data: torch.Tensor      # (N, obs | ref_obs)
    obs_dim: int
    ref_obs_dim: int
    ptr: int
    size: int

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

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
    _ring_write(buf, torch.cat([obs, ref_obs], dim=1))


def bc_sample(buf: BCReplayBuffer, batch_size: int,
              generator: Optional[torch.Generator] = None,
              idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Uniform batch over ``[0, max(size, 1))`` in one gather; ``idx``
    (batch_size,) replaces the draw."""
    return buf.split(buf.data[_indices(buf, batch_size, idx, generator)])
