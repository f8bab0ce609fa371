"""Start and join the ranks of a ``torch.distributed`` process group.

``spawn(fn, world, ...)`` runs ``fn(rank, *args)`` on ``world`` new
processes (``torch.multiprocessing``, the ``spawn`` start method), joined
over a ``FileStore`` in a fresh temporary directory (no fixed port), and
returns the ranks' return values in rank order. The ranks run on the cards
under NCCL, rank ``r`` on ``cuda:r``, unless ``device="cpu"`` asks for gloo
ranks on the CPU. The group is given a collective
timeout, and the join a deadline after which every rank is killed, so a
rank that deadlocks fails the call instead of hanging it.

``join_env(backend)`` joins ranks that ``torchrun`` started (its ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and ``LOCAL_RANK``).

Nothing falls back: a backend that cannot start raises.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from paddlerobotics_torch.core.device import resolve_device

COLLECTIVE_TIMEOUT_S = 600.0


def backend_for(device: str | torch.device | None) -> str:
    """NCCL for ranks on the card (``None`` means the card, and raises
    without one), gloo for CPU ranks."""
    if resolve_device(device).type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL backend")
        return "nccl"
    return "gloo"


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_env(backend: str,
             timeout_s: float = COLLECTIVE_TIMEOUT_S) -> int:
    """Join the process group ``torchrun`` describes in the environment;
    returns the local rank (the card this process runs on under NCCL)."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return local


def _rank_main(rank, fn, world, tmp, backend, timeout_s, threads, args):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (),
          device: str | torch.device | None = None,
          deadline_s: float | None = None, threads: int | None = None,
          timeout_s: float = COLLECTIVE_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` on ``world`` new ranks and return their
    return values (saved with ``torch.save``) in rank order. ``fn`` must be
    importable by name (a module-level function). The ranks run on the
    cards (NCCL) unless ``device`` is ``cpu`` (gloo). A rank that raises
    fails the call; past ``deadline_s`` every rank is killed and
    ``TimeoutError`` raised. ``threads`` sets each rank's intra-op
    threads."""
    import torch.multiprocessing as mp

    backend = backend_for(device)
    if backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} NCCL ranks need {world} cards, have "
                           f"{torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, tmp, backend, timeout_s, threads,
                              args),
            nprocs=world, join=False, start_method="spawn")
        end = None if deadline_s is None else time.monotonic() + deadline_s
        while not ctx.join(timeout=1.0):
            if end is not None and time.monotonic() > end:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not "
                                   f"finish within {deadline_s} s")
        return [torch.load(os.path.join(tmp, f"out_{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_shape(spec: str, device: str | torch.device):
    """A CLI's ``--mesh``: ``0`` (or empty, ``none``) → None; ``1`` →
    every card on the env axis (or every rank of the process group joined,
    or that ``torchrun`` started);
    ``NxM`` → N env × M model ranks. On the CPU the ranks must be given as
    ``NxM``; on the card a mesh larger than the cards (or than the process
    group joined) raises."""
    if spec in ("0", "", "none"):
        return None
    cuda = torch.device(device).type == "cuda"
    joined = (dist.get_world_size() if dist.is_initialized() else
              int(os.environ["WORLD_SIZE"]) if under_torchrun() else None)
    if "x" in spec:
        n_env, n_model = (int(v) for v in spec.split("x"))
    elif spec == "1":
        if joined is None and not cuda:
            raise SystemExit("--mesh 1 on the CPU: give the gloo ranks as "
                             "NxM")
        n_env = torch.cuda.device_count() if joined is None else joined
        n_model = 1
    else:
        raise SystemExit(f"--mesh {spec}: expected 0, 1 or NxM")
    world = n_env * n_model
    if joined is not None and world != joined:
        raise SystemExit(f"--mesh {spec} is {world} ranks; the process "
                         f"group has {joined}")
    count = torch.cuda.device_count()
    if cuda and not 0 < world <= count:
        raise SystemExit(
            f"--mesh {spec} needs {world or 'a'} card(s), have {count}"
            + (" (no CUDA device; --device cpu runs gloo ranks)"
               if count == 0 else ""))
    return n_env, n_model


def run_ranks(fn, world: int, args: tuple, device: str | torch.device,
              deadline_s: float | None = None) -> list:
    """``fn(local_rank, *args)`` on every rank of a ``world``-rank group:
    in this process when it already is a rank (a process group joined, or
    started by ``torchrun``), else on ``world`` new ranks (``spawn``). Under
    NCCL a rank runs on ``cuda:<local_rank>``. Returns what this process's
    rank returned, or every new rank's."""
    backend = backend_for(device)
    if dist.is_initialized():
        return [fn(int(os.environ.get("LOCAL_RANK", dist.get_rank())),
                   *args)]
    if under_torchrun():
        local = join_env(backend)
        try:
            return [fn(local, *args)]
        finally:
            dist.destroy_process_group()
    threads = None if backend == "nccl" else max(1, (os.cpu_count() or 1)
                                                  // world)
    return spawn(fn, world, args, device=device, deadline_s=deadline_s,
                 threads=threads)


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:<local_rank>`` on the card, else the
    CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", local_rank)
    return torch.device("cpu")
