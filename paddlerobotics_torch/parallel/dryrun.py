"""The mesh sweep: the real trainer over every ``(env, model)`` mesh of a
world, held to the run without a mesh (the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip()`` runs on every rank of a process group. For each
factorization ``n_env × n_model`` of the world with ``n_model`` in {1, 2, 4}
it trains ``ETGRLTrainer(mesh=)`` at ``B = 2·max(n_env)`` (at least the
popsize, 4) with chunk 5: two chunks of SAC rollout and learning and one ES
generation (population rollout, ask and tell) fired after the first, envs
batch-minor over env, MLPs column-parallel over model, replay rows in
blocks over env. Each
mesh's trained actor, its model shards gathered, must equal the actor of
the same training without a mesh within ``ACTOR_TOL``.

    python -m paddlerobotics_torch.parallel.dryrun --world 2 --device cpu
    python -m paddlerobotics_torch.parallel.dryrun          # every card
"""

from __future__ import annotations

import argparse
import tempfile

import torch

# the largest actor |Δ| a mesh may show against the run without a mesh: a
# small multiple of the port's readings on gloo CPU ranks (4.7e-5 at 4×1, the
# largest; PERF.md), an eighth of the JAX dryrun's largest reading, 1.55e-3
# (MULTICHIP_r05.json), and a fifteenth of the change the two chunks make
ACTOR_TOL = 2e-4
CHUNK = 5
POPSIZE = 4


def mesh_shapes(world: int) -> list:
    """Every (n_env, n_model) with n_model in {1, 2, 4} dividing ``world``."""
    return [(world // m, m) for m in (1, 2, 4) if world % m == 0]


def train_once(mesh, B: int, device, seed: int = 0):
    """The real trainer on ``mesh`` (None: one process) at tiny fixed
    shapes: two chunks, an ES generation after the first. Returns the
    carry."""
    from paddlerobotics_torch.core.config import (ESConfig, QuadrupedConfig,
                                                  SACConfig, TrainConfig)
    from paddlerobotics_torch.train.etg_rl import ETGRLTrainer

    # es_num_envs=0: the ES population rides the main env batch, so the ES
    # phase is the same function on every mesh
    cfg = QuadrupedConfig(
        sac=SACConfig(memory_size=1024, warmup_steps=0, batch_size=32),
        es=ESConfig(popsize=POPSIZE, es_every_steps=B * CHUNK,
                    es_train_steps=1, es_episode_len=5, es_num_envs=0),
        train=TrainConfig(num_envs=B, eval_every_steps=10 ** 9, e_step=50))
    with tempfile.TemporaryDirectory(prefix="dryrun_mesh_") as outdir:
        trainer = ETGRLTrainer(cfg, num_envs=B, outdir=outdir,
                               updates_per_step=1, mesh=mesh, device=device)
        carry, _ = trainer.train(max_steps=B * CHUNK * 2, chunk_steps=CHUNK,
                                 checkpoint=False, seed=seed)
    return carry


def dryrun_multichip(device=None, tol: float = ACTOR_TOL) -> dict:
    """Sweep the meshes of the process group's world on the card (NCCL
    ranks) unless ``device`` is ``cpu`` (gloo ranks); returns ``{"NxM": max
    |Δ| of the actor against the run without a mesh}`` (every rank calls
    it, every rank checks)."""
    import torch.distributed as dist

    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.parallel import sharding

    device = resolve_device(device)
    world = dist.get_world_size()
    shapes = mesh_shapes(world)
    # two envs per env rank, and at least one per ES candidate
    B = max(2 * max(e for e, _ in shapes), POPSIZE)
    base = sharding.full_state_dict(train_once(None, B, device).sac_state
                                    .actor)
    errs = {}
    for n_env, n_model in shapes:
        mesh = sharding.make_mesh(n_env, n_model, device_type=device.type)
        carry = train_once(mesh, B, device)
        if not torch.isfinite(carry.obs).all():
            raise RuntimeError(f"mesh {n_env}x{n_model}: non-finite obs")
        actor = sharding.full_state_dict(carry.sac_state.actor)
        err = max((actor[k] - base[k]).abs().max().item() for k in base)
        errs[f"{n_env}x{n_model}"] = err
        if not err <= tol:
            raise RuntimeError(f"mesh {n_env}x{n_model}: actor |Δ| {err:.3e} "
                               f"against the run without a mesh (> {tol})")
        if sharding.is_writer():
            print(f"dryrun mesh {{'env': {n_env}, 'model': {n_model}}} OK — "
                  f"B={B}, actor matches the run without a mesh (max|Δ| "
                  f"{err:.2e})")
    return errs


def _rank(local_rank: int, device: str):
    from paddlerobotics_torch.parallel import launch

    return dryrun_multichip(launch.rank_device(device, local_rank))


def main(argv=None):
    from paddlerobotics_torch.parallel import launch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--world", type=int, default=0,
                   help="ranks (default: every card)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (NCCL ranks, one per card) or cpu (gloo)")
    args = p.parse_args(argv)
    world = args.world or torch.cuda.device_count()
    if world < 1:
        raise SystemExit("no ranks: give --world N with --device cpu, or "
                         "run on the cards")
    shape = launch.mesh_shape(f"{world}x1", args.device)
    errs = launch.run_ranks(_rank, shape[0], (args.device,), args.device)[0]
    print(f"dryrun_multichip({world}) OK — shapes {list(errs)}, full trainer "
          f"(SAC chunks + ES generation), max|Δ| {errs}")
    return errs


if __name__ == "__main__":
    main()
