"""The training step's share of the FP32 peak: the rollout's counted
work (physics operations, the actor's sample at the batch) and K SAC
updates' matrix FLOPs at the update batch, over the host-clock time per
control step (the timed window over its steps)."""

from benchmark.readers import mfu_pct, rollout_flops
from benchmark.reference import counts


def read(run):
    sh = run.result.shapes
    learn = sh["updates_per_step"] * counts.sac_update_flops(
        sh["batch_size"], sh["obs_dim"], sh["action_dim"], sh["hidden"])
    return mfu_pct(run, rollout_flops(run) + learn)
