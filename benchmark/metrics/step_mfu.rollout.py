"""The whole step's share of the FP32 peak: the physics' counted
operations and the actor's forward FLOPs at the batch, over the
host-clock time per control step (the timed window over its steps)."""

from benchmark.readers import mfu_pct, rollout_flops


def read(run):
    return mfu_pct(run, rollout_flops(run))
