"""The tick's share of the FP32 peak: the physics' counted operations
and the actor's forward FLOPs at B=1, over the host-clock time a tick works
(from the end of its wait to its next observation on the host; the
sleep of the paced period left out)."""

from benchmark.readers import mfu_pct, rollout_flops


def read(run):
    return mfu_pct(run, rollout_flops(run))
