"""The whole control step's share of the FP32 peak: a plan's FLOPs
(``reference/tdmpc2_counts``) and one step's physics operations at the
batch, over the host-clock time per control step (the timed window over
its control steps)."""

from benchmark.readers import mfu_pct
from benchmark.reference import counts, tdmpc2_counts


def read(run):
    B = run.result.shapes["num_envs"]
    return mfu_pct(run, tdmpc2_counts.plan_flops(run.cell.config["tdmpc2"], B)
                   + counts.physics_ops_per_env(run.cfg) * B)
