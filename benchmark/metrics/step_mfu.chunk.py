"""The whole control step's share of the FP32 peak: a replan's U-Net FLOPs
(``reference/diffusion_counts``) over the Ta control steps it serves, and
one step's physics operations at the batch, over the host-clock time per
control step (the timed window over its control steps)."""

from benchmark.readers import mfu_pct
from benchmark.reference import counts, diffusion_counts


def read(run):
    sh = run.result.shapes
    B = sh["num_envs"]
    plan = diffusion_counts.replan_flops(run.cell.config["diffusion"], B)
    return mfu_pct(run, plan / sh["n_action_steps"] +
                   counts.physics_ops_per_env(run.cfg) * B)
