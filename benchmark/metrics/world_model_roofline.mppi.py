"""The world model's share of the FP32 peak in the planner's value
estimates: one estimate's FLOPs, counted from the configuration's widths
(``reference/tdmpc2_counts``: every sample's reward and dynamics steps,
the policy and all Q heads), at the peak, over the traced device time of
the kernels launched inside the program's ``policy.tdmpc2.value`` spans per
estimate (its ``value_rollouts`` counter)."""

from benchmark.program_trace import device_s_per_count
from benchmark.reference import counts, tdmpc2_counts


def read(run):
    s = device_s_per_count(run, "policy.tdmpc2.value", "value_rollouts")
    if not s:
        return None
    flops = tdmpc2_counts.value_flops(run.cell.config["tdmpc2"],
                                      run.result.shapes["num_envs"])
    return 100.0 * flops / (counts.PEAK_FP32_FLOPS * s)
