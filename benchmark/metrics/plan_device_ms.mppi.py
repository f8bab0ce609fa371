"""Device ms per plan: the kernels launched inside the program's
``policy.tdmpc2`` spans (the encoder, the policy trajectories, every
iteration's samples, value estimate and refit, the pick) in the traced
steps, per plan (its ``plans`` counter)."""

from benchmark.program_trace import device_s_per_count


def read(run):
    s = device_s_per_count(run, "policy.tdmpc2", "plans")
    return None if s is None else 1e3 * s
