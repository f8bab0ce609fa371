"""Device ms per replan: the kernels launched inside the program's
``policy.diffusion`` spans (the history's normalisation, every U-Net call
and scheduler update) in the traced chunks, per replan (its ``replans``
counter)."""

from benchmark.program_trace import device_s_per_count


def read(run):
    s = device_s_per_count(run, "policy.diffusion", "replans")
    return None if s is None else 1e3 * s
