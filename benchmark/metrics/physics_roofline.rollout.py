"""The physics control step's share of its roofline: the frozen bound (the
larger of its counted operations at the FP32 peak and its counted bytes at
the HBM peak) over the traced device time per launch of the kernel."""

from benchmark.readers import physics_bound_s, roofline_pct

KERNEL = r"control_step_kernel"


def read(run):
    return roofline_pct(run, KERNEL, physics_bound_s(run))
