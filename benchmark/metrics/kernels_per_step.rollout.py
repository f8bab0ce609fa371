"""Device kernels per control step in the traced window."""

from benchmark.readers import kernels_per_step


def read(run):
    return kernels_per_step(run)
