"""The planner's LayerNorm tails' share of HBM: the bytes one plan's tails
must move (``reference/tdmpc2_counts.norm_bytes``: each row read and
written once, each launch's parameters once), at 3.35 TB/s, over the traced
device time of the ``groupnorm_mish`` kernel's row path
(``row_norm_kernel``, found by name; in this cell only the planner launches
it) per plan (its ``plans`` counter)."""

from benchmark.kernel_trace import kernel_s_per_count
from benchmark.reference import counts, tdmpc2_counts

KERNEL = r"row_norm_kernel"


def read(run):
    s = kernel_s_per_count(run, KERNEL, "plans")
    if not s:
        return None
    n_bytes = tdmpc2_counts.norm_bytes(run.cell.config["tdmpc2"],
                                       run.result.shapes["num_envs"])
    return 100.0 * n_bytes / (counts.PEAK_BYTES_PER_S * s)
