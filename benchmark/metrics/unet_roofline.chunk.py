"""The Diffusion Policy U-Net's share of the FP32 peak: one call's FLOPs,
counted from the configuration's widths (``reference/diffusion_counts``),
at the peak, over the traced device time of the kernels launched inside the
program's ``policy.diffusion.unet`` spans per call (its ``unet_calls``
counter)."""

from benchmark.program_trace import device_s_per_count
from benchmark.reference import counts, diffusion_counts


def read(run):
    s = device_s_per_count(run, "policy.diffusion.unet", "unet_calls")
    if not s:
        return None
    flops = diffusion_counts.unet_flops(run.cell.config["diffusion"],
                                        run.result.shapes["num_envs"])
    return 100.0 * flops / (counts.PEAK_FP32_FLOPS * s)
