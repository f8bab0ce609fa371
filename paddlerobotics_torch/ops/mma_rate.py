"""The card's mma.sync rates: the ceiling of the attention kernel's products.

The attention kernel (``ops/csrc/attention.cu``) multiplies with
``mma.sync.m16n8k8`` TF32, three passes per product. The data sheet's 495
TFLOP/s of dense TF32 is the rate of Hopper's ``wgmma``; this measures what
``mma.sync`` reaches on the card at hand (``ops/csrc/mma_rate.cu``): a full
grid of warps issuing independent products on registers, TF32 m16n8k8 and,
as a yardstick, f16 m16n8k16; and one warp per SM sub-partition issuing
dependent products, whose time per product is the latency a warp waits when
it issues a product on the accumulator it just wrote.

    python3 -m paddlerobotics_torch.ops.mma_rate

prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mma_rate.cu"
ITERS = 4096


def measure() -> dict:
    from paddlerobotics_torch.ops import build as kbuild

    lib, _ = kbuild.build_library("mma_rate", SOURCE)
    fn = lib.prt_mma_rate
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(128, device="cuda")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    out = {}
    for name, tf32, acc, blocks, flop in (
            ("tf32_m16n8k8", 1, 8, 8 * n_sm, 2 * 16 * 8 * 8),
            ("f16_m16n8k16", 0, 8, 8 * n_sm, 2 * 16 * 8 * 16),
            ("tf32_m16n8k8_dependent", 1, 1, n_sm, 2 * 16 * 8 * 8)):
        ms = ctypes.c_float()
        err = fn(tf32, acc, blocks, 128, ITERS, sink.data_ptr(),
                 ctypes.byref(ms))
        if err:
            raise RuntimeError(f"mma_rate launch failed: error {err}")
        n_mma = blocks * 4 * ITERS * acc
        out[name] = {
            "tflop_s": n_mma * flop / (ms.value * 1e-3) / 1e12,
            # cycles per mma on one of the 4 sub-partitions of an SM, at
            # the card's top SM clock
            "cycles_per_mma_per_subpartition":
                ms.value * 1e-3 * clock_mhz * 1e6 / (n_mma / (4 * n_sm)),
        }
    out["clock_max_sm_mhz"] = clock_mhz
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: no CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      **measure()}))
