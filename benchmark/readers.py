"""What the per-layer readers in ``metrics/`` share. A reader that finds
nothing to read returns None, and the run leaves its metric out."""

from __future__ import annotations

import re
import statistics

from benchmark.reference import counts


def span_mean_ms(run, name: str):
    """Host ms per call of the span ``name``, over every call in the timed
    window."""
    ms = run.result.spans.get(name)
    return statistics.fmean(ms) if ms else None


def kernels_per_step(run):
    tr = run.result.trace
    return tr["kernels"] / tr["steps"] if tr and tr["steps"] else None


def device_idle_pct(run):
    """Share of the traced window in which no device operation runs."""
    tr = run.result.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(run, pattern: str, bound_s: float):
    """The bound over the traced device seconds per launch of the kernels
    whose name matches ``pattern``."""
    tr = run.result.trace
    if not tr:
        return None
    us = [d for n, d in tr["kernel_us"] if re.search(pattern, n)]
    if not us:
        return None
    return 100.0 * bound_s / (sum(us) * 1e-6 / len(us))


def step_seconds(run):
    """Host seconds of work per step: the driver's own where it has one
    (a paced tick's work, its sleep left out), else the timed window over
    its steps."""
    r = run.result
    if r.step_s is not None:
        return r.step_s
    return r.window_s / r.steps if r.steps else None


def physics_bound_s(run):
    sh = run.result.shapes
    return counts.physics_bound_s(run.cfg, sh["num_envs"], sh["ring_rows"])


def rollout_flops(run) -> float:
    """Counted work of one control step: the physics' operations and the
    actor's forward at the batch."""
    sh = run.result.shapes
    B = sh["num_envs"]
    return (counts.physics_ops_per_env(run.cfg) * B + counts.mlp_flops(
        B, counts.actor_layers(sh["obs_dim"], sh["action_dim"],
                               sh["hidden"])))


def mfu_pct(run, flops: float):
    """Counted work per step at the FP32 peak over the host-clock time per
    step (``step_seconds``)."""
    s = step_seconds(run)
    return None if not s else 100.0 * flops / (counts.PEAK_FP32_FLOPS * s)
