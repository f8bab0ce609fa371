"""What every driver shares: host-clock spans, the seeded weights, the
drawn sample of steps to compare, the gaps compared and the check's record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pathlib
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "paddlerobotics_tpu")


def forbidden_modules(modules: Iterable[str] | None = None) -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``paddlerobotics_torch`` is not
    ``paddlerobotics_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def scratch_dir() -> pathlib.Path:
    """Where a run's passing files go: ``TMPDIR``, else ``build/tmp``
    inside the checkout (never a fixed path shared with another run)."""
    d = os.environ.get("TMPDIR")
    d = pathlib.Path(d) if d else (pathlib.Path(__file__).resolve()
                                   .parents[1] / "build" / "tmp")
    d.mkdir(parents=True, exist_ok=True)
    return d


# --- spans -------------------------------------------------------------------

class Spans:
    """Host-clock spans by name. Off by default: ``span`` and ``wrap`` then
    cost one attribute test. With ``annotate`` each span is also a
    ``torch.profiler.record_function`` range, so a trace can say what the
    host was doing during a gap on the device."""

    def __init__(self, on: bool = False):
        self.on = on
        self.annotate = False
        self.ms: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        rf = (torch.profiler.record_function(name) if self.annotate
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` (an instance attribute shadows
        the class's method) as the span ``name``."""
        fn = getattr(obj, attr)

        def timed(*a, **k):
            with self.span(name):
                return fn(*a, **k)

        setattr(obj, attr, timed)

    def reset(self) -> None:
        self.ms = {}


# --- weights -----------------------------------------------------------------

def seeded_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for the benchmark's own draws: ``stream``
    keeps the weights', the reset's and the sample's draws apart."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed % 2 ** 63, stream])
                      .generate_state(1, np.uint64)[0]) % 2 ** 63)
    return g


def make_params(module: torch.nn.Module, generator: torch.Generator
                ) -> List[torch.Tensor]:
    """Weights for ``module``'s parameters, in its order, from one draw on
    the generator's device: each matrix normal with variance 1/fan_in, each
    vector normal with standard deviation 0.1."""
    params = list(module.parameters())
    flat = torch.randn(sum(p.numel() for p in params), generator=generator,
                       device=generator.device)
    out, i = [], 0
    for p in params:
        x = flat[i:i + p.numel()].view(p.shape)
        i += p.numel()
        scale = 1.0 / math.sqrt(p.shape[1]) if p.dim() == 2 else 0.1
        out.append(x * scale)
    return out


@torch.no_grad()
def load_params(module: torch.nn.Module, values: Sequence[torch.Tensor]):
    params = list(module.parameters())
    if len(params) != len(values):
        raise ValueError(f"{len(values)} weights for {len(params)} leaves")
    for p, v in zip(params, values):
        p.copy_(v.to(device=p.device, dtype=p.dtype).view(p.shape))
    return module


# --- the check ---------------------------------------------------------------

def sample_steps(seed: int, n: int, below: int) -> List[int]:
    """``n`` distinct step indices in ``[1, below)`` drawn from the seed,
    and step 0."""
    rng = np.random.default_rng([seed % 2 ** 63, 7])
    picks = rng.choice(np.arange(1, below), size=min(n, below - 1),
                       replace=False)
    return [0] + sorted(int(x) for x in picks)


def gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The widest gap between the program's ``p`` and the reference's
    ``r``, over the larger of the reference's widest magnitude and 1 (so a
    field near zero is held to an absolute gap). Booleans count 0 / 1; a
    NaN or a shape that differs reads infinite."""
    p = torch.as_tensor(p).detach().to("cpu", torch.float64)
    r = torch.as_tensor(r).detach().to("cpu", torch.float64)
    if p.shape != r.shape:
        return math.inf
    if r.numel() == 0:
        return 0.0
    d = (p - r).abs()
    if torch.isnan(d).any():
        return math.inf
    return float(d.max() / max(float(r.abs().max()), 1.0))


def widest(gaps: Dict[str, float]) -> tuple:
    """(name, gap) of the widest entry."""
    name = max(gaps, key=lambda k: gaps[k])
    return name, gaps[name]


@dataclasses.dataclass
class Check:
    """The numbers compared, each beside its limit, and what was compared."""
    limits: Dict[str, float]
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    where: Dict[str, str] = dataclasses.field(default_factory=dict)
    compared: int = 0

    def add(self, name: str, value: float, where: str = "") -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r}")
        value = float(value)
        if name not in self.values or not value <= self.values[name]:
            self.values[name] = value
            self.where[name] = where

    @property
    def correct(self) -> bool:
        return (set(self.values) == set(self.limits) and
                all(self.values[k] <= self.limits[k] for k in self.limits))

    def over(self) -> List[str]:
        return [k for k in self.limits
                if not self.values.get(k, math.inf) <= self.limits[k]]

    def line(self) -> Dict[str, Dict[str, float]]:
        """Each number beside its limit; a number that is not finite (a
        NaN, or nothing compared) is written as a string."""
        out = {}
        for k in self.limits:
            v = self.values.get(k, math.inf)
            out[k] = {"value": v if math.isfinite(v) else str(v),
                      "limit": self.limits[k]}
        return out


@dataclasses.dataclass
class RunResult:
    """What a driver hands back to ``run``."""
    metrics: Dict[str, float]            # end-to-end values by name
    check: Check
    attempted: int
    failed: int
    memory_peak_bytes: int
    window_s: float
    steps: int                           # control steps or ticks timed
    spans: Dict[str, List[float]]        # host ms per call, by span
    trace: Optional[dict] = None         # see trace.reduce
    shapes: Dict[str, int] = dataclasses.field(default_factory=dict)
    stand_ins: Dict[str, Check] = dataclasses.field(
        default_factory=dict)            # the same check of each stand-in
    window_start: float = 0.0            # host clock at the window's start
    step_s: Optional[float] = None       # work seconds per step, if not
                                         # the window over its steps


class Pacer:
    """An open loop's schedule: tick i is due ``dt`` after tick i−1, from a
    fixed start, whatever the ticks before it took."""

    def __init__(self, dt: float, clock=time.perf_counter,
                 sleep=time.sleep):
        self.dt, self.clock, self.sleep = dt, clock, sleep
        self.t0 = 0.0

    def start(self, t0: float | None = None) -> float:
        self.t0 = self.clock() if t0 is None else t0
        return self.t0

    def wait(self, i: int) -> float:
        """Sleep until tick i is due (not at all when it is late); returns
        its due time."""
        due = self.t0 + i * self.dt
        ahead = due - self.clock()
        if ahead > 0:
            self.sleep(ahead)
        return due

    def latency_ms(self, due: float) -> float:
        """Milliseconds from a tick's due time to now."""
        return (self.clock() - due) * 1e3


def timed_window(seconds: float, step: Callable[[int], None]) -> tuple:
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed on
    the host clock, then synchronize; returns (steps, seconds from the
    first call to the synchronize)."""
    t0 = time.perf_counter()
    n = 0
    while True:
        step(n)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return n, time.perf_counter() - t0


# --- configurations ----------------------------------------------------------

def quadruped_config(cls, *overrides: Dict[str, Dict]):
    """``cls()`` (the port's or the reference's ``QuadrupedConfig``) with
    each ``{section: {field: value}}`` of ``overrides`` applied in turn;
    lists become tuples where the default is one."""
    cfg = cls()
    for over in overrides:
        for section, fields in (over or {}).items():
            sub = getattr(cfg, section)
            kw = {}
            for k, v in fields.items():
                if not hasattr(sub, k):
                    raise KeyError(f"{section}.{k} is not a setting")
                kw[k] = tuple(v) if isinstance(getattr(sub, k), tuple) else v
            cfg = dataclasses.replace(cfg, **{
                section: dataclasses.replace(sub, **kw)})
    return cfg
