"""The batched env step replayed as a CUDA graph.

``BatchedQuadrupedEnv.step`` goes through ``StepGraphs.step``. The step is
one algorithm whose host-side choices (the configuration's branches, the
batch, ``autoreset``, a Python ``donef``, the ring head) are fixed by what
the call can see, so one capture per such key holds every kernel of it,
the physics kernel's ctypes launch and the autoreset included, and a
replay costs the host one graph launch instead of ~460-540 launches.

A call runs the eager step (``BatchedQuadrupedEnv._step``), counted by the
first reason that applies, in this order: the NaN checks are on
(``nan_checks``), an input requires grad (``grad``), the env is on the CPU
(``cpu``), the state's generator is not a CUDA generator (``generator``),
``donef`` is neither a Python bool nor a tensor (``donef``), or a capture is
under way on the current stream (``capturing``: the caller's own capture
then holds the eager step).

Every other call has a key: the action's shape and dtype, ``autoreset``,
``donef`` (the bool, or a tensor's shape and dtype: the tensor is copied
into a static input) and the ring head. The first call for a key runs
eager (``warmup``): its result is returned, and it builds what the capture
reads (the ring's device indices, the kernel library, cuBLAS's handle).
Then the step is captured on static copies of its inputs. Later calls with
the key copy the state and action into the static inputs (one
``_foreach_copy_`` per dtype; ``push_salt``, a host int that changes
between resets, goes in as a device scalar, refilled only when it
changes), replay, and copy the outputs into fresh tensors (one
``_foreach_copy_`` per dtype). Returned tensors never alias the graph's
buffers or an earlier replay's: the fields the step passes through
unchanged (the ETG readout, flat ground's dynamics, ``dr_scale``,
``push_salt``) are the caller's own objects, as in the eager step.

Randomness: the state's generator is registered with each graph, so a
replay draws what the eager step draws from the same generator state and
advances it as far; a capture does not advance it. The cache holds the
graphs of one generator, at most one per ring-head value (1 on flat
ground, 4 under DR's 40-row ring), and is dropped when a call brings
another generator, so a caller that resets with a new generator
recaptures instead of growing memory. The graphs of one cache share a
memory pool, and each replay's outputs are copied out before the next.
A dropped env's graphs are freed by the cyclic collector (the env and its
cache refer to each other), and freeing them inside another capture
invalidates it, so a capture collects first and holds the collector off
until it ends.

``physics_step.control_step.launches`` and ``etg_residual.launches``
advance by the capture's launches (one and two) on every replay and not on
the capture itself; a replay adds its ETG launches to the profiler's
``etg_launches`` counter. ``stats`` (the env's
``graph_stats``) counts captures, replays and eager calls by reason. The
graphed call's ``env.step`` span holds ``env.graph.copy_in``,
``env.graph.replay`` and ``env.graph.copy_out``; a capturing call's holds
the eager step's phase spans and ``env.graph.capture`` (which holds the
phase spans of the captured, not executed, step).
"""

from __future__ import annotations

import collections
import gc
from typing import List, Optional

import torch

from paddlerobotics_torch.ops import etg_residual, physics_step
from paddlerobotics_torch.utils import profiler


def eager_reason(env, state, leaves: List[torch.Tensor], actions,
                 donef) -> Optional[str]:
    """Why this call runs the eager step, or None when it can be graphed
    (the order of the module docstring)."""
    if profiler.nan_checks_on:
        return "nan_checks"
    if actions.requires_grad or any(t.requires_grad for t in leaves) or (
            isinstance(donef, torch.Tensor) and donef.requires_grad):
        return "grad"
    if env.device.type != "cuda":
        return "cpu"
    if state.rng.device.type != "cuda":
        return "generator"
    if not isinstance(donef, (bool, torch.Tensor)):
        return "donef"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def _by_dtype(ts: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``ts`` grouped by dtype: one ``_foreach_copy_`` each."""
    groups = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


class _Graph:
    """One captured step: its static inputs, where each output comes from,
    and the graph."""

    def __init__(self, env, state, leaves, actions, donef, autoreset, pool,
                 stream):
        dev = env.device
        ins = [torch.empty_like(t) for t in leaves]
        ins.append(torch.empty(actions.shape, dtype=actions.dtype,
                               device=dev))
        if isinstance(donef, torch.Tensor):
            ins.append(torch.empty(donef.shape, dtype=donef.dtype,
                                   device=dev))
            static_done = ins[-1]
        else:
            static_done = donef
        self.salt = torch.zeros((), dtype=torch.int32, device=dev)
        self.salt_value = None
        static_state = type(state).from_leaves(
            ins[:len(leaves)], state.robot.hist_head, state.rng, self.salt)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.rng)
        launches = physics_step.control_step.launches
        etg_launches = etg_residual.etg_residual.launches
        rng_state = state.rng.get_state()
        # A collection inside the capture can destroy the graphs of an env
        # the caller dropped, which invalidates the capture (torch.cuda.graph
        # collects first only when configured to): collect now, and hold
        # the collector off until the capture ends.
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                new_state, obs, reward, done, info = env._step(
                    static_state, ins[len(leaves)], static_done, autoreset)
        finally:
            if gc_on:
                gc.enable()
            self.launches = physics_step.control_step.launches - launches
            physics_step.control_step.launches = launches
            self.etg_launches = (etg_residual.etg_residual.launches
                                 - etg_launches)
            etg_residual.etg_residual.launches = etg_launches
        if not torch.equal(state.rng.get_state(), rng_state):
            state.rng.set_state(rng_state)
        self.n_state = len(leaves)
        self.head = new_state.robot.hist_head
        self.info_keys = list(info)
        outs = new_state.leaves() + [obs, reward, done, *info.values()]
        # each output: (0, j) the caller's input j (passed through, as the
        # eager step returns it), or (1, k) static output k, copied out
        # once however many outputs name it
        where_in = {id(t): j for j, t in enumerate(ins)}
        where_out = {}
        copy: List[torch.Tensor] = []
        out_map = []
        for t in outs:
            if id(t) in where_in:
                out_map.append((0, where_in[id(t)]))
                continue
            if id(t) not in where_out:
                where_out[id(t)] = len(copy)
                copy.append(t)
            out_map.append((1, where_out[id(t)]))
        self.copy, self.out_map = copy, out_map
        self.out_groups = [(ix, [copy[i] for i in ix])
                           for ix in _by_dtype(copy)]
        self.ins = ins
        self.in_groups = [(ix, [ins[i] for i in ix]) for ix in _by_dtype(ins)]

    def replay(self, state, leaves, actions, donef):
        with profiler.annotate("env.graph.copy_in"):
            src = leaves + [actions]
            if isinstance(donef, torch.Tensor):
                src.append(donef)
            for ix, dst in self.in_groups:
                torch._foreach_copy_(dst, [src[i] for i in ix])
            if state.push_salt != self.salt_value:
                self.salt.fill_(state.push_salt)
                self.salt_value = state.push_salt
        with profiler.annotate("env.graph.replay"):
            self.graph.replay()
            physics_step.control_step.launches += self.launches
            etg_residual.etg_residual.launches += self.etg_launches
            profiler.count("etg_launches", self.etg_launches)
        with profiler.annotate("env.graph.copy_out"):
            fresh = [torch.empty_like(t) for t in self.copy]
            for ix, static in self.out_groups:
                torch._foreach_copy_([fresh[i] for i in ix], static)
            both = (src, fresh)
            vals = [both[k][j] for k, j in self.out_map]
            n = self.n_state
            new_state = type(state).from_leaves(
                vals[:n], self.head, state.rng, state.push_salt)
            info = dict(zip(self.info_keys, vals[n + 3:]))
            return new_state, vals[n], vals[n + 1], vals[n + 2], info


class StepGraphs:
    """The graphs of one env's step (the module docstring)."""

    def __init__(self, env):
        self.env = env
        self.stats = {"captures": 0, "replays": 0,
                      "eager": collections.Counter()}
        self._gen = None
        self._by_head = {}     # ring head -> (rest of the key, _Graph)
        self._stream = None

    def step(self, state, actions, donef, autoreset):
        leaves = state.leaves()
        reason = eager_reason(self.env, state, leaves, actions, donef)
        if reason is not None:
            self.stats["eager"][reason] += 1
            return self.env._step(state, actions, donef, autoreset)
        if state.rng is not self._gen:
            self._by_head.clear()
            self._gen = state.rng
        head = state.robot.hist_head
        rest = (tuple(actions.shape), actions.dtype, autoreset,
                donef if isinstance(donef, bool)
                else (tuple(donef.shape), donef.dtype))
        hit = self._by_head.get(head)
        if hit is not None and hit[0] == rest:
            self.stats["replays"] += 1
            return hit[1].replay(state, leaves, actions, donef)
        self.stats["eager"]["warmup"] += 1
        out = self.env._step(state, actions, donef, autoreset)
        with profiler.annotate("env.graph.capture"):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.env.device)
            pool = (next(iter(self._by_head.values()))[1].graph.pool()
                    if self._by_head else None)
            self._by_head[head] = (rest, _Graph(
                self.env, state, leaves, actions, donef, autoreset, pool,
                self._stream))
        self.stats["captures"] += 1
        return out
