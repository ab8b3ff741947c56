"""One training iteration captured as a CUDA graph and replayed.

The port's counterpart of the JAX package's whole-run program
(``force2vec_tpu/train/trainer.py::make_train_dispatcher`` and the
trainers' ``_build_train_fn``): there a span of iterations is one compiled
device program, cached per trip count, with no per-step host dispatch.
Here a trainer's iteration is one ``torch.cuda.CUDAGraph``, captured once
per X and replayed once per iteration, so that an iteration costs the host
one graph launch (and a few small fills) however many kernels it runs.

What a replay reads that changes from one iteration to the next lives in
device memory the graph was captured on:

* the step: the trainer's 0-d f32 step buffer, which the force kernels
  read through a pointer (``csrc/common.cuh::EllArgs::step``) and the torch
  ops take as a tensor; the host writes ``step_at``'s value into it before
  each replay where it changes (``StepBuffer``, a ``fill_``);
* the draws: the negatives (and walks) are drawn inside the graph from the
  trainer's generator, registered with the graph
  (``CUDAGraph.register_generator_state``) and re-seeded with
  ``iteration_seed(seed, it)`` before each replay.  A replay then draws
  what an eager iteration draws from a generator seeded so, bit for bit
  (torch 2.11 + CUDA 12.8 on an H100; ``chip_smoke.py --path L`` checks it
  on every run), so spans compose into the straight run and a resumed run
  equals it;
* X itself, updated in place: the graph is keyed by X's ``(data_ptr,
  shape, dtype)``, and a new X is captured anew, as a new trip count
  recompiles in JAX.

The first iteration of a span that captures runs eagerly on the capture
stream and is the warm-up torch wants before a capture (it builds the
kernel library, the sigmoid table and the allocator's blocks); the capture
that follows records the next iteration without running it, so no
iteration is added and X and the generator move as in the eager loop.  The
capture records each force kernel's launches, and every replay adds them
to ``force_kernels.launch_counts``, so a run counts the launches its
eager loop would.  A failure to capture raises.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import torch

from force2vec_tpu_torch.ops import force_kernels


class StepBuffer:
    """A trainer's step as a 0-d f32 tensor on its device (``tensor``):
    the force kernels read it through a pointer, and a captured iteration
    reads it at each replay.  ``write`` fills it, on the stream, only when
    the value changes (a constant step is written once a run)."""

    def __init__(self, device):
        self.tensor = torch.zeros((), dtype=torch.float32, device=device)
        self._held = 0.0

    def write(self, step: float) -> torch.Tensor:
        """The tensor, holding ``step``."""
        if step != self._held:
            self.tensor.fill_(step)
            self._held = step
        return self.tensor


class IterationGraph:
    """A trainer's iteration as a CUDA graph.

    ``prepare(seed, it)``: the host's work before iteration ``it`` (write
    the step buffer, re-seed ``gen``); ``body(x)``: the iteration's device
    work on X in place, reading only the trainer's static buffers and
    drawing from ``gen``.  ``run`` runs a span: prepare, then body eagerly
    (the warm-up) and a capture where X is new, then prepare and a replay
    for each other iteration.

    After a capture: ``capture_seconds`` (host time of the capture and the
    graph's instantiation), ``pool_bytes`` (the device memory of the
    graph's private pool), ``counts`` (kernel launches per replay) and
    ``captures`` (how many times this trainer captured).
    """

    def __init__(self, prepare: Callable[[int, int], None],
                 body: Callable[[torch.Tensor], None],
                 gen: torch.Generator):
        self._prepare = prepare
        self._body = body
        self._gen = gen
        self.key: Optional[tuple] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: dict = {}
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.captures = 0

    def run(self, x: torch.Tensor, seed: int, num_iters: int,
            iter_offset: int = 0) -> torch.Tensor:
        """Iterations ``[iter_offset, iter_offset + num_iters)`` on X in
        place, on the current stream; returns X."""
        its = range(iter_offset, iter_offset + num_iters)
        key = (x.data_ptr(), tuple(x.shape), x.dtype)
        if its and key != self.key:
            self._capture(x, key, seed, its[0])
            its = its[1:]
        counts = force_kernels.launch_counts
        for it in its:
            self._prepare(seed, it)
            self.graph.replay()
            for name, n in self.counts.items():
                counts[name] += n
        return x

    def run_uncaptured(self, x: torch.Tensor, seed: int, num_iters: int,
                       iter_offset: int = 0) -> torch.Tensor:
        """What ``run`` replays, run eagerly on any device (the CPU
        tests' view of the captured code): prepare, then body, for each
        iteration."""
        for it in range(iter_offset, iter_offset + num_iters):
            self._prepare(seed, it)
            self._body(x)
        return x

    def reset(self) -> None:
        """Drop the graph: the next span captures anew (after a change
        to what an iteration runs, such as torch's deterministic mode)."""
        self.graph = self.key = None

    def _capture(self, x: torch.Tensor, key: tuple, seed: int,
                 it: int) -> None:
        """Iteration ``it`` eagerly on a side stream (the warm-up), then
        the capture of ``body(x)`` on it."""
        dev = x.device
        self.reset()  # the old graph's pool goes first
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._prepare(seed, it)
            self._body(x)
        # A trainer and its graph hold each other: a dead trainer's graph
        # is freed by the cycle collector, and freed in the middle of a
        # capture it would invalidate the capture.  Collect now, and hold
        # the collector off until the capture ends.
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        counts = force_kernels.launch_counts
        before = dict(counts)
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            # thread_local: a checkpoint writer thread may wait on an event
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self._body(x)
        finally:
            if collecting:
                gc.enable()
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(graph.pool()))
        # the capture launched nothing: its counts are each replay's
        self.counts = {k: counts[k] - before[k] for k in counts
                       if counts[k] != before[k]}
        counts.update(before)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph, self.key = graph, key
        self.captures += 1
