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
* the draws: the negatives (and walks, and the vertex schedule's pool
  choices) are drawn inside the graph from the trainer's generators,
  registered with the graph (``CUDAGraph.register_generator_state``) and
  re-seeded from ``iteration_seed(seed, it)`` before each replay.  A
  replay then draws what an eager iteration draws from a generator seeded
  so, bit for bit (torch 2.11 + CUDA 12.8 on an H100; ``chip_smoke.py
  --path L`` checks it on every run), so spans compose into the straight
  run and a resumed run equals it;
* X itself, updated in place: the graph is keyed by X's ``(data_ptr,
  shape, dtype)``, and a new X is captured anew, as a new trip count
  recompiles in JAX.

The first iteration of a span that captures runs eagerly on the capture
stream and is the warm-up torch wants before a capture (it builds the
kernel library, the sigmoid table and the allocator's blocks, and on
several ranks creates the NCCL communicators); the capture that follows
records an iteration without running it, so no iteration is added and X
and the generators move as in the eager loop.  An iteration whose work
alternates between two forms (the vertex schedule's ``halo_stale``: the
exchange issued into one of two static tables, the other read) has one
body and one graph per parity; iteration ``it`` replays graph ``it %
parities``; the sync trainer's carried replica (``train/sync.py``) has
one a parity too, each gathering from one of two replicas and writing
the other.  Each graph has its own memory pool.

Collectives are captured as any other launch: the NCCL kernels join the
graph through the capture stream, so every rank replays one graph an
iteration, in the same order.  Such a graph holds its communicator, and
NCCL destroys a communicator only once no graph holds it: a process
drops its graphs (``release_all``) before it destroys its process group
(``dist/multihost.py::shutdown``).  The launch counts
(``force_kernels.launch_counts``, the sync trainer's tp ``all_reduce``
among them) are raised by the capture, which runs nothing: the capture's
raises are taken back and added again on every replay, so a run counts
what its eager loop would.  A meter (``utils/profiling.py::Meter``)
attached to the graph times the phases of every replay.  A failure to
capture raises.
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from force2vec_tpu_torch.ops import force_kernels
from force2vec_tpu_torch.utils.profiling import counter, span


def check_capturable(*groups) -> None:
    """Raise ``RuntimeError`` naming the backend unless every process
    group in ``groups`` (None: not sharded there) is NCCL's, whose
    collectives a CUDA graph captures.  A gloo group moves CUDA tensors
    through the host, which no graph can hold."""
    for group in groups:
        if group is None:
            continue
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise RuntimeError(
                f"run_span on a card replays each iteration as a CUDA graph, "
                f"and a {backend} process group's collectives cannot be "
                "captured: train on an NCCL group (one card a rank), or run "
                "run_iteration")


# every IterationGraph alive in this process (release_all)
_LIVE: "weakref.WeakSet[IterationGraph]" = weakref.WeakSet()


def release_all() -> None:
    """Drop the graphs of every trainer alive in this process (``reset``),
    those of trainers kept alive by a reference cycle too."""
    for graph in list(_LIVE):
        graph.reset()


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
    the step buffer, re-seed the generators ``gens``); ``body(x)``: the
    iteration's device work on X in place, reading only the trainer's
    static buffers and drawing from ``gens``; or a sequence of bodies, one
    per parity, iteration ``it`` running ``body[it % len(body)]``.
    ``start(x, it)``: the host's work at
    the start of a span from iteration ``it``, if any; ``end(x, it)``: at
    the end of a span whose next iteration is ``it``, if any.  ``run``
    runs a span: start, prepare, then the body eagerly (the warm-up) and a
    capture of each body where X is new, then prepare and a replay for
    each other iteration, then end.  ``meter``: a ``Meter`` whose phases the bodies
    enter, timed at every replay.  The warm-up, the captures and each
    replay are the spans ``span.warmup``, ``span.capture`` and
    ``span.replay`` (``utils/profiling.py``; the counter ``span.replays``).

    After a capture: ``capture_seconds`` (host time of the captures and
    the graphs' instantiation, the last ``span.capture``), ``pool_bytes``
    (the device memory of the graphs' private pools), ``counts`` (kernel
    launches per replay) and ``captures`` (how many times this trainer
    captured).
    """

    def __init__(self, prepare: Callable[[int, int], None],
                 body: Union[Callable[[torch.Tensor], None], Sequence],
                 gens: Sequence[torch.Generator],
                 start: Optional[Callable[[torch.Tensor, int], None]] = None,
                 end: Optional[Callable[[torch.Tensor, int], None]] = None):
        self._prepare = prepare
        self._start = start
        self._end = end
        self._bodies = tuple(body) if isinstance(body, (tuple, list)) else (
            body,)
        self._gens = tuple(gens)
        self.meter = None
        self.key: Optional[tuple] = None
        self.graphs: list = []
        self._deltas: list = []  # per graph: the launch counts of a replay
        self._phases: list = []  # per graph: the meter's captured events
        self.counts: dict = {}
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.captures = 0
        _LIVE.add(self)

    def run(self, x: torch.Tensor, seed: int, num_iters: int,
            iter_offset: int = 0) -> torch.Tensor:
        """Iterations ``[iter_offset, iter_offset + num_iters)`` on X in
        place, on the current stream; returns X."""
        its = range(iter_offset, iter_offset + num_iters)
        key = (x.data_ptr(), tuple(x.shape), x.dtype)
        if its and self._start is not None:
            self._start(x, its[0])
        if its and key != self.key:
            self._capture(x, key, seed, its[0])
            its = its[1:]
        n = len(self._bodies)
        for it in its:
            with span("span.replay"):
                q = it % n
                self._prepare(seed, it)
                self.graphs[q].replay()
                for name, k in self._deltas[q].items():
                    force_kernels.launch_counts[name] += k
                if self.meter is not None:
                    self.meter.add_replay(self._phases[q])
        counter("span.replays", len(its))
        if num_iters > 0 and self._end is not None:
            self._end(x, iter_offset + num_iters)
        return x

    def run_uncaptured(self, x: torch.Tensor, seed: int, num_iters: int,
                       iter_offset: int = 0) -> torch.Tensor:
        """What ``run`` replays, run eagerly on any device (the CPU
        tests' view of the captured code): start, then prepare and the
        iteration's body for each iteration, then end."""
        n = len(self._bodies)
        if num_iters > 0 and self._start is not None:
            self._start(x, iter_offset)
        for it in range(iter_offset, iter_offset + num_iters):
            self._prepare(seed, it)
            self._bodies[it % n](x)
        if num_iters > 0 and self._end is not None:
            self._end(x, iter_offset + num_iters)
        return x

    def reset(self) -> None:
        """Drop the graphs: the next span captures anew (after a change
        to what an iteration runs, such as torch's deterministic mode, or
        to the buffers it reads)."""
        self.graphs, self._deltas, self._phases = [], [], []
        self.key = None

    def _capture(self, x: torch.Tensor, key: tuple, seed: int,
                 it: int) -> None:
        """Iteration ``it`` eagerly on a side stream (the warm-up), then
        the capture of each body on it."""
        dev = x.device
        self.reset()  # the old graphs' pools go first
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), span("span.warmup"):
            self._prepare(seed, it)
            self._bodies[it % len(self._bodies)](x)
        # A trainer and its graph hold each other: a dead trainer's graph
        # is freed by the cycle collector, and freed in the middle of a
        # capture it would invalidate the capture.  Collect now, and hold
        # the collector off until the captures end.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        graphs, deltas, phases = [], [], []
        try:
            with span("span.capture") as timed:
                for body in self._bodies:
                    graph = torch.cuda.CUDAGraph()
                    for gen in self._gens:
                        graph.register_generator_state(gen)
                    before = dict(force_kernels.launch_counts)
                    events: dict = {}
                    capturing = (self.meter.capturing(events)
                                 if self.meter is not None
                                 else contextlib.nullcontext())
                    # thread_local: a checkpoint writer thread, or the NCCL
                    # watchdog, may query events while this thread captures
                    with capturing, torch.cuda.graph(
                            graph, stream=stream,
                            capture_error_mode="thread_local"):
                        body(x)
                    # the capture launched nothing: its raises are each
                    # replay's
                    counts = force_kernels.launch_counts
                    deltas.append({k: counts[k] - before[k] for k in counts
                                   if counts[k] != before[k]})
                    counts.update(before)
                    graphs.append(graph)
                    phases.append(events)
        finally:
            if collecting:
                gc.enable()
        self.capture_seconds = timed.seconds
        pools = {tuple(g.pool()) for g in graphs}
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) in pools)
        self.counts = deltas[0]
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graphs, self._deltas, self._phases = graphs, deltas, phases
        self.key = key
        self.captures += 1
