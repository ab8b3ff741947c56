"""Spans, counters and phase meters: the port's one tracing system.

The port of ``force2vec_tpu/utils/profiling.py``.  The reference's only
observability is a wall-clock print per run (omp_get_wtime around the
loop, sample/algorithms.cpp:647-648) and the ``Results.txt`` ledger.

**Spans and counters.**  ``span(name)`` times a block of host work (a
``with`` block, or a function it decorates) on ``time.perf_counter_ns``
into a process-wide registry that keeps one aggregate per name: how many
times it ran, its total time, its self time (the total less the time of
the spans nested in it) and the name of the span it last ran inside.
``counter(name, value)`` adds to a named count in the same registry;
``snapshot()`` reads both as plain numbers and ``reset()`` clears them.
The registry holds aggregates only, so its size is bounded by the number
of names.  With no profiler active a span calls no torch function; while a
``torch.profiler`` records, each span also opens a ``record_function`` of
its name, so that it lies on the profiler's timeline beside the device's
activity.

The spans and counters of the port (``README.md`` lists them): set-up's
``graph.from_coo``, ``trainer.init`` (a trainer's constructor) with
``trainer.layout`` (its layout's build) and, for the sync trainer of a
walk model, ``walk.tables`` (its walk tables) in it, ``kernels.load`` (the
kernel library's hash, build and load) with the counter
``kernels.nvcc_jobs``, and a CUDA-graph trainer's ``span.warmup`` (the
eager iteration before a capture), ``span.capture`` and ``span.replay``
(one a replayed iteration) with the counter ``span.replays``, and the
sync trainer's carried replica's counters ``replica.carried`` and
``replica.casts`` (``train/sync.py``).

**Phase meters.**  ``Meter`` times the phases of an iteration on the
device.  A phase on a card is timed by a pair of CUDA events on the
current stream, so timing adds no host sync to the loop: the elapsed
times are read when ``seconds`` is, after one sync.  A phase entered while
a CUDA graph is captured (``train/graph.py::IterationGraph`` with this
meter) records its events as the graph's external event nodes, which
every replay records again: the graph adds each replay's times
(``add_replay``), waiting for the replay, so a metered graph costs one
host sync an iteration.  Each phase is also a span of its name (its host
side) and an NVTX range.  On the CPU a phase is timed by the host clock.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# name -> [count, total ns, self ns, parent span's name or None]
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, float] = {}
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last


def _open_spans() -> list:
    try:
        return _OPEN.stack
    except AttributeError:
        _OPEN.stack = []
        return _OPEN.stack


class span(contextlib.ContextDecorator):
    """Time the enclosed block (or each call of a decorated function) as
    span ``name`` in the registry.  ``seconds``: this instance's time,
    once it has ended.  Spans nest: time spent in a span opened inside
    another counts to the outer one's total, not to its self time (a span
    opened inside one of its own name counts to its total twice)."""

    def __init__(self, name: str):
        self.name = name
        self.seconds: Optional[float] = None
        self._record = None

    def _recreate_cm(self):
        return span(self.name)  # a decorated function's own instance a call

    def __enter__(self) -> "span":
        if getattr(_autograd_profiler, "_is_profiler_enabled", False):
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        _open_spans().append(self)
        self._inner = 0
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self._t0
        stack = _open_spans()
        stack.pop()
        parent = stack[-1] if stack else None
        agg = _SPANS.get(self.name)
        if agg is None:
            agg = _SPANS[self.name] = [0, 0, 0, None]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - self._inner
        if parent is not None:
            parent._inner += dt
            agg[3] = parent.name
        self.seconds = dt / 1e9
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None


def counter(name: str, value: float) -> None:
    """Add ``value`` to the counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def snapshot() -> dict:
    """The registry as plain data: ``{"spans": {name: {"count", "total_s",
    "self_s", "parent"}}, "counters": {name: value}}``."""
    return {
        "spans": {name: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9,
                         "parent": p}
                  for name, (c, t, s, p) in _SPANS.items()},
        "counters": dict(_COUNTERS),
    }


def reset() -> None:
    """Clear every span's aggregate and every counter."""
    _SPANS.clear()
    _COUNTERS.clear()


def report() -> str:
    """The registry as text: one line a span, then one a counter."""
    snap = snapshot()
    lines = [f"span {name}: {a['count']}x, total {a['total_s']:.6f} s, "
             f"self {a['self_s']:.6f} s"
             + (f", in {a['parent']}" if a["parent"] else "")
             for name, a in snap["spans"].items()]
    lines += [f"counter {name}: {v:g}" for name, v in snap["counters"].items()]
    return "\n".join(lines)


class Meter:
    """Accumulates per-phase time, on the device's clock on a card.

    >>> m = Meter(device)
    >>> with m.phase("train"):
    ...     step(x)
    >>> m.seconds["train"]
    """

    def __init__(self, device="cpu") -> None:
        self.device = torch.device(device)
        self._host: Dict[str, float] = {}
        self._events: Dict[str, list] = {}
        self._replayed: Dict[str, float] = {}  # seconds of graph replays
        self._captured: Optional[dict] = None  # where a capture's go

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            if self.device.type != "cuda":
                t0 = time.perf_counter()
                try:
                    yield self
                finally:
                    self._host[name] = (self._host.get(name, 0.0)
                                        + time.perf_counter() - t0)
                return
            # in a capture: event record nodes of the graph
            external = torch.cuda.is_current_stream_capturing()
            if external and self._captured is None:
                raise RuntimeError(
                    f"Meter phase {name!r} entered in a CUDA graph capture "
                    "that does not time its replays: attach the meter to "
                    "the IterationGraph")
            start = torch.cuda.Event(enable_timing=True, external=external)
            end = torch.cuda.Event(enable_timing=True, external=external)
            stream = torch.cuda.current_stream(self.device)
            torch.cuda.nvtx.range_push(name)
            start.record(stream)
            try:
                yield self
            finally:
                end.record(stream)
                torch.cuda.nvtx.range_pop()
                (self._captured if external else self._events).setdefault(
                    name, []).append((start, end))

    @contextlib.contextmanager
    def capturing(self, events: dict):
        """The phases of a graph's capture record into ``events``."""
        self._captured = events
        try:
            yield
        finally:
            self._captured = None

    def add_replay(self, events: dict) -> None:
        """Add the phase times of the replay just launched of a graph
        whose capture recorded ``events`` (waits for the replay)."""
        for name, pairs in events.items():
            pairs[-1][1].synchronize()
            self._replayed[name] = (self._replayed.get(name, 0.0) + sum(
                s.elapsed_time(e) for s, e in pairs) / 1e3)

    @property
    def seconds(self) -> Dict[str, float]:
        """Seconds per phase: host clock, or the device's between each
        phase's events (waits for them) and in each graph replay."""
        out = dict(self._host)
        for name, pairs in self._events.items():
            if pairs:
                pairs[-1][1].synchronize()
            out[name] = sum(s.elapsed_time(e) for s, e in pairs) / 1e3
        for name, sec in self._replayed.items():
            out[name] = out.get(name, 0.0) + sec
        return out
