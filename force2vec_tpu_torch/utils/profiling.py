"""Profiling and metering.

The port of ``force2vec_tpu/utils/profiling.py``.  The reference's only
observability is a wall-clock print per run (omp_get_wtime around the
loop, sample/algorithms.cpp:647-648) and the ``Results.txt`` ledger.
Here: per-phase timers, work counters and a rate in the benchmark's unit
(edge force-updates/s), and a ``torch.profiler`` trace.

A phase on a card is timed by a pair of CUDA events on the current stream,
so timing adds no host sync to the loop: the elapsed times are read when
``seconds`` is, after one sync.  A phase entered while a CUDA graph is
captured (``train/graph.py::IterationGraph`` with this meter) records its
events as the graph's external event nodes, which every replay records
again: the graph adds each replay's times (``add_replay``), waiting for
the replay, so a metered graph costs one host sync an iteration.  Each
phase is also an NVTX range, which a ``torch.profiler`` or Nsight trace
shows by name.  On the CPU a phase is timed by the host clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class Meter:
    """Accumulates per-phase time and work counters.

    >>> m = Meter(device)
    >>> with m.phase("train"):
    ...     step(x)
    >>> m.count("edge_updates", nnz + n * ns)
    >>> m.report()
    """

    def __init__(self, device="cpu") -> None:
        self.device = torch.device(device)
        self._host: Dict[str, float] = {}
        self._events: Dict[str, list] = {}
        self._replayed: Dict[str, float] = {}  # seconds of graph replays
        self._captured: Optional[dict] = None  # where a capture's go
        self.counts: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(name):
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

    def count(self, name: str, value: float) -> None:
        self.counts[name] = self.counts.get(name, 0.0) + value

    def rate(self, count_name: str, phase_name: str) -> float:
        s = self.seconds.get(phase_name, 0.0)
        return self.counts.get(count_name, 0.0) / s if s > 0 else 0.0

    def report(self) -> str:
        lines = [f"{k}: {v:.6f}s" for k, v in self.seconds.items()]
        lines += [f"{k}: {v:,.0f}" for k, v in self.counts.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def phase_timer(name: str, verbose: bool = True, device=None):
    """One phase timed once: on ``device``'s stream by CUDA events (the
    device's time, one sync at the end), else by the host clock."""
    m = Meter(device or "cpu")
    with m.phase(name):
        yield
    if verbose:
        print(f"[{name}] {m.seconds[name]:.6f}s")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the enclosed block, the CPU and (on a
    card) CUDA activity, written to ``log_dir`` as a Chrome/Perfetto
    trace; no-op when ``log_dir`` is None.  Meter phases show in it as
    ``record_function`` spans (and, on a card, NVTX ranges)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
