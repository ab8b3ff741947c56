"""The port's spans and counters (``force2vec_tpu_torch/utils/profiling.py``)
and the benchmark's readers of them (``portbench/metrics/``), on the CPU.

A span keeps one aggregate a name (count, total, self time, parent) in a
process-wide registry; with no profiler active it calls no torch function,
and under a ``torch.profiler`` it also lies on the profiler's timeline.
The set-up spans are held where the work happens (``Graph.from_coo``, a
trainer's constructor and its layout, the kernels' build counter, the
replay loop), and each new per-layer metric to the span it reads.  Every
test here runs in well under a second.
"""

import os
import sys

import numpy as np
import pytest
import torch

from force2vec_tpu_torch import cli
from force2vec_tpu_torch.graphs.csr import Graph
from force2vec_tpu_torch.ops import _build
from force2vec_tpu_torch.train.graph import IterationGraph
from force2vec_tpu_torch.train.trainer import TrainConfig
from force2vec_tpu_torch.utils import profiling
from force2vec_tpu_torch.utils.profiling import (Meter, counter, reset,
                                                 snapshot, span)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(ROOT, "tests", "data", "karate.mtx")


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset()
    yield
    reset()


def _ring(n: int = 40) -> Graph:
    src = np.arange(n)
    dst = (src + 1) % n
    return Graph.from_coo(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), None, n=n)


def test_spans_nest_with_self_time_and_parents():
    with span("outer") as outer:
        with span("inner") as inner:
            sum(range(1000))
        with span("inner"):
            pass
        counter("work", 3)
    counter("work", 4)
    spans = snapshot()["spans"]
    o, i = spans["outer"], spans["inner"]
    assert (o["count"], i["count"]) == (1, 2)
    assert (o["parent"], i["parent"]) == (None, "outer")
    assert 0 < i["total_s"] < o["total_s"]
    assert o["self_s"] == pytest.approx(o["total_s"] - i["total_s"],
                                        abs=1e-12)
    assert i["self_s"] == pytest.approx(i["total_s"], abs=1e-12)
    assert outer.seconds == pytest.approx(o["total_s"], abs=1e-12)
    assert 0 < inner.seconds < outer.seconds
    assert snapshot()["counters"] == {"work": 7}
    reset()
    assert snapshot() == {"spans": {}, "counters": {}}


def test_a_decorated_function_is_a_span_a_call():
    @span("twice")
    def f(k):
        with span("body"):
            return k + 1

    assert f(1) == 2 and f(2) == 3 and f.__name__ == "f"
    spans = snapshot()["spans"]
    assert spans["twice"]["count"] == 2
    assert spans["body"]["parent"] == "twice"
    assert spans["twice"]["self_s"] == pytest.approx(
        spans["twice"]["total_s"] - spans["body"]["total_s"], abs=1e-12)


def test_a_span_calls_no_torch_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span called record_function")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    torch_dir = os.path.dirname(torch.__file__) + os.sep
    torch_calls = []

    def watch(frame, event, arg):
        if event == "call" and frame.f_code.co_filename.startswith(torch_dir):
            torch_calls.append(frame.f_code.co_name)
        elif event == "c_call" and str(
                getattr(arg, "__module__", "")).startswith("torch"):
            torch_calls.append(arg.__name__)

    sys.setprofile(watch)
    try:
        with span("quiet"):
            with span("quieter"):
                pass
        counter("quiet.count", 1)
    finally:
        sys.setprofile(None)
    assert torch_calls == []
    assert snapshot()["spans"]["quieter"]["parent"] == "quiet"


def test_spans_lie_on_a_cpu_profilers_timeline():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with span("traced.outer"):
            with span("traced.inner"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"traced.outer", "traced.inner"} <= names
    assert snapshot()["spans"]["traced.inner"]["parent"] == "traced.outer"


def test_from_coo_records_its_span():
    g = _ring()
    s = snapshot()["spans"]["graph.from_coo"]
    assert g.nnz == 80 and s["count"] == 1 and s["parent"] is None
    assert s["self_s"] == s["total_s"] > 0


@pytest.mark.parametrize("schedule", ["sync", "batch", "vertex"])
def test_a_trainers_constructor_records_init_and_its_layout(schedule):
    g = _ring()
    cfg = TrainConfig(dim=8, ns=2, batch_size=8)
    if schedule == "sync":
        from force2vec_tpu_torch.train.sync import SyncForce2Vec as T
    elif schedule == "batch":
        from force2vec_tpu_torch.train.trainer import Force2Vec as T
    else:
        from force2vec_tpu_torch.dist.vertex_sharded import (
            VertexShardedForce2Vec as T)
    T(g, cfg, device="cpu")
    spans = snapshot()["spans"]
    init, layout = spans["trainer.init"], spans["trainer.layout"]
    assert (init["count"], layout["count"]) == (1, 1)
    assert layout["parent"] == "trainer.init" and init["parent"] is None
    assert init["self_s"] == pytest.approx(
        init["total_s"] - layout["total_s"], abs=1e-12)


def test_a_built_library_counts_no_nvcc_job(tmp_path, monkeypatch):
    lib = tmp_path / "libf2v_kernels_cached.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    assert _build.build() == lib
    assert snapshot()["counters"] == {"kernels.nvcc_jobs": 0}


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_each_replay_is_a_span_and_counted():
    """The replay loop of ``IterationGraph.run`` with a captured graph in
    place (a stand-in whose replay counts): one ``span.replay`` a
    replayed iteration, holding the host's prepare."""
    prepared = []

    def prepare(seed, it):
        with span("prepare"):
            prepared.append(it)

    g = IterationGraph(prepare, lambda x: None, ())
    x = torch.zeros(4)
    fake = _FakeGraph()
    g.key = (x.data_ptr(), tuple(x.shape), x.dtype)
    g.graphs, g._deltas, g._phases = [fake], [{}], [{}]
    g.run(x, 7, 5, 3)
    snap = snapshot()
    assert fake.replays == 5 and prepared == [3, 4, 5, 6, 7]
    assert snap["spans"]["span.replay"]["count"] == 5
    assert snap["counters"]["span.replays"] == 5
    assert snap["spans"]["prepare"]["parent"] == "span.replay"


def test_a_meter_phase_is_a_span():
    m = Meter("cpu")
    for _ in range(3):
        with m.phase("apply"):
            torch.ones(16).sum()
    s = snapshot()["spans"]["apply"]
    assert s["count"] == 3 and s["total_s"] > 0
    assert m.seconds["apply"] > 0


def test_verbose_cli_reports_the_spans(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("F2V_NO_NATIVE", "1")  # the loader through from_coo
    assert cli.main(["-input", KARATE, "-output", str(tmp_path), "-iter",
                     "2", "-dim", "8", "--schedule", "sync", "--device",
                     "cpu", "--verbose"]) == 0
    err = capsys.readouterr().err
    lines = err.splitlines()
    assert any(ln.startswith("span graph.from_coo: 1x") for ln in lines)
    assert any(ln.startswith("span trainer.layout: 1x") and
               ln.endswith("in trainer.init") for ln in lines)
    assert any(ln.startswith("span trainer.init: 1x") for ln in lines)


# -- the benchmark's readers ------------------------------------------------

# metric: (the snapshot planted, the value it reads)
_PLANTED_SPANS = {
    "graph.from_coo": {"count": 1, "total_s": 3.5, "self_s": 3.25,
                       "parent": None},
    "trainer.init": {"count": 1, "total_s": 0.75, "self_s": 0.25,
                     "parent": None},
    "trainer.layout": {"count": 1, "total_s": 0.5, "self_s": 0.5,
                       "parent": "trainer.init"},
    "kernels.load": {"count": 1, "total_s": 0.125, "self_s": 0.125,
                     "parent": "span.warmup"},
    "span.warmup": {"count": 1, "total_s": 1.125, "self_s": 1.0,
                    "parent": None},
    "span.replay": {"count": 400, "total_s": 0.01, "self_s": 0.01,
                    "parent": None},
}
_EXPECTED = {
    "setup.graph_s": ("graph.from_coo", 3.25),
    "setup.trainer_init_s": ("trainer.init", 0.75),
    "setup.layout_s": ("trainer.layout", 0.5),
    "setup.kernels_s": ("kernels.load", 0.125),
    "setup.warmup_s": ("span.warmup", 1.0),
    "replay.host_us": ("span.replay", 25.0),
}


def _reader(metric):
    from portbench import spec

    return spec.reader(metric)


@pytest.mark.parametrize("metric", sorted(_EXPECTED))
def test_metric_reads_its_span(metric, monkeypatch):
    planted = {"spans": dict(_PLANTED_SPANS),
               "counters": {"span.replays": 400, "kernels.nvcc_jobs": 0}}
    monkeypatch.setattr(profiling, "snapshot", lambda: planted)
    assert _reader(metric)({"trace": None}) == pytest.approx(
        _EXPECTED[metric][1], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(_EXPECTED))
def test_metric_reads_nothing_where_its_span_is_absent(metric, monkeypatch):
    name = _EXPECTED[metric][0]
    spans = {k: v for k, v in _PLANTED_SPANS.items() if k != name}
    planted = {"spans": spans, "counters": {"span.replays": 400}}
    monkeypatch.setattr(profiling, "snapshot", lambda: planted)
    assert _reader(metric)({"trace": None}) is None
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counters": {}})
    assert _reader(metric)({"trace": None}) is None


def test_metrics_read_nothing_from_a_program_without_spans(monkeypatch):
    """The parent of this change has no ``snapshot``: each reader then
    returns None and raises nothing."""
    monkeypatch.delattr(profiling, "snapshot")
    for metric in _EXPECTED:
        assert _reader(metric)({"trace": None}) is None
