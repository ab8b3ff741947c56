"""CPU tests of the benchmark harness: how it finds a cell's parts, what it
generates and counts, what it refuses, and that its check passes the
program's CPU path and fails the control and planted faults.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
The cells run here at a size a test holds: the configuration's graph
shape with fewer vertices and edges, the widths and the schedule as the
cell states them.  On the CPU the trainers run their eager loop and the
kernels' plain versions; the card's path is checked by the benchmark's
own runs.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import calibrate, check, graphgen, run, spec, trace, work

ROOT = spec.ROOT
SEED = 2**31 + 12345  # larger than 32 signed bits hold
CELLS = ("youtube-tdist.sync", "flickr-tdist.sync", "youtube-tdist.batch",
         "youtube-tdist.bs1")


class HostClock:
    """The window's clock in a CPU test (the harness's is CUDA events)."""

    def start(self):
        self.t = [time.perf_counter()]

    def mark(self):
        self.t.append(time.perf_counter())

    def finish(self):
        pass

    def intervals_ms(self):
        return [1e3 * (b - a) for a, b in zip(self.t, self.t[1:])]


def small(name: str) -> spec.Cell:
    """The cell ``<config>.<traffic>``, built from its files (the batch
    cell, which ``BENCHMARK.json`` leaves out for now, too), at a size a
    test run holds: its configuration's graph shape at 3,000 vertices (a
    hub row past the width 256 among them)."""
    config, traffic = name.split(".")
    read = lambda rel: json.loads((ROOT / "portbench" / rel).read_text())  # noqa: E731
    cfg = read(f"configs/{config}.json")
    cfg["graph"] = dict(cfg["graph"], vertices=3000,
                        edges=9000 if config.startswith("youtube") else 60000)
    base = spec.load_cell("youtube-tdist.sync")
    return dataclasses.replace(base, name=name, config=cfg,
                               traffic=read(f"traffic/{traffic}.json"),
                               limits=read(f"cells/{name}.json")["limits"])


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# -- finding a cell's parts ---------------------------------------------------


def test_benchmark_cells_load():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) == set(check.NUMBERS)
        assert [m["name"] for m in cell.end_to_end] == [
            "setup_s", "updates_per_s", "iter_ms_p90"]
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))


def test_new_cell_config_traffic_and_metric_found_as_files(tmp_path):
    """A cell, its configuration, its traffic mix and a per-layer metric,
    each added as a new file (and an entry in BENCHMARK.json), are found
    with no harness file edited."""
    harness = tmp_path / "portbench"
    for d in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(ROOT / "portbench" / d, harness / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads(
        (ROOT / "portbench/configs/youtube-tdist.json").read_text())
    cfg["name"] = "tiny-tdist"
    (harness / "configs/tiny-tdist.json").write_text(json.dumps(cfg))
    (harness / "traffic/sync64.json").write_text(json.dumps(
        {"schedule": "sync", "bs": 0, "gather_dtype": "float16"}))
    (harness / "cells/tiny-tdist.sync64.json").write_text(json.dumps(
        {"limits": {"upd_err": 0.5, "row_err": 0.5}}))
    (harness / "metrics/tiny_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "tiny-tdist", "source": "x",
                             "file": "portbench/configs/tiny-tdist.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-tdist.sync64",
                               "config": "tiny-tdist", "traffic": "sync64",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "tiny_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "x", "moves": "updates_per_s",
                               "workloads": ["tiny-tdist.sync64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("tiny-tdist.sync64", root=tmp_path)
    assert cell.config["name"] == "tiny-tdist"
    assert cell.traffic["gather_dtype"] == "float16"
    assert cell.limits == {"upd_err": 0.5, "row_err": 0.5}
    assert "tiny_metric" in [m["name"] for m in cell.per_layer]
    assert spec.reader("tiny_metric", tmp_path)({}) == 42.0
    # the metric listed for the new cell only is not another cell's
    other = spec.load_cell("youtube-tdist.sync", root=tmp_path)
    assert "tiny_metric" not in [m["name"] for m in other.per_layer]
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell", root=tmp_path)


# -- the generator and the counts -------------------------------------------


@pytest.mark.parametrize("config", ["youtube-tdist", "flickr-tdist"])
def test_generator_hits_published_counts(config):
    cfg = json.loads((ROOT / f"portbench/configs/{config}.json").read_text())
    shape, pub = cfg["graph"], cfg["published"]
    src, dst = graphgen.edges(shape, SEED)
    n = pub["vertices"]
    assert len(src) == pub["edges"]
    assert np.all(src < dst) and src.min() >= 0 and dst.max() < n
    assert np.unique(src * n + dst).size == len(src)  # no duplicate
    deg = np.bincount(np.concatenate([src, dst]), minlength=n)
    assert len(deg) == n
    # a heavy tail on the order of the published graph's largest degree
    assert 0.7 * pub["max_degree"] < deg.max() < 1.3 * pub["max_degree"]


def test_generator_repeats_from_its_seed():
    shape = dict(json.loads(
        (ROOT / "portbench/configs/flickr-tdist.json").read_text())["graph"],
        vertices=5000, edges=40000)
    a, b, c = (graphgen.edges(shape, s) for s in (SEED, SEED, SEED + 1))
    assert all(np.array_equal(p, q) for p, q in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def test_roofline_byte_count_by_hand():
    n, nnz = 1134890, 2 * 2987624
    # X read and written (f32), ids and offsets, one negative set a group
    assert work.bytes_per_iter(n, nnz, 128, 5, 256, False) == (
        2 * 581_063_680 + 28_440_556 + 88_680)
    # -bs 1: a negative set a vertex
    assert work.bytes_per_iter(n, nnz, 128, 5, 256, True) == (
        2 * 581_063_680 + 28_440_556 + 22_697_800)
    # X held in two bytes halves X's part alone
    assert work.bytes_per_iter(n, nnz, 128, 5, 256, False, "bfloat16") == (
        581_063_680 + 28_440_556 + 88_680)
    assert work.updates_per_iter(n, nnz, 5) == 11_649_698
    # tdist: an edge 5·128 + 3, a negative 6·128 + 4, X's update 128 a row
    assert work.flops_per_iter("tdist", n, nnz, 128, 5) == (
        nnz * 643 + n * 5 * 772 + n * 128)
    peak = work.PEAKS["NVIDIA H100 80GB HBM3"]
    least = work.least_seconds_per_iter("tdist", n, nnz, 128, 5, 256, False,
                                        "float32", peak)
    assert least == pytest.approx(1_190_656_596 / 3.35e12)  # bytes bind


def test_trace_summary_by_hand():
    host = [(0.0, 10.0, trace.WINDOW), (0.0, 1.5, "cudaGraphLaunch"),
            (6.0, 9.0, "cudaEventSynchronize")]
    device = [(0.0, 10.0, trace.WINDOW), (1.2, 3.0, "void k1<int>(A)"),
              (2.0, 4.0, "k2"), (7.0, 8.0, "void k1<int>(B)"),
              (9.5, 12.0, "k3"), (11.0, 12.0, "late")]
    s = trace.summarize(device, host)
    assert s["window_s"] == 10.0
    # the window's annotation is no operation; "late" began after it
    assert s["device_ops"] == 4
    assert s["busy_s"] == pytest.approx(2.8 + 1.0 + 0.5)
    assert s["by_name"]["k1<int>"] == pytest.approx(2.8)
    assert s["by_name"]["k3"] == pytest.approx(0.5)  # clipped
    # idle: [0, 1.2) in the launch, [4, 7) in no host event, [8, 9.5) in
    # the synchronize
    assert s["gaps"]["cudaGraphLaunch"] == pytest.approx(1.2)
    assert s["gaps"]["python"] == pytest.approx(3.0)
    assert s["gaps"]["cudaEventSynchronize"] == pytest.approx(1.5)


# -- what the harness refuses -----------------------------------------------


def _cmd(*args, env=None):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cmd in (["portbench.run", "--workload", "youtube-tdist.sync",
                 "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                ["portbench.calibrate", "--workload", "youtube-tdist.sync",
                 "--seeds", "1"]):
        p = _cmd(*cmd, env=env)
        assert p.returncode != 0
        assert p.stdout == ""


_LOADS = """
import sys, time
import torch
torch.set_num_threads(1)
from portbench import run, spec
import portbench.tests.test_portbench_harness as t
for name in {cells!r}:
    cell = t.small(name)
    out = run.run_cell(cell, 7, 0.2, False, "cpu", t.HostClock())
    assert out["correct"], out
for m in spec.load_cell({cells[0]!r}).per_layer:
    spec.reader(m["name"])
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    p = subprocess.run([sys.executable, "-c", _LOADS.format(cells=CELLS)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(p.stdout.split())
    assert "force2vec_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    paths = sorted((ROOT / "portbench/reference").rglob("*.py"))
    assert ROOT / "portbench/reference/models/tdist.py" in paths
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in (
                    "numpy", "torch", "__future__", "importlib",
                    "pathlib"), (path, name)


# -- the check -----------------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program(name):
    """The program's CPU path, driven through a whole run of the harness
    (set-up, window, check), passes the cell's check."""
    out = run.run_cell(small(name), SEED, 0.2, False, "cpu", HostClock())
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert not out["forbidden"]
    for c in out["checks"].values():
        assert c["value"] < 1e-4  # f32 sums in another order


@pytest.mark.parametrize("name", ["youtube-tdist.sync", "youtube-tdist.batch",
                                  "youtube-tdist.bs1"])
def test_control_fails(name):
    """The control, the program with X held in bfloat16 (the precision
    below the configuration's float32), fails the cell's limits."""
    cell = small(name)
    edges, runner, x, x0, program, _ = run.set_up(cell, SEED, "cpu",
                                                  "bfloat16")
    del x, runner
    per_iter = run.check_run(cell, edges, x0, program, SEED, "cpu")
    correct, failed, _ = check.judge(per_iter, cell.limits)
    assert not correct and failed == check.CHECKED


def _unchanged(monkeypatch, runner):
    monkeypatch.setattr(runner, "run_span", lambda x, *a: x)


def _altered(monkeypatch, runner):
    """One element of X altered where the iteration produces it."""
    step = runner.run_span

    def run_span(x, *a):
        step(x, *a)
        x[1, 0] += 1e-2
        return x
    monkeypatch.setattr(runner, "run_span", run_span)


def _half(monkeypatch, runner):
    """Half of the rows' attraction left out, the rest doubled."""
    from force2vec_tpu_torch.ops import force_kernels
    from force2vec_tpu_torch.train import trainer

    def halve(f):
        def wrapped(*a, **k):
            out = f(*a, **k)
            out[::2] = 0
            out[1::2] *= 2
            return out
        return wrapped
    monkeypatch.setattr(force_kernels, "ell_edge_force_table",
                        halve(force_kernels.ell_edge_force_table))
    monkeypatch.setattr(trainer, "segment_sum_into_batch",
                        halve(trainer.segment_sum_into_batch))


# A one-chip cell exchanges nothing between chips, so that fault has no
# place here.
FAULTS = {"unchanged": _unchanged, "altered": _altered, "half": _half}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", ["youtube-tdist.sync", "youtube-tdist.batch",
                                  "youtube-tdist.bs1"])
def test_planted_fault_fails(monkeypatch, name, fault):
    """A whole run of the harness, the cell's search for a card skipped,
    with the timed path broken underneath: ``correct`` comes out false."""
    build = run.build_runner

    def broken(*a, **k):
        runner = build(*a, **k)
        FAULTS[fault](monkeypatch, runner)
        return runner
    monkeypatch.setattr(run, "build_runner", broken)
    out = run.run_cell(small(name), SEED, 0.2, False, "cpu", HostClock())
    assert not out["correct"] and out["failed"] > 0, out["checks"]


# the faults ``calibrate.py`` plants in the program's place, each with the
# cells whose small graph has that layer (the small youtube graph has no
# row past the hub width 256)
_REFERENCE_FAULTS = [
    (name, fault) for name in CELLS
    for fault in calibrate.FAULTS[small(name).traffic["schedule"]]
    if not (fault == "no_hubs" and name.startswith("youtube"))]


@pytest.mark.parametrize("name,fault", _REFERENCE_FAULTS)
def test_reference_fault_fails(name, fault):
    """The reference with a layer broken (``calibrate.FAULTS``: the
    repulsion left out or halved, the hub rows' attraction or the
    replica's rounding left out), put in the program's place, fails the
    cell's limits."""
    cell = small(name)
    edges = graphgen.edges(cell.config["graph"], SEED)
    x0 = run.make_x0("tdist", cell.config["graph"]["vertices"],
                     cell.config["dim"], SEED, "cpu")
    per_iter = calibrate.fault_readings(cell, edges, x0, SEED, "cpu")[fault]
    correct, failed, _ = check.judge(per_iter, cell.limits)
    assert not correct and failed > 0


# -- the reference's own graph and model ------------------------------------


def test_reference_csr_by_hand():
    """The benchmark lays out its own CSR for the reference; the program's
    ``Graph.from_coo`` of the same edges agrees with it."""
    src, dst = np.array([0, 0, 1, 3]), np.array([3, 1, 2, 4])
    rowptr, colids = graphgen.csr(src, dst, 6)
    assert rowptr.tolist() == [0, 2, 4, 5, 7, 8, 8]
    assert colids.tolist() == [1, 3, 0, 2, 1, 0, 4, 3]
    shape = dict(json.loads(
        (ROOT / "portbench/configs/flickr-tdist.json").read_text())["graph"],
        vertices=3000, edges=20000)
    edges = graphgen.edges(shape, SEED)
    rowptr, colids = graphgen.csr(*edges, 3000)
    g = run.program_graph(*edges, n=3000)
    assert np.array_equal(np.asarray(g.rowptr), rowptr)
    assert np.array_equal(np.asarray(g.colids), colids)


def test_a_model_without_a_reference_is_refused():
    """A configuration whose model the reference does not implement is
    refused by the reference, the init and the operation count, not judged
    by another model's forces."""
    from portbench.reference import force2vec

    cell = small("youtube-tdist.sync")
    cfg = dict(cell.config, model="fr")
    rowptr, colids = graphgen.csr(np.array([0]), np.array([1]), 2)
    with pytest.raises(KeyError, match="fr"):
        force2vec.build(rowptr, colids, cfg, cell.traffic, "cpu")
    with pytest.raises(KeyError, match="fr"):
        run.make_x0("fr", 10, 8, SEED, "cpu")
    with pytest.raises(KeyError, match="fr"):
        work.flops_per_iter("fr", 10, 20, 8, 5)
    # X held in two bytes: the tdist reference follows float32 only
    with pytest.raises(NotImplementedError, match="bfloat16"):
        force2vec.build(rowptr, colids, cell.config,
                        dict(cell.traffic, x_dtype="bfloat16"), "cpu")


def test_a_model_added_as_a_file_is_found(tmp_path, monkeypatch):
    """A model's reference is a file of ``reference/models/``: its init,
    default step and operation counts are read from it, and a module that
    defines its own ``Reference`` (another update rule) gets it used."""
    from portbench.reference import force2vec

    models = tmp_path / "models"
    models.mkdir()
    tdist = (ROOT / "portbench/reference/models/tdist.py").read_text()
    (models / "tdist.py").write_text(tdist)
    (models / "half.py").write_text(
        tdist.replace("DEFAULT_LR = 0.02", "DEFAULT_LR = 0.01")
        + "\n\ndef edge_ops(dim):\n    return 7\n\n\n"
        "from portbench.reference import force2vec\n\n\n"
        "class Reference(force2vec.Reference):\n    own = True\n")
    monkeypatch.setattr(force2vec, "_MODEL_DIR", models)
    monkeypatch.setattr(force2vec, "_MODELS", {})
    cell = small("youtube-tdist.sync")
    rowptr, colids = graphgen.csr(np.array([0]), np.array([1]), 2)
    ref = force2vec.build(rowptr, colids, dict(cell.config, model="half"),
                          cell.traffic, "cpu")
    assert ref.own and ref.step == pytest.approx(0.01)
    assert work.flops_per_iter("half", 1, 1, 8, 0) == 7 + 8
    assert not hasattr(force2vec.build(rowptr, colids, cell.config,
                                       cell.traffic, "cpu"), "own")


def test_x_dtype_read_from_the_traffic():
    """X's element type is the traffic's ``x_dtype`` (float32 where it
    names none)."""
    cell = small("youtube-tdist.sync")
    edges = graphgen.edges(cell.config["graph"], SEED)
    g = run.program_graph(*edges, n=cell.config["graph"]["vertices"])
    x0 = run.make_x0("tdist", g.n, cell.config["dim"], SEED, "cpu")
    for traffic, dtype in ((cell.traffic, torch.float32),
                           (dict(cell.traffic, x_dtype="bfloat16"),
                            torch.bfloat16)):
        runner = run.build_runner(
            g, dataclasses.replace(cell, traffic=traffic), "cpu")
        assert runner.pad_embedding(x0).dtype == dtype
