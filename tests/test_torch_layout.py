"""The port's host layout equals the JAX package's, array for array."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from conftest import make_random_graph
from force2vec_tpu.graphs.csr import Graph as JaxGraph
from force2vec_tpu.graphs.csr import SyncLayout as JaxSyncLayout
from force2vec_tpu_torch.graphs import Graph, SyncLayout, synth_powerlaw_graph

ROOT = Path(__file__).resolve().parents[1]


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_port(g: JaxGraph) -> Graph:
    return Graph(g.n, g.rowptr, g.colids, g.values)


def _assert_layouts_equal(got, want):
    assert (got.n, got.n_pad, got.padded_edges) == (
        want.n, want.n_pad, want.padded_edges)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.inv_perm, want.inv_perm)
    np.testing.assert_array_equal(got.deg, want.deg)
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        assert (gb.width, gb.start, gb.count) == (wb.width, wb.start, wb.count)
        np.testing.assert_array_equal(gb.nbr, wb.nbr)
        np.testing.assert_array_equal(gb.deg, wb.deg)
        assert (gb.owners is None) == (wb.owners is None)
        if gb.owners is not None:
            np.testing.assert_array_equal(gb.owners, wb.owners)


def test_from_coo_matches_jax():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 40, 300)
    cols = rng.integers(0, 40, 300)
    vals = rng.random(300)
    for dup in (False, True):
        want = JaxGraph.from_coo(rows, cols, vals, n=40, sum_duplicates=dup)
        got = Graph.from_coo(rows, cols, vals, n=40, sum_duplicates=dup)
        np.testing.assert_array_equal(got.rowptr, want.rowptr)
        np.testing.assert_array_equal(got.colids, want.colids)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.nnz == want.nnz
        np.testing.assert_array_equal(got.degrees, want.degrees)


def test_synth_powerlaw_graph_matches_bench():
    want = _bench_module().synth_powerlaw_graph(n=4096)
    got = synth_powerlaw_graph(n=4096)
    assert got.n == want.n
    np.testing.assert_array_equal(got.rowptr, want.rowptr)
    np.testing.assert_array_equal(got.colids, want.colids)


@pytest.mark.parametrize("scheme", ["pow2", "mult8", "mult4"])
@pytest.mark.parametrize("min_width,hub_width", [(8, 128), (4, 8), (8, 256)])
def test_widths_for_matches_jax(scheme, min_width, hub_width):
    assert SyncLayout.widths_for(min_width, hub_width, scheme) == (
        JaxSyncLayout.widths_for(min_width, hub_width, scheme))


@pytest.mark.parametrize("graph_kind", ["random", "powerlaw"])
@pytest.mark.parametrize("scheme", ["pow2", "mult8"])
@pytest.mark.parametrize("min_width,hub_width,row_align",
                         [(4, 8, 8), (8, 128, 8), (4, 16, 4)])
def test_sync_layout_matches_jax(graph_kind, scheme, min_width, hub_width,
                                 row_align):
    if graph_kind == "random":
        jg = make_random_graph(60, 0.15, seed=9)
    else:
        jg = _bench_module().synth_powerlaw_graph(n=4096)
    widths = JaxSyncLayout.widths_for(min_width, hub_width, scheme)
    want = JaxSyncLayout.build(jg, min_width=min_width, hub_width=hub_width,
                               row_align=row_align, widths=widths)
    got = SyncLayout.build(_as_port(jg), min_width=min_width,
                           hub_width=hub_width, row_align=row_align,
                           widths=widths)
    _assert_layouts_equal(got, want)


def test_powerlaw_layout_has_hub_bucket_and_mult8_ladder():
    """The bench-shaped layout the slice runs: mult8 widths, a hub bucket."""
    g = synth_powerlaw_graph(n=4096)
    lay = SyncLayout.build(g, min_width=8, hub_width=128,
                           widths=SyncLayout.widths_for(8, 128, "mult8"))
    assert lay.buckets[-1].owners is not None
    assert all(b.width % 8 == 0 for b in lay.buckets)
    real = sum(int(b.deg.sum()) for b in lay.buckets)
    assert real == g.nnz


# the trial shapes of tests/test_sync.py's _split_hot test: (rows, width,
# hot_start)
SPLIT_TRIALS = [(1, 8, 4), (7, 8, 6), (64, 12, 40), (257, 16, 100),
                (800, 8, 700), (333, 24, 10)]


@pytest.mark.parametrize("span_align", [8, 16])
@pytest.mark.parametrize("trial", range(len(SPLIT_TRIALS)))
def test_split_hot_matches_jax(trial, span_align):
    """The port's ``_split_hot`` equals the JAX package's: the four flats
    and every ``HotSpan`` field."""
    from force2vec_tpu.graphs.csr import _split_hot as jax_split_hot
    from force2vec_tpu_torch.graphs.csr import _split_hot

    rows, w, hot_start = SPLIT_TRIALS[trial]
    rng = np.random.default_rng(5 + trial)
    n_ids = hot_start + max(rows // 2, 4)
    dg = rng.integers(0, w + 1, size=rows).astype(np.int32)
    if rows > 8:
        dg[-3:] = 0  # zero-degree padding rows at the end
    nbr = np.zeros((rows, w), dtype=np.int32)
    for r in range(rows):
        nbr[r, :dg[r]] = rng.integers(0, n_ids, size=dg[r])
    got = _split_hot(nbr, dg, w, hot_start, align=span_align)
    want = jax_split_hot(nbr, dg, w, hot_start, align=span_align)
    for g, wnt in zip(got[:4], want[:4]):
        assert g.dtype == wnt.dtype
        np.testing.assert_array_equal(g, wnt)
    assert [dataclasses.asdict(s) for s in got[4]] == [
        dataclasses.asdict(s) for s in want[4]]
    assert got[4], "every trial has at least one run"


def _ring_chords_graph():
    """The ring-plus-chords graph of tests/test_sync.py's split test."""
    rng = np.random.default_rng(21)
    n, extra = 1500, 900
    src = np.arange(n)
    dst = (src + 1) % n
    es, ed = rng.integers(0, n, size=extra), rng.integers(0, n, size=extra)
    keep = es != ed
    rows = np.concatenate([src, dst, es[keep], ed[keep]])
    cols = np.concatenate([dst, src, ed[keep], es[keep]])
    return JaxGraph.from_coo(rows, cols, None, n=n)


# (graph, layout keywords, hot_rows, span_align)
HOT_CASES = [
    ("powerlaw", dict(min_width=8, hub_width=128, scheme="mult8"), 64, 8),
    ("powerlaw", dict(min_width=8, hub_width=128, scheme="mult8"), 512, 8),
    ("powerlaw", dict(min_width=8, hub_width=128, scheme="mult8"), 2048, 16),
    ("powerlaw", dict(min_width=8, hub_width=256, scheme="pow2"), 1024, 8),
    ("powerlaw", dict(min_width=4, hub_width=16, scheme="mult8"), 4095, 8),
    ("ring", dict(min_width=4, hub_width=16, scheme="mult8", row_align=4),
     300, 8),
    ("ring", dict(min_width=4, hub_width=16, scheme="pow2"), 300, 16),
    ("ring", dict(min_width=4, hub_width=8, scheme="mult8"), 1, 8),
    ("ring", dict(min_width=4, hub_width=8, scheme="mult8"), 1200, 8),
]


@pytest.mark.parametrize("case", range(len(HOT_CASES)))
def test_hot_split_layout_matches_jax(case):
    """``SyncLayout.build(hot_rows=k, span_align=a)`` equals the JAX build:
    perm, inv_perm, n_pad, deg, hot_start, padded_edges and every
    bucket's arrays and spans."""
    kind, kw, hot_rows, span_align = HOT_CASES[case]
    jg = (_bench_module().synth_powerlaw_graph(n=4096) if kind == "powerlaw"
          else _ring_chords_graph())
    kw = dict(kw)
    widths = JaxSyncLayout.widths_for(kw["min_width"], kw["hub_width"],
                                      kw.pop("scheme"))
    args = dict(kw, widths=widths, hot_rows=hot_rows, span_align=span_align)
    want = JaxSyncLayout.build(jg, **args)
    got = SyncLayout.build(_as_port(jg), **args)
    assert want.hot_start == jg.n - hot_rows
    assert got.hot_start == want.hot_start
    _assert_layouts_equal(got, want)
    assert any(b.hot_spans for b in got.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        assert (gb.hot_spans is None) == (wb.hot_spans is None)
        if gb.hot_spans is None:
            continue
        np.testing.assert_array_equal(gb.hot_flat, wb.hot_flat)
        np.testing.assert_array_equal(gb.hot_deg, wb.hot_deg)
        assert [dataclasses.asdict(s) for s in gb.hot_spans] == [
            dataclasses.asdict(s) for s in wb.hot_spans]
    # the split partitions every neighbour multiset: all slots are kept
    real = sum(int(b.deg.sum()) + (0 if b.hot_deg is None
                                   else int(b.hot_deg.sum()))
               for b in got.buckets)
    assert real == jg.nnz


def test_hot_rows_off_or_whole_graph_is_unsplit():
    """hot_rows 0, or at least n, builds the plain layout (the JAX
    package's rule), and a span align off the 8-row block raises."""
    g = synth_powerlaw_graph(n=512)
    plain = SyncLayout.build(g)
    for k in (0, g.n, g.n + 5):
        lay = SyncLayout.build(g, hot_rows=k)
        assert lay.hot_start is None
        _assert_layouts_equal(lay, plain)
    with pytest.raises(ValueError, match="multiple of 8"):
        SyncLayout.build(g, hot_rows=64, span_align=12)
