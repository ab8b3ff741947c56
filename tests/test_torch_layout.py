"""The port's host layout equals the JAX package's, array for array."""

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


def test_hot_split_is_not_ported():
    g = synth_powerlaw_graph(n=512)
    with pytest.raises(NotImplementedError):
        SyncLayout.build(g, hot_rows=64)
