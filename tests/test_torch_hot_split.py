"""The hot/cold gather split (``SyncForce2Vec(hot_rows=k)``): one split
iteration against the JAX package's split iteration (its jnp path and its
Pallas kernels in interpret mode), with group-shared and per-vertex
negatives injected in original id space and mapped through each runner's
``perm``; against the port's own unsplit iteration; the edge kernel's
accumulating plain version; ``split_stats``; the walk models' refusal;
and the default, no split."""

import _jax_inline_dispatch  # noqa: F401  (first: before any JAX client)
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from force2vec_tpu.graphs.csr import Graph as JaxGraph
from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
from force2vec_tpu.train.trainer import TrainConfig as JaxConfig
from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.graphs import Graph, synth_powerlaw_graph
from force2vec_tpu_torch.ops import force_kernels as fk

DIM, NS, BS, HOT = 16, 4, 64, 300
# the layout of tests/test_sync.py's split test
LAYOUT = dict(min_width=4, hub_width=16, row_align=4)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
PALLAS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def graph():
    """The ring-plus-chords graph of tests/test_sync.py's split test."""
    rng = np.random.default_rng(21)
    n, extra = 1500, 900
    src = np.arange(n)
    dst = (src + 1) % n
    es, ed = rng.integers(0, n, size=extra), rng.integers(0, n, size=extra)
    keep = es != ed
    rows = np.concatenate([src, dst, es[keep], ed[keep]])
    cols = np.concatenate([dst, src, ed[keep], es[keep]])
    g = JaxGraph.from_coo(rows, cols, None, n=n)
    return Graph(g.n, g.rowptr, g.colids)


@pytest.fixture(scope="module")
def draws(graph):
    """X and, per negative kind, two iterations' negatives in original id
    space: [n, ns] per vertex, or [ng, ns] ids per group."""
    rng = np.random.default_rng(7)
    x = rng.random((graph.n, DIM)).astype(np.float32)
    ng = -(-graph.n // BS) + 1
    return x, {
        "per_vertex": [rng.integers(0, graph.n - 1, size=(graph.n, NS))
                       for _ in range(2)],
        "grouped": [rng.integers(0, graph.n - 1, size=(ng, NS))
                    for _ in range(2)],
    }


def _config(kind, cls=TrainConfig, **kw):
    return cls(dim=DIM, batch_size=BS, model="tdist", ns=NS,
               per_vertex_samples=kind == "per_vertex", **kw)


def _relabeled(negs, lay, kind):
    """Original-id negatives as a runner with layout ``lay`` takes them:
    per-vertex rows moved to their relabeled rows, every id relabeled."""
    if kind == "per_vertex":
        out = np.zeros((lay.n_pad, NS), np.int32)
        out[: lay.n] = lay.inv_perm[negs[lay.perm]]
        return out
    return lay.inv_perm[negs[: -(-lay.n_pad // BS)]].astype(np.int32)


def _port_iterations(fv, x_host, negs_list, kind):
    x = fv.pad_embedding(x_host)
    for negs in negs_list:
        fv.run_iteration(x, _relabeled(negs, fv.layout, kind))
    return fv.unpad_embedding(x).numpy()


def _jax_iterations(jfv, x_host, negs_list, kind, pallas):
    x = jfv.pad_embedding(x_host)
    for negs in negs_list:
        negs = jnp.asarray(_relabeled(negs, jfv.layout, kind))
        if pallas:
            with pltpu.force_tpu_interpret_mode():
                x = jfv.run_iteration(x, negs)
        else:
            x = jfv.run_iteration(x, negs)
    return jfv.unpad_embedding(x)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("kind", ["grouped", "per_vertex"])
def test_split_iterations_match_jax(graph, draws, kind, pallas):
    x_host, negs = draws
    jg = JaxGraph(graph.n, graph.rowptr, graph.colids)
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            jfv = JaxSync(jg, _config(kind, JaxConfig), use_pallas=True,
                          hot_rows=HOT, **LAYOUT)
    else:
        jfv = JaxSync(jg, _config(kind, JaxConfig), use_pallas=False,
                      hot_rows=HOT, **LAYOUT)
    tfv = SyncForce2Vec(graph, _config(kind), hot_rows=HOT, device="cpu",
                        **LAYOUT)
    assert tfv.layout.hot_start == jfv.layout.hot_start == graph.n - HOT
    np.testing.assert_array_equal(tfv.layout.perm, jfv.layout.perm)
    assert tfv.hot_table is not None
    got = _port_iterations(tfv, x_host, negs[kind], kind)
    want = _jax_iterations(jfv, x_host, negs[kind], kind, pallas)
    np.testing.assert_allclose(got, want, **(PALLAS_TOL if pallas
                                             else JAX_TOL))


@pytest.mark.parametrize("hot_rows", [1, 37, HOT, 1200])
def test_split_iteration_matches_unsplit(graph, draws, hot_rows):
    """The split partitions each row's neighbours: one iteration equals the
    unsplit layout's, whose relabeling differs (per-vertex negatives, as
    group-shared ones depend on the row order)."""
    x_host, negs = draws
    kind = "per_vertex"
    plain = SyncForce2Vec(graph, _config(kind), hot_rows=0, device="cpu",
                          **LAYOUT)
    split = SyncForce2Vec(graph, _config(kind), hot_rows=hot_rows,
                          device="cpu", **LAYOUT)
    assert plain.hot_table is None and split.hot_table is not None
    assert not np.array_equal(plain.layout.perm, split.layout.perm)
    np.testing.assert_allclose(
        _port_iterations(split, x_host, negs[kind], kind),
        _port_iterations(plain, x_host, negs[kind], kind), **JAX_TOL)


def test_split_tables_cover_every_slot(graph):
    """The cold table (``edge_table``) and the hot table hold each real
    neighbour slot of the layout once, the hot ids in the suffix; the cold
    table writes every update row, the hot one only rows with hot slots."""
    fv = SyncForce2Vec(graph, _config("grouped"), hot_rows=HOT,
                       device="cpu", **LAYOUT)
    lay, hot_start = fv.layout, fv.layout.hot_start
    cold_slots = sum(int(d.sum()) for _, d, _, _ in fv.edge_table.parts())
    hot_slots = sum(int(d.sum()) for _, d, _, _ in fv.hot_table.parts())
    assert cold_slots + hot_slots == graph.nnz
    assert hot_slots == sum(int(b.hot_deg.sum()) for b in lay.buckets
                            if b.hot_deg is not None)
    assert fv.hot_table.partial and not fv.edge_table.partial
    for nbr, deg, _, _ in fv.hot_table.parts():
        assert bool((deg > 0).all())
        real = nbr[fk._slot_mask(nbr, deg)[:, :, 0]]
        assert bool(((real >= hot_start) & (real < lay.n)).all())
    assert len(fv.edge_table.entries) + len(fv.hot_table.entries) <= 2 * 64


@pytest.mark.parametrize("gather", [torch.float32, torch.bfloat16])
def test_accumulate_plain_equals_add(graph, gather):
    """``ell_edge_force_table_plain(accumulate=True)`` (and the wrapper on
    CPU tensors) equals ``out.add_`` of its stored result, bit for bit, in
    the table's rows, and leaves the other rows."""
    fv = SyncForce2Vec(graph, _config("grouped"), hot_rows=HOT,
                       device="cpu", **LAYOUT)
    t = fv.hot_table
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((fv.layout.n_pad, fv.row_width), generator=gen)
    xg = x.to(gather)
    base = torch.randn((t.out_rows, fv.row_width), generator=gen)
    stored = fk.ell_edge_force_table_plain(fv.model, x, xg, t, fv.inv_deg,
                                           0.3, out=torch.zeros_like(base))
    rows = torch.zeros(t.out_rows, dtype=torch.bool)
    for nbr, _, _, ob in t.parts():
        rows[ob: ob + nbr.shape[0]] = True
    want = base.clone()
    want[rows] = want[rows].add_(stored[rows])
    for fn in (fk.ell_edge_force_table_plain, fk.ell_edge_force_table):
        got = fn(fv.model, x, xg, t, fv.inv_deg, 0.3, out=base.clone(),
                 accumulate=True)
        assert torch.equal(got, want)
        assert torch.equal(got[~rows], base[~rows])
    with pytest.raises(ValueError, match="need out"):
        fk.ell_edge_force_table(fv.model, x, xg, fv.edge_table, fv.inv_deg,
                                0.3, accumulate=True)
    with pytest.raises(ValueError, match="needs out"):
        fk.ell_edge_force_table_plain(fv.model, x, xg, fv.edge_table,
                                      fv.inv_deg, 0.3, accumulate=True)


@pytest.mark.parametrize("hot_rows", [0, 37, HOT])
def test_split_stats_match_jax(graph, hot_rows):
    jg = JaxGraph(graph.n, graph.rowptr, graph.colids)
    jfv = JaxSync(jg, _config("grouped", JaxConfig), use_pallas=False,
                  hot_rows=hot_rows, **LAYOUT)
    tfv = SyncForce2Vec(graph, _config("grouped"), hot_rows=hot_rows,
                        device="cpu", **LAYOUT)
    assert tfv.split_stats() == jfv.split_stats()


def test_walk_models_refuse_the_split(graph):
    cfg = TrainConfig(dim=DIM, batch_size=BS, model="rwalk", ns=NS)
    with pytest.raises(ValueError, match="hot_rows=0"):
        SyncForce2Vec(graph, cfg, hot_rows=HOT, device="cpu", **LAYOUT)
    fv = SyncForce2Vec(graph, cfg, device="cpu", **LAYOUT)
    assert fv.hot_rows == 0 and fv.layout.hot_start is None
    assert fv.split_stats()["hot_fraction"] == 0.0


def test_split_trains_finite_and_deterministic():
    g = synth_powerlaw_graph(n=1024, avg_deg=8, seed=1)
    cfg = TrainConfig(dim=DIM, batch_size=64, ns=5, gather_dtype="bfloat16")
    fv = SyncForce2Vec(g, cfg, min_width=8, hub_width=32, hot_rows=128,
                       device="cpu")
    assert fv.split_stats()["hot_fraction"] > 0.2
    emb = fv.train(iters=30, seed=1)
    assert emb.shape == (g.n, DIM) and torch.isfinite(emb).all()
    torch.testing.assert_close(fv.train(iters=30, seed=1), emb, rtol=0,
                               atol=0)


@pytest.mark.parametrize("model,gather_dtype", [
    ("tdist", None), ("tdist", "bfloat16"), ("sigmoid", None)])
def test_split_is_off_unless_asked(graph, model, gather_dtype):
    """The H100 measured the split slower at every replica size tried
    (PERF.md §9.6), so the trainer's default is the plain layout."""
    cfg = TrainConfig(dim=DIM, batch_size=BS, model=model, ns=NS,
                      gather_dtype=gather_dtype)
    fv = SyncForce2Vec(graph, cfg, device="cpu", **LAYOUT)
    assert fv.hot_rows == 0 and fv.hot_table is None
    assert fv.layout.hot_start is None
