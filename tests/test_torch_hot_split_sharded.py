"""The hot/cold gather split under dp × tp on gloo ranks: at (dp, tp) =
(2, 1) and (2, 2), one split iteration on injected per-vertex negatives
equals the single-rank unsplit iteration, and with group-shared negatives
the single-rank split iteration (rtol 1e-5, atol 1e-6, the bound of the
JAX package's tests/test_sharded.py split test).  Each rank takes its 1/dp
of every bucket's cold and hot rows; at tp = 2 the cold, hot and repulsion
tables go into the one partial launch and the one all_reduce.  The ranks
import no JAX."""

import numpy as np
import pytest

from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.graphs import Graph
from force2vec_tpu_torch.ops import force_kernels
from force2vec_tpu_torch.train.sync import SyncForce2Vec
from force2vec_tpu_torch.train.trainer import TrainConfig

DIM, NS, BATCH, HOT = 16, 4, 16, 300
LAYOUT = dict(min_width=4, hub_width=16)
TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = [(2, 1), (2, 2)]
KINDS = ["per_vertex", "grouped"]


def _graph():
    """tests/test_sharded.py's ring-plus-chords graph."""
    rng = np.random.default_rng(17)
    n, extra = 1500, 900
    src = np.arange(n)
    dst = (src + 1) % n
    es, ed = rng.integers(0, n, size=extra), rng.integers(0, n, size=extra)
    keep = es != ed
    return Graph.from_coo(np.concatenate([src, dst, es[keep], ed[keep]]),
                          np.concatenate([dst, src, ed[keep], es[keep]]),
                          None, n=n)


def _config(kind):
    return TrainConfig(dim=DIM, batch_size=BATCH, model="tdist", ns=NS,
                       per_vertex_samples=kind == "per_vertex")


def _draws():
    """X, and per kind one iteration's negatives in original id space."""
    n = _graph().n
    rng = np.random.default_rng(5)
    x = rng.random((n, DIM)).astype(np.float32)
    return x, {"per_vertex": rng.integers(0, n - 1, size=(n, NS)),
               "grouped": rng.integers(0, n - 1,
                                       size=(-(-n // BATCH) + 1, NS))}


def _relabeled(negs, lay, kind):
    if kind == "per_vertex":
        out = np.zeros((lay.n_pad, NS), np.int32)
        out[: lay.n] = lay.inv_perm[negs[lay.perm]]
        return out
    return lay.inv_perm[negs[: -(-lay.n_pad // BATCH)]].astype(np.int32)


def _one_iteration(fv, x_host, negs, kind):
    x = fv.pad_embedding(x_host)
    fv.run_iteration(x, _relabeled(negs, fv.layout, kind))
    return fv.unpad_embedding(x).numpy()


def _ranks(rank, world, tp, x_host, draws):
    """Each kind's split iteration at (world // tp, tp), with the tp
    all_reduces it made."""
    spmd = multihost.pod_mesh(tp)
    out = {}
    for kind in KINDS:
        fv = SyncForce2Vec(_graph(), _config(kind), spmd=spmd, hot_rows=HOT,
                           device="cpu", **LAYOUT)
        assert fv.hot_table is not None
        before = force_kernels.launch_counts["tp_all_reduce"]
        out[kind] = (_one_iteration(fv, x_host, draws[kind], kind),
                     force_kernels.launch_counts["tp_all_reduce"] - before)
    return out


@pytest.fixture(scope="module")
def inputs():
    return _draws()


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's results at (2, 1) (2 ranks) and (2, 2) (4 ranks)."""
    x, draws = inputs
    return {(world // tp, tp): multihost.spawn(
                _ranks, world, "gloo", args=(tp, x, draws), timeout=240,
                threads=1)[0]
            for world, tp in ((2, 1), (4, 2))}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_split_matches_single_rank(port, inputs, dp, tp, kind):
    """Per-vertex negatives: equal to the unsplit single-rank iteration;
    group-shared ones (whose groups follow the row order, which the split
    changes) to the split single-rank iteration."""
    x_host, draws = inputs
    got, all_reduces = port[(dp, tp)][kind]
    single = SyncForce2Vec(_graph(), _config(kind), device="cpu",
                           hot_rows=0 if kind == "per_vertex" else HOT,
                           **LAYOUT)
    want = _one_iteration(single, x_host, draws[kind], kind)
    np.testing.assert_allclose(got, want, **TOL)
    assert all_reduces == (1 if tp > 1 else 0)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_split_layout_is_dp_aligned(dp, tp):
    """The ranks' layout is the JAX sharded runner's: span rectangles
    aligned to lcm(8, dp) rows; and each rank's hot table writes only rows
    its cold table writes."""
    from force2vec_tpu_torch.dist.spmd import SpmdAxes

    for d in range(dp):
        fv = SyncForce2Vec(_graph(), _config("grouped"), hot_rows=HOT,
                           spmd=SpmdAxes(n_dp=dp, dp_index=d), device="cpu",
                           **LAYOUT)
        spans = [sp for b in fv.layout.buckets if b.hot_spans
                 for sp in b.hot_spans]
        assert spans and all(sp.rows_pad % 8 == 0 for sp in spans)
        assert fv.edge_table.out_rows == fv.hot_table.out_rows
        assert not fv.edge_table.partial
