"""The port's sync iteration against the JAX package's, on injected X,
negatives and walks: with the JAX Pallas kernels in interpret mode and with
its jnp path, f32 and bf16 gathers, over a layout with a hub bucket; group-
shared and per-vertex (-bs 1) negatives, and the rwalk walk engine."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from force2vec_tpu.graphs.csr import Graph as JaxGraph
from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
from force2vec_tpu.train.trainer import TrainConfig as JaxConfig
from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.convert import embedding_from_jax, embedding_to_numpy
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.train.sync import build_walk_tables

DIM, NS, BS = 16, 4, 8
ITERS = 3
LAYOUT = dict(min_width=4, hub_width=8)


@pytest.fixture(scope="module")
def graph():
    return synth_powerlaw_graph(n=400, avg_deg=6, seed=3)


def _jax_graph(g):
    return JaxGraph(g.n, g.rowptr, g.colids)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("gather_dtype,tol", [(None, 1e-5),
                                              ("bfloat16", 6e-3)])
def test_iterations_match_jax(graph, pallas, gather_dtype, tol):
    kw = dict(dim=DIM, batch_size=BS, model="tdist", ns=NS,
              gather_dtype=gather_dtype)
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            jfv = JaxSync(_jax_graph(graph), JaxConfig(**kw), use_pallas=True,
                          **LAYOUT)
    else:
        jfv = JaxSync(_jax_graph(graph), JaxConfig(**kw), use_pallas=False,
                      **LAYOUT)
    tfv = SyncForce2Vec(graph, TrainConfig(**kw), device="cpu", **LAYOUT)
    assert tfv.layout.buckets[-1].owners is not None  # a hub bucket runs
    assert tfv.layout.n_pad == jfv.layout.n_pad

    rng = np.random.default_rng(17)
    x0 = (rng.random((graph.n, DIM)) * 2 - 1).astype(np.float32)
    xj = jfv.pad_embedding(x0)
    xt = embedding_from_jax(np.asarray(xj), "cpu")
    ng = -(-jfv.layout.n_pad // BS)
    for _ in range(ITERS):
        negs = rng.integers(0, graph.n - 1, size=(ng, NS)).astype(np.int32)
        if pallas:
            with pltpu.force_tpu_interpret_mode():
                xj = jfv.run_iteration(xj, negs)
        else:
            xj = jfv.run_iteration(xj, negs)
        out = tfv.run_iteration(xt, negs)
        assert out is xt  # updated in place
        np.testing.assert_allclose(embedding_to_numpy(xt), np.asarray(xj),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(tfv.unpad_embedding(xt).numpy(),
                               jfv.unpad_embedding(xj), rtol=tol, atol=tol)


@pytest.mark.parametrize("model", ["sigmoid", "fr", "linlog", "forceatlas"])
def test_other_models_match_jax(graph, model):
    """Dot-product attraction (sigmoid), and the energy apply with a
    decayed step (the layout family), against the jnp path."""
    kw = dict(dim=DIM, batch_size=BS, model=model, ns=NS)
    jfv = JaxSync(_jax_graph(graph), JaxConfig(**kw), use_pallas=False,
                  **LAYOUT)
    tfv = SyncForce2Vec(graph, TrainConfig(**kw), device="cpu", **LAYOUT)
    rng = np.random.default_rng(5)
    x0 = rng.random((graph.n, DIM)).astype(np.float32)
    xj = jfv.pad_embedding(x0)
    xt = tfv.pad_embedding(x0)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    ng = -(-jfv.layout.n_pad // BS)
    for it in range(2):
        negs = rng.integers(0, graph.n - 1, size=(ng, NS)).astype(np.int32)
        step = tfv._step(it)
        xj = jfv.run_iteration(xj, negs, step=step)
        tfv.run_iteration(xt, negs, step=step)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)


def test_plain_iteration_equals_wrapper_iteration_on_cpu(graph):
    cfg = TrainConfig(dim=DIM, batch_size=BS, ns=NS, gather_dtype="bfloat16")
    fv = SyncForce2Vec(graph, cfg, device="cpu", **LAYOUT)
    x0 = fv.init_embedding(seed=2)
    negs = np.random.default_rng(0).integers(
        0, graph.n - 1, size=(-(-fv.layout.n_pad // BS), NS))
    a = fv.run_iteration(x0.clone(), negs)
    b = fv.run_iteration(x0.clone(), negs, plain=True)
    torch.testing.assert_close(a, b)
    with pytest.raises(ValueError):
        fv.run_iteration(x0.clone(), negs[:-1])


def test_train_pulls_edges_together():
    g = synth_powerlaw_graph(n=1024, avg_deg=8, seed=1)
    cfg = TrainConfig(dim=DIM, batch_size=64, ns=5, gather_dtype="bfloat16")
    fv = SyncForce2Vec(g, cfg, min_width=8, hub_width=32, device="cpu")
    emb = fv.train(iters=60, seed=1)
    assert emb.shape == (g.n, DIM)
    assert torch.isfinite(emb).all()
    src = torch.repeat_interleave(torch.arange(g.n),
                                  torch.from_numpy(g.degrees))
    dst = torch.from_numpy(g.colids).long()
    d_edge = (emb[src] - emb[dst]).norm(dim=1).mean()
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, g.n, 4000)) for _ in range(2))
    d_rand = (emb[a] - emb[b]).norm(dim=1).mean()
    assert d_rand - d_edge > 0.3
    # the same seed gives the same run
    torch.testing.assert_close(fv.train(iters=60, seed=1), emb)


def _jax_sync(graph, kw, pallas):
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            return JaxSync(_jax_graph(graph), JaxConfig(**kw), use_pallas=True,
                           **LAYOUT)
    return JaxSync(_jax_graph(graph), JaxConfig(**kw), use_pallas=False,
                   **LAYOUT)


def _jax_iteration(jfv, pallas, *args, **kw):
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            return jfv.run_iteration(*args, **kw)
    return jfv.run_iteration(*args, **kw)


def _start_x(jfv, graph, rng, symmetric):
    """A padded X with random padding rows too (both packages update
    them), as numpy."""
    x = np.asarray(jfv.pad_embedding(
        rng.random((graph.n, DIM)).astype(np.float32))).copy()
    x[graph.n:] = rng.random((x.shape[0] - graph.n, DIM))
    return x * 2 - 1 if symmetric else x


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("gather_dtype,tol", [(None, 1e-5),
                                              ("bfloat16", 6e-3)])
@pytest.mark.parametrize("model", ["tdist", "sigmoid", "fr"])
def test_per_vertex_iterations_match_jax(graph, model, pallas, gather_dtype,
                                         tol):
    """-bs 1: [n_pad, ns] negatives, one set per row (JAX: ell_force with
    kind 'sample' in interpret mode, or its jnp chain)."""
    kw = dict(dim=DIM, batch_size=BS, model=model, ns=NS,
              gather_dtype=gather_dtype, per_vertex_samples=True)
    jfv = _jax_sync(graph, kw, pallas)
    tfv = SyncForce2Vec(graph, TrainConfig(**kw), device="cpu", **LAYOUT)
    rng = np.random.default_rng(23)
    x0 = _start_x(jfv, graph, rng, symmetric=tfv.model.init == "symmetric")
    xj, xt = jnp.asarray(x0), embedding_from_jax(x0, "cpu")
    for it in range(ITERS):
        negs = rng.integers(0, graph.n - 1,
                            size=(tfv.layout.n_pad, NS)).astype(np.int32)
        step = tfv._step(it)
        xj = _jax_iteration(jfv, pallas, xj, negs, step=step)
        assert tfv.run_iteration(xt, negs, step=step) is xt
        np.testing.assert_allclose(embedding_to_numpy(xt), np.asarray(xj),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("gather_dtype,tol", [(None, 1e-5),
                                              ("bfloat16", 6e-3)])
def test_rwalk_iterations_match_jax(graph, pallas, gather_dtype, tol):
    """rwalk: injected walks (drawn by the port's engine) and group-shared
    negatives (JAX: ell_force_mxu and grouped_rep_force in interpret mode,
    or its jnp chain)."""
    kw = dict(dim=DIM, batch_size=BS, model="rwalk", ns=NS,
              gather_dtype=gather_dtype)
    jfv = _jax_sync(graph, kw, pallas)
    tfv = SyncForce2Vec(graph, TrainConfig(**kw), device="cpu", **LAYOUT)
    rng = np.random.default_rng(29)
    gen = torch.Generator().manual_seed(29)
    x0 = _start_x(jfv, graph, rng, symmetric=False)
    xj, xt = jnp.asarray(x0), embedding_from_jax(x0, "cpu")
    ng = -(-tfv.layout.n_pad // BS)
    for _ in range(ITERS):
        negs = rng.integers(0, graph.n - 1, size=(ng, NS)).astype(np.int32)
        walks = tfv.draw_walks(gen).numpy()
        xj = _jax_iteration(jfv, pallas, xj, negs, walks=walks)
        tfv.run_iteration(xt, negs, walks=walks)
        np.testing.assert_allclose(embedding_to_numpy(xt), np.asarray(xj),
                                   rtol=tol, atol=tol)


def test_walk_tables_match_jax(graph):
    from force2vec_tpu.train.sync import _build_walk_tables

    kw = dict(dim=DIM, batch_size=BS, model="rwalk", ns=NS)
    jfv = JaxSync(_jax_graph(graph), JaxConfig(**kw), use_pallas=False,
                  **LAYOUT)
    tfv = SyncForce2Vec(graph, TrainConfig(**kw), device="cpu", **LAYOUT)
    assert tfv.layout.buckets[-1].owners is not None  # hub rows linearize
    pool, base = build_walk_tables(tfv.layout)
    jpool, jbase = _build_walk_tables(jfv.layout)
    assert pool.dtype == base.dtype == np.int32
    np.testing.assert_array_equal(pool, jpool)
    np.testing.assert_array_equal(base, jbase)
    np.testing.assert_array_equal(tfv.walk_pool.numpy(),
                                  np.asarray(jfv._garr["walk_pool"]))
    np.testing.assert_array_equal(tfv.walk_db.numpy(),
                                  np.asarray(jfv._garr["walk_db"]))


def test_walks_land_on_neighbours(graph):
    """Every step of the port's walk engine lands on a neighbour of the
    previous position, or stays put on a row of degree 0 (the JAX test
    tests/test_sync.py::test_ell_walks_land_on_neighbors, vectorized); the
    RNGs differ, so validity is compared, not values."""
    wl = 6
    fv = SyncForce2Vec(graph, TrainConfig(dim=DIM, model="rwalk", ns=NS,
                                          walk_length=wl),
                       device="cpu", **LAYOUT)
    lay = fv.layout
    gen = torch.Generator().manual_seed(3)
    walks = fv.draw_walks(gen).numpy()
    assert walks.shape == (lay.n_pad, wl) and walks.dtype == np.int32
    src = lay.inv_perm[np.repeat(np.arange(graph.n), graph.degrees)]
    keys = np.unique(src.astype(np.int64) * lay.n_pad
                     + lay.inv_perm[graph.colids])
    cur = np.arange(lay.n_pad)
    for step in range(wl):
        nxt = walks[:, step]
        moves = lay.deg[cur] > 0
        np.testing.assert_array_equal(nxt[~moves], cur[~moves])
        k = cur[moves].astype(np.int64) * lay.n_pad + nxt[moves]
        pos = np.minimum(np.searchsorted(keys, k), keys.size - 1)
        assert (keys[pos] == k).all(), f"step {step} left the graph"
        cur = nxt
    # the widest hub row reaches slots past its first virtual row
    hub = int(np.argmax(lay.deg))
    assert lay.deg[hub] > 2 * LAYOUT["hub_width"]
    firsts = {int(fv.draw_walks(gen)[hub, 0]) for _ in range(40)}
    hub_nbrs = set(keys[(keys // lay.n_pad) == hub] % lay.n_pad)
    assert firsts <= hub_nbrs and len(firsts) > LAYOUT["hub_width"]


@pytest.mark.parametrize("kw", [dict(per_vertex_samples=True),
                                dict(model="rwalk")], ids=["bs1", "rwalk"])
def test_new_paths_train_finite_and_deterministic(kw):
    g = synth_powerlaw_graph(n=1024, avg_deg=8, seed=1)
    cfg = TrainConfig(dim=DIM, batch_size=64, ns=5, gather_dtype="bfloat16",
                      **kw)
    fv = SyncForce2Vec(g, cfg, min_width=8, hub_width=32, device="cpu")
    emb = fv.train(iters=40, seed=1)
    assert emb.shape == (g.n, DIM)
    assert torch.isfinite(emb).all()
    torch.testing.assert_close(fv.train(iters=40, seed=1), emb, rtol=0,
                               atol=0)
    assert not torch.equal(fv.train(iters=40, seed=2), emb)


def test_unported_options_raise(graph):
    with pytest.raises(ValueError):
        SyncForce2Vec(graph, TrainConfig(dim=DIM, model="tdist_exact"),
                      device="cpu")
    with pytest.raises(NotImplementedError):
        SyncForce2Vec(graph, TrainConfig(dim=DIM, model="sigmoid",
                                         sm_table=True), device="cpu")
    # wrong-shaped negatives or walks, and walks where the model takes none
    kw = dict(dim=DIM, batch_size=BS, ns=NS)
    pv = SyncForce2Vec(graph, TrainConfig(per_vertex_samples=True, **kw),
                       device="cpu", **LAYOUT)
    rw = SyncForce2Vec(graph, TrainConfig(model="rwalk", **kw), device="cpu",
                       **LAYOUT)
    n_pad, ng = pv.layout.n_pad, -(-pv.layout.n_pad // BS)
    x = pv.init_embedding()
    grouped = np.zeros((ng, NS), np.int32)
    per_row = np.zeros((n_pad, NS), np.int32)
    walks = np.zeros((n_pad, rw.config.walk_length), np.int32)
    for fv, negs, w in ((pv, grouped, None), (pv, per_row[:, :-1], None),
                        (pv, per_row, walks), (rw, per_row, walks),
                        (rw, grouped, None), (rw, grouped, walks[:-1]),
                        (rw, grouped, walks[:, :-1])):
        with pytest.raises(ValueError):
            fv.run_iteration(x.clone(), negs, walks=w)
    pv.run_iteration(x.clone(), per_row)
    rw.run_iteration(x.clone(), grouped, walks=walks)


def test_package_imports_no_jax():
    """Every module of the port, found by walking the package, and
    chip_smoke.py import neither JAX nor the JAX package, nor, at import
    time, scikit-learn or matplotlib (which the card's host lacks)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import force2vec_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                              pkg.__name__ + '.')]\n"
        "for name in mods + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "want = ['ops.probe_kernels', 'tools.probes', 'graphs.io',\n"
        "        'graphs.native', 'graphs.tools', 'native', 'eval',\n"
        "        'eval._fit', 'eval.linkpred', 'eval.nodeclass',\n"
        "        'eval.clustering', 'eval.reconstruction', 'eval.visualize']\n"
        "missing = [w for w in want if 'force2vec_tpu_torch.' + w not in mods]\n"
        "assert not missing, (missing, mods)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'force2vec_tpu',\n"
        "                              'sklearn', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
