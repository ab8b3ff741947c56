"""The port's sync iteration against the JAX package's, on injected X and
negatives: with the JAX Pallas kernels in interpret mode and with its jnp
path, f32 and bf16 gathers, over a layout with a hub bucket."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from force2vec_tpu.graphs.csr import Graph as JaxGraph
from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
from force2vec_tpu.train.trainer import TrainConfig as JaxConfig
from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.convert import embedding_from_jax, embedding_to_numpy
from force2vec_tpu_torch.graphs import synth_powerlaw_graph

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


def test_unported_options_raise(graph):
    with pytest.raises(NotImplementedError):
        SyncForce2Vec(graph, TrainConfig(dim=DIM, model="rwalk"), device="cpu")
    with pytest.raises(NotImplementedError):
        SyncForce2Vec(graph, TrainConfig(dim=DIM, per_vertex_samples=True),
                      device="cpu")
    with pytest.raises(ValueError):
        SyncForce2Vec(graph, TrainConfig(dim=DIM, model="tdist_exact"),
                      device="cpu")


def test_package_imports_no_jax():
    code = (
        "import sys\n"
        "import force2vec_tpu_torch\n"
        "import force2vec_tpu_torch.convert, force2vec_tpu_torch.graphs\n"
        "import force2vec_tpu_torch.ops.force_kernels\n"
        "import force2vec_tpu_torch.train.sync\n"
        "import force2vec_tpu_torch.tools.profile_iter\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'force2vec_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
