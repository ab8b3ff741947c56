"""Every embedding width on the sync and vertex schedules.

The trainers hold X at ``padded_dim(dim)`` columns (the dim rounded up to
8, the kernels' row alignment), the padding columns 0; the public shape
stays ``[n, dim]``.  On the CPU the wrappers run the kernels' plain
versions over the padded rows, so these tests exercise the padding the
card's kernels see:

* one ``SyncForce2Vec`` iteration on injected negatives (and walks) at
  dims {2, 20, 32, 100}, for tdist with group-shared and ``-bs 1``
  negatives, rwalk, fr and the sigmoid lookup table, against the JAX
  package's jnp path, and tdist against its Pallas kernels in interpret
  mode, from the JAX X carried over by ``convert.py``;
* the padding columns still 0 after an iteration of every model;
* ``init_embedding(seed)`` equal to the unpadded draw;
* ``VertexShardedForce2Vec`` at P = 1 and on 2 gloo ranks at dim 20, and
  the sync trainer at tp = 2 on 2 gloo ranks at dim 100, against the JAX
  package and against one rank;
* a checkpoint round trip and a resume at dim 20, and the command line at
  ``-dim 2`` and ``-dim 20``.

Tolerances: 1e-5 (rtol and atol) for f32 gathers, the bound the JAX
package's own tests hold its schedules to; 1e-4 absolute for the lookup
table, where a dot product summed in another order can land one bin over
(a term then moves by one table step of σ, 12/2048 · 1/4, times the 0.02
step and |x| ≤ 1); 1e-5 rtol, 1e-6 atol between gloo ranks and one
process.  The rank functions import no JAX (the ranks are spawned
processes)."""

import _jax_inline_dispatch  # noqa: F401  (first: before any JAX client)
import contextlib
import os

import numpy as np
import pytest
import torch

from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch import cli
from force2vec_tpu_torch.convert import embedding_from_jax, embedding_to_numpy
from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.dist.vertex_sharded import VertexShardedForce2Vec
from force2vec_tpu_torch.graphs import read_embeddings, synth_powerlaw_graph
from force2vec_tpu_torch.ops.force_kernels import ROW_ALIGN, padded_dim
from force2vec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  train_with_checkpoints)

DIMS = (2, 20, 32, 100)
NS, BS = 4, 8
LAYOUT = dict(min_width=4, hub_width=8)
GRAPH = dict(n=400, avg_deg=6, seed=3)
CONFIGS = {
    "tdist": dict(model="tdist"),
    "tdist_bs1": dict(model="tdist", per_vertex_samples=True),
    "rwalk": dict(model="rwalk"),
    "fr": dict(model="fr"),
    "sigmoid_table": dict(model="sigmoid", sm_table=True),
}
TOL = dict(rtol=1e-5, atol=1e-5)
TABLE_TOL = dict(rtol=0, atol=1e-4)
RANK_TOL = dict(rtol=1e-5, atol=1e-6)
VERTEX_DIM, TP_DIM = 20, 100
VERTEX_LAYOUT = dict(min_width=4, hub_width=16)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(ROOT, "tests", "data", "karate.mtx")


def _graph():
    return synth_powerlaw_graph(**GRAPH)


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _jax_sync(graph, kw, pallas):
    from jax.experimental.pallas import tpu as pltpu

    from force2vec_tpu.graphs.csr import Graph as JaxGraph
    from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    def ctx():  # a new context each time: one cannot be entered twice
        return (pltpu.force_tpu_interpret_mode() if pallas
                else contextlib.nullcontext())

    with ctx():
        return JaxSync(JaxGraph(graph.n, graph.rowptr, graph.colids),
                       JaxConfig(**kw), use_pallas=pallas, **LAYOUT), ctx


def _draws(fv, rng):
    """One iteration's negatives (and walks) as the runner takes them."""
    negs = rng.integers(0, fv.graph.n - 1,
                        size=fv._neg_shape).astype(np.int32)
    walks = None
    if fv.model.attraction == "walk":
        walks = fv.draw_walks(torch.Generator().manual_seed(5)).numpy()
    return negs, walks


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("name", list(CONFIGS) + ["tdist_pallas",
                                                  "tdist_bs1_pallas"])
def test_sync_iteration_matches_jax_at_any_dim(graph, name, dim):
    pallas = name.endswith("_pallas")
    over = CONFIGS[name.removesuffix("_pallas")]
    kw = dict(dim=dim, batch_size=BS, ns=NS, **over)
    jfv, ctx = _jax_sync(graph, kw, pallas)
    tfv = SyncForce2Vec(graph, TrainConfig(**kw), device="cpu", **LAYOUT)
    assert tfv.row_width == padded_dim(dim) and tfv.row_width % ROW_ALIGN == 0
    rng = np.random.default_rng(dim)
    x0 = rng.random((graph.n, dim)).astype(np.float32)
    if tfv.model.init != "uniform01":
        x0 = x0 * 2 - 1
    xj = np.asarray(jfv.pad_embedding(x0))
    xt = embedding_from_jax(xj, "cpu")  # the JAX X, carried over
    assert tuple(xt.shape) == (tfv.layout.n_pad, tfv.row_width)
    torch.testing.assert_close(xt, tfv.pad_embedding(x0), rtol=0, atol=0)
    negs, walks = _draws(tfv, rng)
    step = tfv._step(0)
    with ctx():
        xj = jfv.run_iteration(xj, negs, walks=walks, step=step)
    assert tfv.run_iteration(xt, negs, walks=walks, step=step) is xt
    assert not xt[:, dim:].any(), "a padding column moved"
    np.testing.assert_allclose(embedding_to_numpy(xt, dim), np.asarray(xj),
                               **(TABLE_TOL if over.get("sm_table") else TOL))
    np.testing.assert_allclose(tfv.unpad_embedding(xt).numpy(),
                               jfv.unpad_embedding(xj),
                               **(TABLE_TOL if over.get("sm_table") else TOL))


@pytest.mark.parametrize("over", [
    dict(model="tdist"), dict(model="tdist", per_vertex_samples=True),
    dict(model="sigmoid"), dict(model="rwalk"), dict(model="fr"),
    dict(model="linlog"), dict(model="forceatlas"),
    dict(model="sigmoid", sm_table=True), dict(model="rwalk", sm_table=True),
], ids=lambda o: "_".join(str(v) for v in o.values()))
def test_padding_columns_stay_zero_after_every_model(graph, over):
    """Kernels' path and plain path: X's padding columns are 0 after an
    iteration of every model, on the sync and (for the CSR models) the
    vertex schedule, and the real columns moved."""
    dim = 20
    cfg = TrainConfig(dim=dim, batch_size=BS, ns=NS, **over)
    fv = SyncForce2Vec(graph, cfg, device="cpu", **LAYOUT)
    x0 = fv.init_embedding(seed=4)
    negs, walks = _draws(fv, np.random.default_rng(1))
    for plain in (False, True):
        x = fv.run_iteration(x0.clone(), negs, walks=walks, plain=plain)
        assert torch.isfinite(x).all()
        assert not x[:, dim:].any()
        assert not torch.equal(x[:, :dim], x0[:, :dim])
    if over["model"] == "rwalk":
        return
    v = VertexShardedForce2Vec(graph, cfg, device="cpu", **VERTEX_LAYOUT)
    xv = v.init_embedding(seed=4)
    pool = np.random.default_rng(2).integers(0, graph.n - 1, NS)
    v.run_iteration(xv, pool)
    assert torch.isfinite(xv).all() and not xv[:, dim:].any()


@pytest.mark.parametrize("model", ["tdist", "sigmoid"])
@pytest.mark.parametrize("dim", [2, 20, 100])
def test_init_embedding_equals_the_unpadded_draw(graph, model, dim):
    """The sync trainer draws ``[n_pad, dim]`` from the seed and pads; the
    vertex trainer draws ``[n, dim]`` in original id order: the same X at
    any row width."""
    fv = SyncForce2Vec(graph, TrainConfig(dim=dim, model=model),
                       device="cpu", **LAYOUT)
    sym = fv.model.init != "uniform01"
    x = fv.init_embedding(seed=9)
    want = torch.rand((fv.layout.n_pad, dim),
                      generator=torch.Generator().manual_seed(9))
    want = want * 2 - 1 if sym else want
    assert x.shape == (fv.layout.n_pad, padded_dim(dim))
    torch.testing.assert_close(x[:, :dim], want, rtol=0, atol=0)
    assert not x[:, dim:].any()
    v = VertexShardedForce2Vec(graph, TrainConfig(dim=dim, model=model),
                               device="cpu", **VERTEX_LAYOUT)
    xv = v.init_embedding(seed=9)
    assert xv.shape == (v.layout.n_loc, padded_dim(dim))
    want = torch.rand((graph.n, dim),
                      generator=torch.Generator().manual_seed(9))
    want = want * 2 - 1 if sym else want
    torch.testing.assert_close(v.unpad_embedding(xv), want, rtol=0, atol=0)
    assert not xv[:, dim:].any()


# -- the vertex schedule and the tp runner, on gloo ranks -----------------------


def _vertex_inputs(n_loc_p):
    g = _graph()
    rng = np.random.default_rng(13)
    x = (rng.random((g.n, VERTEX_DIM)) * 2 - 1).astype(np.float32)
    pools = [rng.integers(0, g.n - 1, NS).astype(np.int32) for _ in range(2)]
    big = [rng.integers(0, g.n - 1, 16).astype(np.int32) for _ in range(2)]
    choices = [rng.integers(0, 16, (n_loc_p, NS)).astype(np.int32)
               for _ in range(2)]
    return dict(x=x, pools=pools, big=big, choices=choices)


def _vertex_port(inp, sampling):
    v = VertexShardedForce2Vec(
        _graph(), TrainConfig(dim=VERTEX_DIM, model="tdist", ns=NS),
        sampling=sampling, neg_pool=16, device="cpu", **VERTEX_LAYOUT)
    x = v.pad_embedding(inp["x"])
    for i in range(2):
        if sampling == "pool":
            v.run_iteration(x, inp["big"][i], choice=inp["choices"][i])
        else:
            v.run_iteration(x, inp["pools"][i])
    assert not x[:, VERTEX_DIM:].any()
    out = v.unpad_embedding(x)
    return None if out is None else out.numpy()


def _vertex_ranks(rank, world, inp):
    return {s: _vertex_port(inp, s) for s in ("shared", "pool")}


def _tp_ranks(rank, world, x_host, negs):
    """One sync iteration at tp = ``world`` (each rank its dim / tp columns,
    padded to 8), then the gathered X."""
    fv = SyncForce2Vec(_graph(), TrainConfig(dim=TP_DIM, batch_size=BS,
                                             ns=NS),
                       spmd=multihost.pod_mesh(world), device="cpu",
                       **LAYOUT)
    x = fv.pad_embedding(x_host)
    assert x.shape[1] == padded_dim(TP_DIM // world) == fv.row_width
    fv.run_iteration(x, negs)
    assert not x[:, TP_DIM // world:].any()
    return fv.unpad_embedding(x).numpy()


def _jax_vertex(inp, n_dev, sampling):
    import jax

    from force2vec_tpu.dist.vertex_sharded import VertexShardedForce2Vec as J
    from force2vec_tpu.dist.vertex_sharded import make_vp_mesh
    from force2vec_tpu.graphs.csr import Graph as JaxGraph
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    g = _graph()
    orig = jax.shard_map  # compiled, not op by op (25 s → 2 s a case)
    jax.shard_map = lambda f, **kw: jax.jit(orig(f, **kw))
    try:
        v = J(JaxGraph(g.n, g.rowptr, g.colids),
              JaxConfig(dim=VERTEX_DIM, model="tdist", ns=NS),
              mesh=make_vp_mesh(jax.devices()[:n_dev]), sampling=sampling,
              neg_pool=16, **VERTEX_LAYOUT)
        x = v.pad_embedding(inp["x"])
        for i in range(2):
            if sampling == "pool":
                x = v.run_iteration(x, inp["big"][i],
                                    choice=inp["choices"][i])
            else:
                x = v.run_iteration(x, inp["pools"][i])
        return v.unpad_embedding(x)
    finally:
        jax.shard_map = orig


@pytest.fixture(scope="module")
def vertex_two_ranks():
    from force2vec_tpu_torch.graphs.partition import VertexShardLayout

    n_loc = VertexShardLayout.build(_graph(), 2, **VERTEX_LAYOUT).n_loc
    inp = _vertex_inputs(2 * n_loc)
    out = multihost.spawn(_vertex_ranks, 2, "gloo", args=(inp,),
                          timeout=240, threads=1)[0]
    return inp, out


@pytest.mark.parametrize("sampling", ["shared", "pool"])
def test_vertex_at_dim_20_matches_jax_at_p1(sampling):
    from force2vec_tpu_torch.graphs.partition import VertexShardLayout

    n_loc = VertexShardLayout.build(_graph(), 1, **VERTEX_LAYOUT).n_loc
    inp = _vertex_inputs(n_loc)
    np.testing.assert_allclose(_vertex_port(inp, sampling),
                               _jax_vertex(inp, 1, sampling), **TOL)


@pytest.mark.parametrize("sampling", ["shared", "pool"])
def test_vertex_at_dim_20_matches_jax_on_two_ranks(vertex_two_ranks,
                                                   sampling):
    inp, out = vertex_two_ranks
    np.testing.assert_allclose(out[sampling], _jax_vertex(inp, 2, sampling),
                               **TOL)


def test_tp2_at_dim_100_matches_one_rank():
    g = _graph()
    one = SyncForce2Vec(g, TrainConfig(dim=TP_DIM, batch_size=BS, ns=NS),
                        device="cpu", **LAYOUT)
    rng = np.random.default_rng(17)
    x_host = (rng.random((g.n, TP_DIM)) * 2 - 1).astype(np.float32)
    negs = rng.integers(0, g.n - 1, one._neg_shape).astype(np.int32)
    got = multihost.spawn(_tp_ranks, 2, "gloo", args=(x_host, negs),
                          timeout=240, threads=1)[0]
    x = one.pad_embedding(x_host)
    one.run_iteration(x, negs)
    want = one.unpad_embedding(x).numpy()
    assert got.shape == want.shape == (g.n, TP_DIM)
    np.testing.assert_allclose(got, want, **RANK_TOL)


# -- checkpoints, convert.py and the command line --------------------------------


def test_checkpoint_round_trip_and_resume_at_dim_20(graph, tmp_path):
    """Checkpoints hold ``[n, dim]``, never the padded width; a resume from
    the middle equals the straight run, on both trainers; a checkpoint of
    another dim is refused."""
    cfg = TrainConfig(dim=20, batch_size=BS, ns=NS)
    for make in (lambda: SyncForce2Vec(graph, cfg, device="cpu", **LAYOUT),
                 lambda: VertexShardedForce2Vec(graph, cfg, device="cpu",
                                                **VERTEX_LAYOUT)):
        d = tmp_path / type(make()).__name__
        straight = train_with_checkpoints(make(), 4, seed=2, every=2,
                                          ckpt_dir=str(d), async_fetch=False)
        assert straight.shape == (graph.n, 20)
        mid, it = load_checkpoint(str(d / "ckpt_0000002.npz"))
        assert it == 2 and mid.shape == (graph.n, 20)
        end, _ = load_checkpoint(str(d / "ckpt_0000004.npz"))
        np.testing.assert_array_equal(end, straight.numpy())
        resumed = train_with_checkpoints(make(), 4, seed=2, x0=mid,
                                         start_iter=2, every=2,
                                         ckpt_dir=str(d / "resumed"))
        np.testing.assert_allclose(resumed.numpy(), straight.numpy(),
                                   rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="columns"):
            train_with_checkpoints(make(), 4, x0=mid[:, :8], start_iter=2,
                                   ckpt_dir=str(d / "refused"))


def test_convert_round_trip_at_dim_20():
    rng = np.random.default_rng(3)
    x = rng.random((40, 20)).astype(np.float32)
    t = embedding_from_jax(x, "cpu")
    assert t.shape == (40, 24) and not t[:, 20:].any()
    np.testing.assert_array_equal(embedding_to_numpy(t, 20), x)
    with pytest.raises(ValueError):
        embedding_to_numpy(t, 16)


@pytest.mark.parametrize("schedule,dim", [("sync", 2), ("vertex", 20)])
def test_cli_trains_narrow_dims_on_the_sync_and_vertex_schedules(
        tmp_path, schedule, dim):
    rc = cli.main(["-input", KARATE, "-output", str(tmp_path), "-batch",
                   "16", "-iter", "5", "-dim", str(dim), "-nsamples", "3",
                   "--schedule", schedule, "--device", "cpu"])
    assert rc == 0
    name = f"karate.mtxF2VTDIST16D{dim}IT5NS3.embd"
    assert sorted(os.listdir(tmp_path)) == ["Results.txt", name]
    emb = read_embeddings(str(tmp_path / name))
    assert emb.shape == (34, dim) and np.isfinite(emb).all()
    with open(tmp_path / "Results.txt") as f:
        assert f"Dimension:{dim}\t" in f.read()
