"""The port's vertex-sharded schedule (``dist/vertex_sharded.py``) on gloo
ranks against the JAX package's ``VertexShardedForce2Vec`` on virtual CPU
devices, on injected draws (rtol 1e-5, atol 1e-6, as the JAX package's own
tests hold it to its sync schedule): tdist at P ∈ {1, 4}, the four other
separable models at P = 4, ``pool`` sampling with injected choices,
``rwalk`` with injected walks through the ring and the a2a fetch, and the
a2a overflow counter; then, on the port alone, ``halo_stale`` for one
iteration against the exact schedule, the distributed walk engine's steps
against the graph's edges, and short training runs.  One group of 4 ranks
computes every P = 4 case; the ranks import no JAX.  Also the kernel
wrappers on a shard's operands: they pass, and an index one past either
table raises.

The code a card captures as a CUDA graph, run eagerly
(``span_graph.run_uncaptured``: the step from the step buffer, the draws
from the re-seeded generators, ``halo_stale``'s two static tables), equals
the eager loop (``_run_span_eager``) bit for bit, straight, in spans and
resumed from the embedding, for ``shared``, ``pool``, rwalk and
``halo_stale``, at P = 1 and on the 4 gloo ranks; and on a card a gloo
group is refused by name."""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.dist.vertex_sharded import (ShardTables,
                                                     VertexShardedForce2Vec,
                                                     shard_dep_part,
                                                     shard_free_part)
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.graphs.partition import VertexShardLayout
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.train.trainer import TrainConfig

DIM, NS, NEG_POOL, ITERS, P = 16, 4, 16, 2, 4
LAYOUT = dict(min_width=4, hub_width=16)
SEPARABLE = ["tdist", "sigmoid", "fr", "linlog", "forceatlas"]
GRAPH = dict(n=300, avg_deg=6, seed=3)
TOL = dict(rtol=1e-5, atol=1e-6)


def _graph():
    return synth_powerlaw_graph(**GRAPH)


def _inputs(n_loc_p):
    """X, the pools, choices (for P shards of n_loc_p rows) and walks of
    every case, from one numpy seed."""
    g = _graph()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((g.n, DIM)) * 0.1).astype(np.float32)
    pools = [rng.integers(0, g.n - 1, size=NS).astype(np.int32)
             for _ in range(ITERS)]
    big_pools = [rng.integers(0, g.n - 1, size=NEG_POOL).astype(np.int32)
                 for _ in range(ITERS)]
    choices = [rng.integers(0, NEG_POOL, size=(n_loc_p, NS)).astype(np.int32)
               for _ in range(ITERS)]
    walks = [rng.integers(0, g.n, size=(g.n, 5)).astype(np.int32)
             for _ in range(ITERS)]
    return dict(x=x, pools=pools, big_pools=big_pools, choices=choices,
                walks=walks)


# -- the port, on ranks that import no JAX ------------------------------------


def _port_case(model, inp, sampling="shared", walk_fetch="ring", cap=None,
               device="cpu"):
    """(rank 0's [n, D] after ITERS injected iterations or None, the
    overflow drops over all ranks)."""
    g = _graph()
    v = VertexShardedForce2Vec(
        g, TrainConfig(dim=DIM, model=model, ns=NS), sampling=sampling,
        neg_pool=NEG_POOL, walk_fetch=walk_fetch, walk_fetch_cap=cap,
        device=device, **LAYOUT)
    x = v.pad_embedding(inp["x"])
    for i in range(ITERS):
        if sampling == "pool":
            v.run_iteration(x, inp["big_pools"][i], choice=inp["choices"][i])
        else:
            v.run_iteration(x, inp["pools"][i], walks=(
                inp["walks"][i] if model == "rwalk" else None))
    out = v.unpad_embedding(x)
    drops = v.walk_overflow_dropped()
    return (None if out is None else out.numpy()), drops


def _port_ranks(rank, world, inp):
    """Every P = 4 case of this file on one rank."""
    out = {}
    for model in SEPARABLE:
        out[model] = _port_case(model, inp)
    out["pool"] = _port_case("tdist", inp, sampling="pool")
    out["rwalk_ring"] = _port_case("rwalk", inp)
    n_loc = VertexShardLayout.build(_graph(), world, **LAYOUT).n_loc
    out["rwalk_a2a"] = _port_case("rwalk", inp, walk_fetch="a2a", cap=n_loc)
    out["rwalk_cap8"] = _port_case("rwalk", inp, walk_fetch="a2a", cap=8)

    g = _graph()
    cfg = TrainConfig(dim=DIM, model="tdist", ns=NS)
    exact = VertexShardedForce2Vec(g, cfg, device="cpu", **LAYOUT)
    stale = VertexShardedForce2Vec(g, cfg, halo_stale=True, device="cpu",
                                   **LAYOUT)
    out["stale_1"] = (exact.train(iters=1, seed=5),
                      stale.train(iters=1, seed=5))
    out["stale_3"] = stale.train(iters=3, seed=5)
    out["train_pool"] = VertexShardedForce2Vec(
        g, cfg, sampling="pool", neg_pool=NEG_POOL, device="cpu",
        **LAYOUT).train(iters=3, seed=1)
    rw = TrainConfig(dim=DIM, model="rwalk", ns=NS)
    ring = VertexShardedForce2Vec(g, rw, walk_fetch="ring", device="cpu",
                                  **LAYOUT)
    a2a = VertexShardedForce2Vec(g, rw, walk_fetch="a2a",
                                 walk_fetch_slack=2.0, device="cpu", **LAYOUT)
    out["train_rwalk"] = (ring.train(iters=3, seed=5),
                          a2a.train(iters=3, seed=5), a2a.walk_fetch,
                          a2a.walk_overflow_dropped(), ring.comm_stats(),
                          a2a.comm_stats())
    gen = torch.Generator().manual_seed(3)
    out["walks"] = (ring.draw_walks(gen).numpy(), ring.layout.gmap[rank])
    for mode in SPAN_MODES:
        out[f"span_{mode}"] = _span_runs(mode)
    out["refusal"] = _card_refusal()
    for k, v in out.items():  # tensors to numpy for the parent
        if isinstance(v, tuple):
            out[k] = tuple(t.numpy() if isinstance(t, torch.Tensor) else t
                           for t in v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.numpy()
    return out


# the runner's modes whose captured span the tests run uncaptured
SPAN_MODES = {"shared": {}, "pool": dict(sampling="pool", neg_pool=NEG_POOL),
              "rwalk": dict(model="rwalk"), "halo_stale": dict(halo_stale=True)}
SPAN_ITERS, SPANS = 6, (1, 3, 2)


def _everywhere(v, emb):
    """Rank 0's ``unpad_embedding`` on every rank."""
    if v.P == 1:
        return emb
    obj = [emb]
    dist.broadcast_object_list(obj, src=v._ranks[0], group=v.group)
    return obj[0]


def _span_runs(mode):
    """The runner's eager loop and its graph's code run uncaptured, each
    straight, in SPANS and resumed at iteration 3 from the embedding
    (``pad_embedding`` of ``unpad_embedding``); rank 0's ``[n, D]`` of
    each (None on the other ranks)."""
    kw = dict(SPAN_MODES[mode])
    model = kw.pop("model", "tdist")
    v = VertexShardedForce2Vec(_graph(), TrainConfig(dim=DIM, model=model,
                                                     ns=NS),
                               device="cpu", **LAYOUT, **kw)
    x0 = v.init_embedding(seed=5)

    def spans(run, x, ks, done=0):
        for k in ks:
            run(x, 5, k, done)
            done += k
        return x

    eager, graph = v._run_span_eager, v.span_graph.run_uncaptured
    runs = {"eager": spans(eager, x0.clone(), (SPAN_ITERS,)),
            "graph": spans(graph, x0.clone(), (SPAN_ITERS,)),
            "eager_spans": spans(eager, x0.clone(), SPANS),
            "graph_spans": spans(graph, x0.clone(), SPANS),
            "eager_resumed": spans(eager, x0.clone(), (3, 3))}
    half = _everywhere(v, v.unpad_embedding(spans(graph, x0.clone(), (3,))))
    runs["resumed"] = spans(graph, v.pad_embedding(half), (3,), 3)
    runs["x0"] = x0
    out = {k: v.unpad_embedding(x) for k, x in runs.items()}
    return {k: (None if e is None else e.numpy()) for k, e in out.items()}


def _card_refusal():
    """What ``run_span`` raises on a card over this gloo group (the runner
    built on the CPU, then told its device is a card: the refusal comes
    before any device work)."""
    v = VertexShardedForce2Vec(_graph(), TrainConfig(dim=DIM, ns=NS),
                               device="cpu", **LAYOUT)
    x = v.init_embedding(1)
    v.device = torch.device("cuda")
    try:
        v.run_span(x, 1, 2)
    except RuntimeError as e:
        return str(e)
    return None


def _assert_span_runs(runs, mode):
    """The uncaptured graph equals the eager loop bit for bit, straight,
    in spans and resumed; off ``halo_stale`` the spans and the resumed run
    equal the straight run (with it, each span primes its first
    iteration's exchange, as the eager loop's spans do)."""
    np.testing.assert_array_equal(runs["graph"], runs["eager"])
    np.testing.assert_array_equal(runs["graph_spans"], runs["eager_spans"])
    np.testing.assert_array_equal(runs["resumed"], runs["eager_resumed"])
    if mode != "halo_stale":
        np.testing.assert_array_equal(runs["eager_spans"], runs["eager"])
        np.testing.assert_array_equal(runs["resumed"], runs["eager"])
    assert not np.array_equal(runs["eager"], runs["x0"])
    assert np.isfinite(runs["eager"]).all()


@pytest.fixture(scope="module")
def inputs():
    n_loc = VertexShardLayout.build(_graph(), P, **LAYOUT).n_loc
    return _inputs(P * n_loc)


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's results and every rank's walks (one spawn of 4 ranks)."""
    res = multihost.spawn(_port_ranks, P, "gloo", args=(inputs,),
                          timeout=240, threads=1)
    out = res[0]
    out["walks"] = [r["walks"] for r in res]
    return out


# -- the JAX package, in this process -----------------------------------------


@contextlib.contextmanager
def _jitted_shard_map():
    """The JAX runner's ``run_iteration`` calls ``jax.shard_map`` eagerly,
    op by op (seconds per iteration on virtual CPU devices); under
    ``jax.jit`` the same function runs compiled."""
    import jax

    orig = jax.shard_map
    jax.shard_map = lambda f, **kw: jax.jit(orig(f, **kw))
    try:
        yield
    finally:
        jax.shard_map = orig


def _jax_case(model, inp, n_dev, sampling="shared", walk_fetch="ring",
              cap=None):
    with _jitted_shard_map():
        return _jax_run(model, inp, n_dev, sampling, walk_fetch, cap)


def _jax_run(model, inp, n_dev, sampling, walk_fetch, cap):
    import jax

    from force2vec_tpu.dist.vertex_sharded import VertexShardedForce2Vec as J
    from force2vec_tpu.dist.vertex_sharded import make_vp_mesh
    from force2vec_tpu.graphs.csr import Graph as JaxGraph
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    g = _graph()
    kw = dict(walk_fetch=walk_fetch) if model == "rwalk" else {}
    if cap is not None:
        kw["walk_fetch_cap"] = cap
    v = J(JaxGraph(g.n, g.rowptr, g.colids),
          JaxConfig(dim=DIM, model=model, ns=NS),
          mesh=make_vp_mesh(jax.devices()[:n_dev]), sampling=sampling,
          neg_pool=NEG_POOL, **LAYOUT, **kw)
    x = v.pad_embedding(inp["x"])
    for i in range(ITERS):
        if sampling == "pool":
            x = v.run_iteration(x, inp["big_pools"][i],
                                choice=inp["choices"][i])
        else:
            x = v.run_iteration(x, inp["pools"][i], walks=(
                inp["walks"][i] if model == "rwalk" else None))
    return v.unpad_embedding(x), v.walk_overflow_dropped()


@pytest.mark.parametrize("model", SEPARABLE)
def test_separable_models_match_jax_at_p4(port, inputs, model):
    got, _ = port[model]
    want, _ = _jax_case(model, inputs, P)
    np.testing.assert_allclose(got, want, **TOL)


def test_tdist_matches_jax_at_p1():
    """P = 1 in this process, with no process group: no collective."""
    g = _graph()
    n_loc = VertexShardLayout.build(g, 1, **LAYOUT).n_loc
    inp = _inputs(n_loc)
    got, _ = _port_case("tdist", inp)
    want, _ = _jax_case("tdist", inp, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_pool_sampling_matches_jax(port, inputs):
    got, _ = port["pool"]
    want, _ = _jax_case("tdist", inputs, P, sampling="pool")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fetch", ["ring", "a2a"])
def test_rwalk_fetch_matches_jax(port, inputs, fetch):
    """The ring and the a2a fetch (cap n_loc: nothing dropped) against the
    JAX ring and each other."""
    got, drops = port[f"rwalk_{fetch}"]
    want, _ = _jax_case("rwalk", inputs, P)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, port["rwalk_ring"][0], rtol=1e-6,
                               atol=1e-7)
    assert drops == 0


def test_rwalk_overflow_counter_counts_drops(port, inputs):
    """At cap 8 the a2a fetch drops slots: the port counts the JAX
    package's number and drops the same slots from the attraction."""
    got, drops = port["rwalk_cap8"]
    want, want_drops = _jax_case("rwalk", inputs, P, walk_fetch="a2a", cap=8)
    assert drops > 0 and drops == want_drops
    np.testing.assert_allclose(got, want, **TOL)


def test_halo_stale_one_iteration_equals_exact(port):
    exact, stale = port["stale_1"]
    np.testing.assert_array_equal(stale, exact)
    assert np.isfinite(port["stale_3"]).all()
    assert port["stale_3"].shape == (_graph().n, DIM)


def test_walk_engine_steps_are_edges(port):
    """Every distributed walk step moves along an edge, or stays put on a
    degree-0 row; padding walkers are -1."""
    g = _graph()
    lay = VertexShardLayout.build(g, P, **LAYOUT)
    inv = lay.inv_perm
    adj = {(int(inv[v]), int(inv[g.colids[e]])) for v in range(g.n)
           for e in range(g.rowptr[v], g.rowptr[v + 1])}
    deg = np.zeros(g.n, np.int64)
    deg[inv] = g.degrees
    steps = 0
    for walks, gmap in port["walks"]:
        for r in range(lay.n_loc):
            cur = int(gmap[r])
            if cur < 0:
                assert (walks[r] == -1).all()
                continue
            for nxt in walks[r]:
                assert (cur, int(nxt)) in adj or (deg[cur] == 0
                                                   and nxt == cur)
                cur = int(nxt)
                steps += 1
    assert steps == g.n * 5


def test_short_training_runs_stay_finite(port):
    """Pool sampling and rwalk train 3 iterations; the preflight-sized a2a
    fetch drops nothing, equals the ring and sends no more rows (its cap
    is clamped to n_loc, the ring's rows per peer)."""
    assert np.isfinite(port["train_pool"]).all()
    ring, a2a, mode, drops, cs_ring, cs_a2a = port["train_rwalk"]
    assert mode == "a2a" and drops == 0
    assert np.isfinite(ring).all() and ring.shape == (_graph().n, DIM)
    np.testing.assert_allclose(a2a, ring, **TOL)
    assert cs_a2a["rwalk_a2a_rows_sent"] <= cs_ring["rwalk_ring_rows_sent"]


# -- the kernel wrappers on a shard's operands ---------------------------------


def test_wrappers_take_a_shards_operands():
    """Shard 1 of 4: the free table gathers from x_loc, the dep table from
    [x_loc | hot | halo] (more rows than x), the pool repulsion from the
    [S, D] pool (rows unrelated to x); each passes.  An index one past the
    gather table or past x raises ValueError, in ``edge_work_table`` and
    in the runner's ``run_iteration`` for injected draws."""
    g = _graph()
    lay = VertexShardLayout.build(g, P, **LAYOUT)
    p, n_loc, model = 1, lay.n_loc, get_model("tdist")
    t = ShardTables.build(lay, p, "cpu")
    rng = np.random.default_rng(5)
    xg = torch.from_numpy(rng.random((P * n_loc, DIM), dtype=np.float32))
    x = xg[p * n_loc: (p + 1) * n_loc].contiguous()
    hot = xg[torch.as_tensor(np.arange(P)[:, None] * n_loc
                             + lay.hot_send).reshape(-1)]
    halo = xg[torch.as_tensor(np.arange(P)[:, None] * n_loc
                              + lay.send_idx[:, p]).reshape(-1)]
    tab = torch.cat([x, hot, halo])
    assert tab.shape[0] > x.shape[0] and t.dep is not None
    pool = xg[rng.integers(0, P * n_loc, NEG_POOL)]
    choice = torch.from_numpy(rng.integers(0, NEG_POOL, (n_loc, NS),
                                           dtype=np.int32))
    upd, rep = shard_free_part(model, t, x, pool, 0.02, choice)
    got = shard_dep_part(model, t, x, tab, upd, rep, 0.02)
    assert torch.isfinite(got).all()

    # injected draws are checked where they enter, once: a choice one past
    # the pool, or a pool id one past the graph, raises
    v = VertexShardedForce2Vec(g, TrainConfig(dim=DIM, ns=NS, model="tdist"),
                               sampling="pool", device="cpu", **LAYOUT)
    xv = v.init_embedding(1)
    ids = rng.integers(0, g.n, NEG_POOL).astype(np.int32)
    bad = rng.integers(0, NEG_POOL, (v.layout.n_loc, NS)).astype(np.int32)
    bad[0, 0] = NEG_POOL
    with pytest.raises(ValueError, match="choice"):
        v.run_iteration(xv, ids, choice=bad)
    ids[0] = g.n
    with pytest.raises(ValueError, match="pool ids"):
        v.run_iteration(xv, ids, choice=bad % NEG_POOL)
    nbr, deg, xi_row, ob = t.dep.parts()[0]
    bad = nbr.clone()
    bad[deg > 0, 0] = tab.shape[0]  # one past the gather table
    with pytest.raises(ValueError, match="gather table"):
        fk.edge_work_table([(bad, deg, xi_row, ob)], n_loc, t.out_rows,
                           n_gather=tab.shape[0], partial=True)
    with pytest.raises(ValueError, match="xi_row"):
        fk.edge_work_table([(nbr, deg, xi_row + n_loc, ob)], n_loc,
                           t.out_rows, n_gather=tab.shape[0], partial=True)
    with pytest.raises(ValueError, match="rows"):  # x's rows not first
        fk.ell_edge_force_table(model, x, tab[: n_loc - 1], t.dep, t.inv_deg,
                                0.02, out=upd)


# -- the graph's code, uncaptured, against the eager loop ----------------------


@pytest.mark.parametrize("mode", list(SPAN_MODES))
def test_uncaptured_span_equals_the_eager_loop_at_p1(mode):
    _assert_span_runs(_span_runs(mode), mode)


@pytest.mark.parametrize("mode", list(SPAN_MODES))
def test_uncaptured_span_equals_the_eager_loop_at_p4(port, mode):
    _assert_span_runs(port[f"span_{mode}"], mode)


def test_run_span_refuses_a_gloo_group_on_a_card(port):
    assert port["refusal"] is not None and "gloo" in port["refusal"]
    assert "run_iteration" in port["refusal"]


def test_run_span_on_the_cpu_is_the_eager_loop():
    """At P = 1 on the CPU ``run_span`` is the eager loop, and captures
    nothing."""
    v = VertexShardedForce2Vec(_graph(), TrainConfig(dim=DIM, ns=NS,
                                                     model="fr"),
                               device="cpu", **LAYOUT)
    x0 = v.init_embedding(seed=2)
    want, got = x0.clone(), x0.clone()
    v._run_span_eager(want, 2, 4)
    assert v.run_span(got, 2, 4) is got
    assert torch.equal(got, want)
    assert v.span_graph.captures == 0 and not v.span_graph.graphs


def test_the_step_buffer_holds_each_iterations_step():
    """fr decays its step: the graph's step buffer holds ``step_at`` of
    the iteration being prepared, and a meter set on the runner is the
    graph's, its old graph dropped."""
    from force2vec_tpu_torch.train.trainer import step_at
    from force2vec_tpu_torch.utils.profiling import Meter

    v = VertexShardedForce2Vec(_graph(), TrainConfig(dim=DIM, ns=NS,
                                                     model="fr",
                                                     dtype="bfloat16"),
                               device="cpu", **LAYOUT)
    for it in (0, 1, 7, 500):
        v._prepare_iteration(3, it)
        assert float(v._step_buf.tensor) == step_at(
            get_model("fr"), v.lr, it, torch.bfloat16)
    v.span_graph.key = ("a captured X",)
    m = Meter("cpu")
    v.meter = m
    assert v.span_graph.meter is m and v.span_graph.key is None


@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
def test_init_embedding_of_a_two_byte_x_is_the_f32_init_rounded(dtype):
    """The runner draws its init in f32 and rounds it to X's dtype: the
    same X as an f32 runner's, rounded."""
    cfg = TrainConfig(dim=DIM, ns=NS, model="fr")
    v32 = VertexShardedForce2Vec(_graph(), cfg, device="cpu", **LAYOUT)
    v16 = VertexShardedForce2Vec(_graph(), TrainConfig(
        dim=DIM, ns=NS, model="fr", dtype=dtype), device="cpu", **LAYOUT)
    got = v16.init_embedding(seed=4)
    assert got.dtype == getattr(torch, dtype)
    assert torch.equal(got, v32.init_embedding(seed=4).to(got.dtype))
