"""The port's dp × tp runners (the trainers with ``spmd``) on gloo ranks at (dp,
tp) ∈ {(2, 1), (1, 2), (2, 2)}: on injected draws against the JAX
package's sharded iterations (its ``_build_iteration_fn(spmd)`` under
``shard_map`` on virtual CPU devices), and trained from one seed against
the port's single-process runs (rtol 1e-5, atol 1e-6, the JAX package's
own bound for its sharded runners).  The batch trainer with tdist,
sigmoid and per-vertex negatives; the sync trainer with group-shared and
per-vertex negatives and rwalk (a hub bucket included).  One group of 2
ranks computes (2, 1) and (1, 2); one of 4 ranks computes (2, 2).  The
ranks import no JAX.

The code a card captures as a CUDA graph, every rank's iteration with its
collectives, run eagerly (``span_graph.run_uncaptured``: the step from the
step buffer, the draws from the re-seeded generator) equals each runner's
eager loop bit for bit, straight and in spans, at every (dp, tp); and on a
card a gloo group is refused by name."""

import numpy as np
import pytest
import torch

from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.train.sync import SyncForce2Vec
from force2vec_tpu_torch.train.trainer import Force2Vec, TrainConfig

DIM, NS, BATCH, ITERS = 16, 4, 16, 2
LAYOUT = dict(min_width=4, hub_width=16)
GRAPH = dict(n=200, avg_deg=6, seed=3)
TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = [(2, 1), (1, 2), (2, 2)]
# (case, schedule, config overrides)
CASES = [
    ("batch_tdist", "batch", dict(model="tdist")),
    ("batch_sigmoid", "batch", dict(model="sigmoid")),
    ("batch_per_vertex", "batch", dict(model="tdist",
                                       per_vertex_samples=True)),
    ("sync_tdist", "sync", dict(model="tdist")),
    ("sync_per_vertex", "sync", dict(model="tdist", per_vertex_samples=True)),
    ("sync_rwalk", "sync", dict(model="rwalk")),
    ("sync_fr", "sync", dict(model="fr")),
    ("sync_sigmoid", "sync", dict(model="sigmoid")),
]


def _graph():
    return synth_powerlaw_graph(**GRAPH)


def _config(over):
    return TrainConfig(dim=DIM, batch_size=BATCH, ns=NS, edge_chunk=64,
                       **over)


def _single(schedule, over, device="cpu"):
    if schedule == "batch":
        return Force2Vec(_graph(), _config(over), device=device)
    return SyncForce2Vec(_graph(), _config(over), device=device, **LAYOUT)


def _draws():
    """X, and per case ITERS injected negatives (and walks), shaped as the
    single-process runner takes them (the sharded runners' are the same:
    at dp ≤ 8 the sync layout's rows align to 8 either way)."""
    g = _graph()
    rng = np.random.default_rng(11)
    x = (rng.random((g.n, DIM)) * 2 - 1).astype(np.float32)
    draws = {}
    for name, schedule, over in CASES:
        fv = _single(schedule, over)
        its = []
        for _ in range(ITERS):
            if schedule == "batch":
                m = NS * BATCH if over.get("per_vertex_samples") else NS
                negs = rng.integers(0, g.n - 1, size=(fv.dg.num_batches, m))
                walks = None
            else:
                negs = rng.integers(0, g.n - 1, size=fv._neg_shape)
                walks = (rng.integers(0, g.n, size=(
                    fv.layout.n_pad, fv.config.walk_length))
                    if over["model"] == "rwalk" else None)
            its.append((negs.astype(np.int32),
                        None if walks is None else walks.astype(np.int32)))
        draws[name] = its
    return x, draws


def _ranks(rank, world, tps, x_host, draws):
    """Every case at (world // tp, tp) for each tp in ``tps``: ITERS
    injected iterations, and ITERS trained ones from seed 3."""
    out = {}
    for tp in tps:
        spmd = multihost.pod_mesh(tp)
        for name, schedule, over in CASES:
            runner = (Force2Vec(_graph(), _config(over), spmd=spmd,
                                device="cpu")
                      if schedule == "batch" else
                      SyncForce2Vec(_graph(), _config(over), spmd=spmd,
                                    device="cpu", **LAYOUT))
            x = runner.pad_embedding(x_host)
            for negs, walks in draws[name]:
                runner.run_iteration(x, negs, walks=walks)
            graph = runner.span_graph.run_uncaptured
            xg, xs = runner.init_embedding(3), runner.init_embedding(3)
            graph(xg, 3, ITERS)
            for it in range(ITERS):  # spans of one iteration
                graph(xs, 3, 1, it)
            out[(world // tp, tp, name)] = (
                runner.unpad_embedding(x).numpy(),
                runner.train(ITERS, seed=3).numpy(),
                runner.unpad_embedding(xg).numpy(),
                runner.unpad_embedding(xs).numpy())
        out[(world // tp, tp, "refusal")] = _card_refusals(spmd)
    return out


def _card_refusals(spmd):
    """What each trainer's ``run_span`` raises on a card under these gloo
    groups (built on the CPU, then told its device is a card: the refusal
    comes before any device work)."""
    out = []
    for runner in (Force2Vec(_graph(), _config({}), spmd=spmd, device="cpu"),
                   SyncForce2Vec(_graph(), _config({}), spmd=spmd,
                                 device="cpu", **LAYOUT)):
        x = runner.init_embedding(1)
        runner.device = torch.device("cuda")
        try:
            runner.run_span(x, 1, 2)
            out.append(None)
        except RuntimeError as e:
            out.append(str(e))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _draws()


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's results of every (dp, tp) and case: one group of 2 ranks
    and one of 4."""
    x, draws = inputs
    out = {}
    for world, tps in ((2, (1, 2)), (4, (2,))):
        out.update(multihost.spawn(_ranks, world, "gloo",
                                   args=(tps, x, draws), timeout=240,
                                   threads=1)[0])
    return out


def _jax_iterations(dp, tp, schedule, over, x_host, its):
    """The JAX package's sharded iteration on ``dp·tp`` virtual devices,
    over the injected draws; returns [n, D] in original id order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec as JSync
    from force2vec_tpu.dist.sharded import make_mesh
    from force2vec_tpu.dist.spmd import SpmdAxes
    from force2vec_tpu.graphs.csr import Graph as JaxGraph
    from force2vec_tpu.train.trainer import Force2Vec as JForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    g = _graph()
    jg = JaxGraph(g.n, g.rowptr, g.colids)
    cfg = JaxConfig(dim=DIM, batch_size=BATCH, ns=NS, edge_chunk=64, **over)
    mesh = make_mesh(jax.devices()[: dp * tp], dp=dp, tp=tp)
    if schedule == "batch":
        fv = JForce2Vec(jg, cfg)
        spmd = SpmdAxes(dp="dp", tp="tp", n_dp=dp, n_tp=tp)
    else:
        sfv = JSync(jg, cfg, mesh, **LAYOUT)
        fv, spmd = sfv.fv, sfv.spmd
    iteration = fv._build_iteration_fn(spmd)
    step = jnp.float32(fv.lr)
    x_spec = P(None, "tp")
    walk = its[0][1] is not None

    def body(garr, x, negs, walks):
        return iteration(garr, x, negs, walks if walk else None, step)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(), x_spec, P(), P()),
                              out_specs=x_spec, check_vma=False))
    x = jnp.asarray(fv.pad_embedding(x_host))
    for negs, walks in its:
        x = f(fv._garr, x, jnp.asarray(negs),
              jnp.asarray(walks if walk else np.zeros(1, np.int32)))
    return fv.unpad_embedding(x)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_iterations_match_jax(port, inputs, dp, tp, case):
    x_host, draws = inputs
    _, schedule, over = next(c for c in CASES if c[0] == case)
    got = port[(dp, tp, case)][0]
    want = _jax_iterations(dp, tp, schedule, over, x_host, draws[case])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_training_matches_single_process(port, dp, tp, case):
    _, schedule, over = next(c for c in CASES if c[0] == case)
    got = port[(dp, tp, case)][1]
    want = _single(schedule, over).train(ITERS, seed=3)
    np.testing.assert_allclose(got, want.numpy(), **TOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_uncaptured_span_equals_the_eager_loop(port, dp, tp, case):
    """``train()`` on the CPU runs the eager loop; the graph's code,
    uncaptured, straight and in spans of one iteration, is its bits."""
    _, eager, graph, spans = port[(dp, tp, case)]
    np.testing.assert_array_equal(graph, eager)
    np.testing.assert_array_equal(spans, eager)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_run_span_refuses_a_gloo_group_on_a_card(port, dp, tp):
    for msg in port[(dp, tp, "refusal")]:
        assert msg is not None and "gloo" in msg and "run_iteration" in msg


def test_sharded_runners_reject_indivisible_shapes():
    """A batch or dim that does not split over dp or tp raises, without a
    process group (the split is checked before any collective); a row
    align that does not split over dp is raised to one that does."""
    from force2vec_tpu_torch.dist.spmd import SpmdAxes

    g = _graph()
    with pytest.raises(ValueError, match="dp=4"):
        Force2Vec(g, TrainConfig(dim=DIM, batch_size=15),
                  spmd=SpmdAxes(n_dp=4), device="cpu")
    with pytest.raises(ValueError, match="tp=3"):
        SyncForce2Vec(g, TrainConfig(dim=DIM), spmd=SpmdAxes(n_tp=3),
                      device="cpu")
    lay = SyncForce2Vec(g, TrainConfig(dim=DIM), row_align=6,
                        spmd=SpmdAxes(n_dp=4), device="cpu").layout
    assert lay.n_pad % 12 == 0
    assert all(b.count % 4 == 0 for b in lay.buckets)
