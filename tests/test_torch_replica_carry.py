"""The carried replica of the sync trainer (``SyncForce2Vec.replica_carry``)
on the CPU, where the wrappers run their plain versions.

Where a launch writes every row of an f32 X beside a bf16 or f16 replica
(the fused pass, or the grouped repulsion's ``apply``), it also writes the
replica the next iteration gathers from, and no cast of X runs between
iterations.  Held here:

* X after 8 iterations with the carry equals X with a fresh cast each
  iteration, bit for bit, through ``span_graph.run_uncaptured`` and the
  eager loop, in one span and in several: group-shared negatives with and
  without hub rows (the owners' launch), ``-bs 1``, rwalk, an f16 replica;
* every way X can change between spans (a new X, X altered in place, a
  ``run_iteration``, a span that does not start where the last ended, a
  launch that writes X) casts again (``replica.casts`` rises) and still
  equals a trainer that casts each iteration;
* the paths that bypass the carry (f32 gathers, 2-byte X, an energy model,
  dp, tp) hold no replica, capture one body and count no carried
  iteration;
* the wrappers' ``xg_next``: the new rows rounded as ``x.to(dtype)``
  rounds them, and the refusals;
* ``portbench/metrics/replica_carry_share.py`` reads the counters.
"""

import numpy as np
import pytest
import torch

from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.train.trainer import iteration_seed
from force2vec_tpu_torch.utils import profiling

DIM, NS, BS, ITERS, SEED = 16, 4, 10, 8, 5
LAYOUT = dict(min_width=4, hub_width=8)


@pytest.fixture(scope="module")
def graph():
    # 397 vertices: 3 padding rows at row_align 8, and a hub bucket
    return synth_powerlaw_graph(n=397, avg_deg=6, seed=3)


@pytest.fixture(autouse=True)
def fresh_counters():
    torch.set_num_threads(1)
    profiling.reset()
    fk.reset_launch_counts()
    yield
    profiling.reset()
    fk.reset_launch_counts()


def _trainer(graph, layout=LAYOUT, spmd=SpmdAxes(), **kw):
    """An f32 X beside a bf16 replica, unless ``kw`` says otherwise."""
    cfg = {**dict(dim=DIM, batch_size=BS, ns=NS, gather_dtype="bfloat16"),
           **kw}
    return SyncForce2Vec(graph, TrainConfig(**cfg), device="cpu", spmd=spmd,
                         **layout)


def _cast_each_iteration(fv, x, seed, its):
    """Iterations ``its`` of a span on X in place, each gathering from a
    fresh cast of X: the iteration as it ran before the carry."""
    for it in its:
        fv._span_gen.manual_seed(iteration_seed(seed, it))
        negs, walks = fv._draw(fv._span_gen)
        fv._iteration(x, negs, walks, fv._step(it), plain=False)
    return x


def _counts():
    c = profiling.snapshot()["counters"]
    return c.get("replica.carried", 0), c.get("replica.casts", 0)


CARRIED = {
    "group": (dict(), LAYOUT, 2),
    "group, no hub": (dict(), dict(min_width=4, hub_width=4096), 2),
    "-bs 1": (dict(per_vertex_samples=True), LAYOUT, 2),
    "f16 replica": (dict(gather_dtype="float16"), LAYOUT, 2),
    "rwalk": (dict(model="rwalk"), LAYOUT, 1),
}


@pytest.mark.parametrize("spans", [(8,), (3, 1, 4)], ids=["one", "three"])
@pytest.mark.parametrize("how", ["uncaptured", "eager"])
@pytest.mark.parametrize("name", list(CARRIED))
def test_carried_replica_is_the_cast_bit_for_bit(graph, name, how, spans):
    kw, layout, k = CARRIED[name]
    fv = _trainer(graph, layout, **kw)
    assert fv.replica_carry == k
    if fv.model.attraction == "csr":  # the owners' launch, or none
        assert (fv._hub is not None) is (layout["hub_width"] == 8)
    x0 = fv.init_embedding(seed=2)
    x, want = x0.clone(), x0.clone()
    run = (fv.span_graph.run_uncaptured if how == "uncaptured"
           else fv._run_span_eager)
    done = 0
    for n in spans:
        assert run(x, SEED, n, done) is x
        done += n
    _cast_each_iteration(_trainer(graph, layout, **kw), want, SEED,
                         range(ITERS))
    assert torch.equal(x, want)
    assert not torch.equal(x, x0) and bool(torch.isfinite(x).all())
    # one cast for the new X, every later iteration carried
    assert _counts() == (ITERS - 1, 1)
    assert len(fv._replicas) == k
    # the replica the next iteration gathers from is X's cast
    assert torch.equal(fv._replicas[ITERS % k], x.to(fv._gdt))


def _new_x(fv, x):
    """A new X of other values (``pad_embedding``), as a resumed run
    makes."""
    emb = fv.unpad_embedding(x).clone().mul_(0.5)
    return fv.pad_embedding(emb)


def _injected_iteration(fv, x):
    """``run_iteration`` with injected negatives (and walks)."""
    rng = np.random.default_rng(1)
    negs = rng.integers(0, fv.graph.n - 1, size=fv._neg_shape)
    walks = (rng.integers(0, fv.graph.n, size=(fv.layout.n_pad, 5))
             if fv.model.attraction == "walk" else None)
    return fv.run_iteration(x, negs, walks=walks)


CHANGES = {
    "a new X": lambda fv, x: _new_x(fv, x),
    "copy_ of a loaded X": lambda fv, x: x.copy_(_new_x(fv, x)),
    "one element written": lambda fv, x: x.index_put_(
        (torch.tensor([1]), torch.tensor([0])), torch.tensor(0.25)),
    "run_iteration": lambda fv, x: _injected_iteration(fv, x),
    "a launch that writes X": lambda fv, x: fk.launch_counts.__setitem__(
        "ell_edge_apply", fk.launch_counts["ell_edge_apply"] + 1) or x,
}


@pytest.mark.parametrize("model", ["tdist", "rwalk"])
@pytest.mark.parametrize("change", list(CHANGES) + ["a later start"])
def test_every_change_between_spans_casts_again(graph, change, model):
    fv = _trainer(graph, model=model)
    ref = _trainer(graph, model=model)
    x0 = fv.init_embedding(seed=2)
    x, want = x0.clone(), x0.clone()
    fv.span_graph.run_uncaptured(x, SEED, 4, 0)
    _cast_each_iteration(ref, want, SEED, range(4))
    assert _counts() == (3, 1)
    start = 4
    if change == "a later start":
        start = 6
    else:
        x = CHANGES[change](fv, x)
        want = CHANGES[change](ref, want)
    assert torch.equal(x, want)
    fv.span_graph.run_uncaptured(x, SEED, 4, start)
    _cast_each_iteration(ref, want, SEED, range(start, start + 4))
    assert torch.equal(x, want)
    assert _counts() == (6, 2)  # the change cast again
    # nothing between spans: the next span carries
    fv._run_span_eager(x, SEED, 2, start + 4)
    _cast_each_iteration(ref, want, SEED, range(start + 4, start + 6))
    assert torch.equal(x, want)
    assert _counts() == (8, 2)


def test_a_span_that_raises_leaves_no_carried_replica(graph, monkeypatch):
    fv = _trainer(graph)
    x = fv.init_embedding(seed=2)
    fv._run_span_eager(x, SEED, 2, 0)
    real = fv._draw
    monkeypatch.setattr(fv, "_draw", lambda gen: (_ for _ in ()).throw(
        RuntimeError("draw")))
    with pytest.raises(RuntimeError):
        fv._run_span_eager(x, SEED, 2, 2)
    monkeypatch.setattr(fv, "_draw", real)
    fv._run_span_eager(x, SEED, 2, 2)
    assert _counts() == (1 + 1, 2)


BYPASSED = [
    ("f32 replica", dict(gather_dtype="float32"), {}),
    ("no replica", dict(gather_dtype=None), {}),
    ("bf16 X", dict(dtype="bfloat16"), {}),
    ("f16 X", dict(dtype="float16", gather_dtype="float16"), {}),
    ("f16 X, bf16 replica", dict(dtype="float16"), {}),
    ("fr", dict(model="fr"), {}),
    ("linlog", dict(model="linlog"), {}),
    ("-bs 1 rwalk", dict(model="rwalk", per_vertex_samples=True), {}),
    ("dp 2", dict(), dict(spmd=SpmdAxes(n_dp=2, dp_index=1))),
    ("tp 2", dict(), dict(spmd=SpmdAxes(n_tp=2, tp_index=0))),
]


@pytest.mark.parametrize("kw,extra", [(kw, extra) for _, kw, extra in BYPASSED],
                         ids=[w for w, _, _ in BYPASSED])
def test_bypassed_paths_carry_nothing(graph, kw, extra):
    fv = _trainer(graph, **kw, **extra)
    assert fv.replica_carry == 0
    g = fv.span_graph
    assert len(g._bodies) == 1 and g._start is None and g._end is None
    if fv.spmd.n_dp == fv.spmd.n_tp == 1:
        x = fv.init_embedding(seed=2)
        g.run_uncaptured(x, SEED, 3, 0)
        fv._run_span_eager(x, SEED, 3, 3)
    assert fv._replicas is None
    assert _counts() == (0, 0)


# -- the wrappers ---------------------------------------------------------------


def _apply_operands(fv, seed=0):
    x = fv.init_embedding(seed=3)
    negs = torch.as_tensor(np.random.default_rng(seed).integers(
        0, fv.graph.n - 1, size=fv._neg_shape), dtype=torch.int32)
    return x, x.to(fv._gdt), negs


@pytest.mark.parametrize("gather", ["bfloat16", "float16"])
def test_ell_edge_apply_writes_the_next_replica(graph, gather):
    fv = _trainer(graph, gather_dtype=gather)
    x, xg, negs = _apply_operands(fv)
    table, apply = fv.apply_table
    x1, x2 = x.clone(), x.clone()
    nxt = torch.full_like(xg, 7.0)
    args = (fv.model, xg, table, apply, fv.inv_deg, negs, BS, 0.02)
    fk.ell_edge_apply(fv.model, x1, *args[1:])
    fk.ell_edge_apply(fv.model, x2, *args[1:], xg_next=nxt)
    assert torch.equal(x1, x2)
    rows = fk.applied_rows(table, apply)
    assert torch.equal(nxt[rows], x2[rows].to(xg.dtype))
    others = torch.ones(fv.layout.n_pad, dtype=torch.bool)
    others[rows] = False
    assert bool((nxt[others] == 7.0).all())  # the hub's owners: not applied
    for bad, what in ((xg, "its own replica"),
                      (x2, "x"),
                      (torch.zeros_like(x2), "f32"),
                      (torch.zeros((3, DIM), dtype=xg.dtype), "shape"),
                      (torch.zeros_like(xg, dtype=torch.float16
                                        if gather == "bfloat16"
                                        else torch.bfloat16), "dtype")):
        with pytest.raises(ValueError):
            fk.ell_edge_apply(fv.model, x2, *args[1:], xg_next=bad)


def test_grouped_apply_writes_the_next_replica(graph):
    fv = _trainer(graph, model="rwalk")
    model = get_model("rwalk")
    x, xg, negs = _apply_operands(fv)
    sg = xg[negs.long()]
    upd = torch.randn_like(x) * 0.01
    x1, x2 = x.clone(), x.clone()
    fk.grouped_rep_force(model, BS, x1, sg, 0.02, mode="apply", upd=upd)
    # one replica serves: the launch reads only its samples
    got = fk.grouped_rep_force(model, BS, x2, sg, 0.02, mode="apply",
                               upd=upd, xg_next=xg)
    assert got is x2 and torch.equal(x1, x2)
    assert torch.equal(xg, x2.to(torch.bfloat16))
    for mode, kw in (("store", {}), ("add", {"out": torch.zeros_like(x)})):
        with pytest.raises(ValueError):
            fk.grouped_rep_force(model, BS, x2, sg, 0.02, mode=mode,
                                 xg_next=xg, **kw)
    for bad in (torch.zeros_like(x2), x2,
                torch.zeros((3, DIM), dtype=torch.bfloat16)):
        with pytest.raises(ValueError):
            fk.grouped_rep_force(model, BS, x2, sg, 0.02, mode="apply",
                                 upd=upd, xg_next=bad)
    with pytest.raises(ValueError):  # kStoresReplica: the sigmoid family
        fk.grouped_rep_force(get_model("tdist"), BS, x2, sg, 0.02,
                             mode="apply", upd=upd, xg_next=xg)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):  # a 2-byte X is its own replica
        fk.grouped_rep_force(model, BS, xb, xb[negs.long()], 0.02,
                             mode="apply", upd=upd.to(torch.bfloat16),
                             xg_next=torch.zeros_like(xb))


# -- the metric ------------------------------------------------------------------


def test_replica_carry_share_reads_the_counters(graph):
    from portbench import spec

    read = spec.reader("replica_carry_share")
    assert read({}) is None  # a program that counts neither
    fv = _trainer(graph)
    x = fv.init_embedding(seed=2)
    for it in range(4):
        fv._run_span_eager(x, SEED, 1, it)
    assert _counts() == (3, 1)
    assert read({}) == 75.0
