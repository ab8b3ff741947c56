"""The sync iteration's fused pass (``force_kernels.ell_edge_apply``) on
the CPU, where the wrapper runs its plain version.

* the fused pass's plain iteration against the separate passes' plain
  iteration (edge kernel, hub sums, repulsion, ``X += update``), bit for
  bit, over three iterations: group-shared and per-vertex negatives, bf16
  and f16 replicas, tdist and the sigmoid table model, on a graph with a
  hub bucket and padding rows whose hub owners start inside a group of
  negatives;
* the constructor's engagement rule, as a table of configurations;
* the launches: ``ell_edge_apply`` once an iteration (twice with a hub:
  the owner rows), and no other force kernel, in the eager loop and in
  ``span_graph.run_uncaptured``;
* the two launches' tables apply every row of X once, and the
  constructor refuses tables that do not;
* the wrapper's and ``apply_table``'s refusals.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk

DIM, NS, BS, ITERS, SEED = 16, 4, 10, 3, 5
LAYOUT = dict(min_width=4, hub_width=8)
KERNELS = ("ell_edge_apply", "ell_edge_force", "grouped_rep_force",
           "ell_sample_force")


@pytest.fixture(scope="module")
def graph():
    # 397 vertices: 3 padding rows at row_align 8
    return synth_powerlaw_graph(n=397, avg_deg=6, seed=3)


def _trainer(graph, layout=LAYOUT, model="tdist", spmd=SpmdAxes(), **kw):
    """A trainer on ``graph``: f32 X, a bf16 replica, unless ``kw`` says
    otherwise; ``model`` ``sigmoid_table`` is sigmoid with the table's σ."""
    cfg = {**dict(dim=DIM, batch_size=BS, ns=NS, gather_dtype="bfloat16"),
           **kw}
    table = model == "sigmoid_table"
    return SyncForce2Vec(graph, TrainConfig(
        model="sigmoid" if table else model, sm_table=table, **cfg),
        device="cpu", spmd=spmd, **layout)


def _separate(fv):
    """``fv`` with the separate passes: the trainer the constructor builds
    where the fused pass does not engage (the repulsion's mode as it
    derives it at one rank)."""
    sep = copy.copy(fv)
    sep.fused_apply = False
    sep.rep_mode = None if fv.config.per_vertex_samples else "apply"
    return sep


@pytest.mark.parametrize("model", ["tdist", "sigmoid_table"])
@pytest.mark.parametrize("gather", ["bfloat16", "float16"])
@pytest.mark.parametrize("per_vertex", [False, True], ids=["group", "bs1"])
def test_fused_plain_iteration_is_the_separate_passes_bit_for_bit(
        graph, per_vertex, gather, model):
    fv = _trainer(graph, gather_dtype=gather, per_vertex_samples=per_vertex,
                  model=model)
    lay, hub = fv.layout, fv._hub
    assert fv.fused_apply and fv.rep_mode is None
    # the suffix the second launch applies: hub owners starting inside a
    # group of negatives, and padding rows after them
    assert hub is not None and hub.start % BS and lay.n_pad > lay.n
    sep = _separate(fv)
    x0 = fv.init_embedding(seed=2)
    rng = np.random.default_rng(0)
    a, b = x0.clone(), x0.clone()
    for it in range(ITERS):
        negs = rng.integers(0, graph.n - 1, size=fv._neg_shape)
        step = fv._step(it)
        assert fv.run_iteration(a, negs, step=step, plain=True) is a
        sep.run_iteration(b, negs, step=step, plain=True)
        assert torch.equal(a, b), f"iteration {it}"
    assert not torch.equal(a, x0)
    assert torch.isfinite(a).all()


ENGAGED = [
    ("tdist bf16 replica", dict(), {}),
    ("tdist f16 replica", dict(gather_dtype="float16"), {}),
    ("-bs 1", dict(per_vertex_samples=True), {}),
    ("sigmoid", dict(model="sigmoid"), {}),
    ("sigmoid table", dict(model="sigmoid_table"), {}),
]
BYPASSED = [
    ("bf16 X", dict(dtype="bfloat16"), {}),
    ("f16 X", dict(dtype="float16", gather_dtype="float16"), {}),
    ("no replica", dict(gather_dtype=None), {}),
    ("f32 replica", dict(gather_dtype="float32"), {}),
    ("fr", dict(model="fr"), {}),
    ("rwalk", dict(model="rwalk"), {}),
    ("dp 2", dict(), dict(spmd=SpmdAxes(n_dp=2, dp_index=1))),
    ("tp 2", dict(), dict(spmd=SpmdAxes(n_tp=2, tp_index=0))),
]


@pytest.mark.parametrize(
    "kw,extra,engaged",
    [(kw, extra, True) for _, kw, extra in ENGAGED]
    + [(kw, extra, False) for _, kw, extra in BYPASSED],
    ids=[w for w, _, _ in ENGAGED] + [w for w, _, _ in BYPASSED])
def test_the_constructor_engages_the_fused_pass(graph, kw, extra, engaged):
    """One rank, a CSR model with an add update, and a replica of its own
    (an f32 X beside a bf16 or f16 gather dtype); every other configuration
    keeps the separate passes and their tables."""
    fv = _trainer(graph, **kw, **extra)
    assert fv.fused_apply is engaged
    assert (fv.apply_table is not None) is engaged
    assert (fv.owner_table is not None) is engaged  # the graph has a hub
    if not engaged and fv.spmd.n_dp == fv.spmd.n_tp == 1 and (
            fv.model.attraction == "csr"
            and not fv.config.per_vertex_samples):
        assert fv.rep_mode is not None  # the grouped launch still runs


@pytest.fixture
def counted(monkeypatch):
    """Each force wrapper raising its launch count, as on the card."""
    fk.reset_launch_counts()
    for name in KERNELS:
        real = getattr(fk, name)

        def launch(*args, _real=real, _name=name, **kw):
            fk.launch_counts[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(fk, name, launch)
    yield fk.launch_counts
    fk.reset_launch_counts()


@pytest.mark.parametrize("hub_width", [8, 4096], ids=["hub", "no-hub"])
@pytest.mark.parametrize("per_vertex", [False, True], ids=["group", "bs1"])
def test_fused_launches_an_iteration_eager_and_uncaptured(
        graph, counted, per_vertex, hub_width):
    fv = _trainer(graph, layout=dict(min_width=4, hub_width=hub_width),
                  per_vertex_samples=per_vertex)
    assert (fv._hub is not None) is (hub_width == 8)
    per_iter = 2 if fv._hub is not None else 1
    x0 = fv.init_embedding(seed=1)
    eager, replayed = x0.clone(), x0.clone()
    fv._run_span_eager(eager, SEED, ITERS)
    got = {k: counted[k] for k in KERNELS}
    assert got == {"ell_edge_apply": per_iter * ITERS, "ell_edge_force": 0,
                   "grouped_rep_force": 0, "ell_sample_force": 0}
    fk.reset_launch_counts()
    fv.span_graph.run_uncaptured(replayed, SEED, ITERS)
    assert {k: counted[k] for k in KERNELS} == got
    assert torch.equal(replayed, eager)


def test_fused_launch_refuses_operands_off_its_contract(graph):
    fv = _trainer(graph)
    x = fv.init_embedding(seed=1)
    xg = x.to(torch.bfloat16)
    negs = torch.zeros(fv._neg_shape, dtype=torch.int32)
    (t, apply), model = fv.apply_table, fv.model
    ok = dict(model=model, x=x, xg=xg, table=t, apply=apply,
              invd=fv.inv_deg, negs=negs, group=BS, step=0.02)
    fk.ell_edge_apply(**{**ok, "x": x.clone()})
    for bad in (dict(model=get_model("fr")),  # an energy update
                dict(model=get_model("rwalk")),  # walks
                dict(xg=x.clone()),  # an f32 replica
                dict(x=x.to(torch.bfloat16), xg=xg,
                     invd=fv.inv_deg.to(torch.bfloat16)),  # a 2-byte X
                dict(xg=x),  # X as its own gather table
                dict(negs=negs[:-1]),  # too few sets for the rows
                dict(negs=negs.long()),
                dict(group=0),
                dict(apply=apply[:-1])):  # a flag short
        with pytest.raises(ValueError):
            fk.ell_edge_apply(**{**ok, **bad})
    # the hub's virtual rows (storing) read the owners' x, which the
    # filler entry of the separate passes' table would apply
    n_pad = fv.layout.n_pad
    with pytest.raises(ValueError):
        fk.apply_table(fv.edge_table, [ob != n_pad for ob in
                                       fv.edge_table.entries[:, 2]])
    with pytest.raises(ValueError):  # the owners applied twice
        fk.apply_table(fv.edge_table, [True] * len(fv.edge_table.entries))


@pytest.mark.parametrize("hub_width", [8, 4096], ids=["hub", "no-hub"])
@pytest.mark.parametrize("drop", [None, "row 0", "last"])
def test_fused_tables_apply_every_row_once(graph, hub_width, drop):
    """The tables ``_fused_tables`` builds apply each of X's n_pad rows
    exactly once over both launches; an edge table that leaves an entry
    out (its rows then never take their update) is refused."""
    fv = _trainer(graph, layout=dict(min_width=4, hub_width=hub_width))
    tables = [t for t in (fv.apply_table, fv.owner_table) if t]
    rows = torch.cat([fk.applied_rows(*t) for t in tables])
    assert torch.equal(torch.sort(rows).values,
                       torch.arange(fv.layout.n_pad))
    if drop is None:
        return
    t = fv.edge_table
    # the entry of X's row 0, or the last: the width-0 rows and padding
    keep = (t.entries[:, 2] != 0 if drop == "row 0" else
            np.arange(len(t.entries)) < len(t.entries) - 1)
    fv.edge_table = dataclasses.replace(t, entries=t.entries[keep])
    with pytest.raises(ValueError, match="every row of X once"):
        fv._fused_tables()
