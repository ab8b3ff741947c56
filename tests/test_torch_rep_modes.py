"""``grouped_rep_force``'s three output modes against the JAX package.

The port's repulsion launch writes its sum one of three ways
(``force_kernels.REP_MODES``): ``store`` it, ``add`` it into the update,
or ``apply`` ``X += update + repulsion`` in place; the sync trainer picks
the mode (``SyncForce2Vec.rep_mode``).  Here, on the CPU, where the
wrapper runs the plain versions:

* each mode's plain version against ``force2vec_tpu.ops.pallas_force.
  grouped_rep_force`` in interpret mode (the table model, which that
  kernel cannot take, against the JAX model's jnp sample force, as the JAX
  package runs it with Pallas off), followed for ``add`` and ``apply`` by
  jnp's ``upd + rep`` and ``x + upd`` in X's dtype; f32 X within
  ``test_torch_kernels.py``'s 1e-5 / 1e-6, bf16 X within
  ``test_torch_x_dtype.py``'s 2^-6 of Σ|terms| plus 2^-7 of each value the
  mode rounds (the repulsion, each operand and the result; the dot models
  plus 2^-7 of their terms at a coefficient of 1);
* ``add`` and ``apply`` bit for bit against ``store`` followed by the
  ``add_``s, also with more samples than one launch's shared memory holds;
* ``SyncForce2Vec`` iterations in the modes the trainer derives (tdist and
  rwalk apply, linlog adds) against the JAX iterations, f32 and bf16 X, at
  ``test_torch_sync.py``'s and ``test_torch_x_dtype.py``'s tolerances, each
  launch bit for bit against the store launch and the ``add_``s composed
  from copies of its operands;
* the mode the trainer derives (apply at one rank, add with an energy
  update, store under dp, none where no grouped launch runs), and the
  refusal of ``apply`` with an energy model.
"""

import _jax_inline_dispatch  # noqa: F401  (first: before any JAX client)
import dataclasses
import functools

import numpy as np
import pytest
import torch

from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.convert import embedding_from_jax, embedding_to_numpy
from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk

C, GROUP, NS, STEP = 300, 128, 5, 0.02  # 3 groups, the last one ragged
DIMS = (8, 24, 100, 128)
# (port model, table sigmoid): tdist at every dim, the others at dim 24
MODELS = {"tdist": ("tdist", False), "sigmoid": ("sigmoid", False),
          "fr": ("fr", False), "sigmoid_table": ("sigmoid", True)}
CASES = ([("tdist", d) for d in DIMS]
         + [(m, 24) for m in ("sigmoid", "fr", "sigmoid_table")])
DTYPES = ("float32", "bfloat16")
F32_RTOL, F32_ATOL = 1e-5, 1e-6  # test_torch_kernels.py's


def _model(name):
    """The port's model, with an ``add`` update: the layout family (fr)
    updates by energy, where the trainer adds the repulsion into the
    update and ``apply`` is refused
    (``test_modes_refuse_operands_off_their_contract``), but its
    sample force runs every mode."""
    base, table = MODELS[name]
    return dataclasses.replace(get_model(base, sm_table=table), update="add")


def _jax_model(name):
    from force2vec_tpu.models.forces import get_model as jax_model

    base, table = MODELS[name]
    return jax_model(base, sm_table=table)


def _inputs(dim, dtype, seed):
    """xi [C, dim], samples [ng, NS, dim] (bf16, the gather replica's),
    and an out and an update of xi's shape at an update's size, all in
    X's dtype (the samples bf16), from one numpy seed."""
    rng = np.random.default_rng(seed)
    ng = -(-C // GROUP)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = getattr(torch, dtype)
    xi = torch.from_numpy(f(C, dim)).to(dt)
    sg = torch.from_numpy(f(ng, NS, dim)).bfloat16()
    out0 = torch.from_numpy(0.01 * f(C, dim)).to(dt)
    upd = torch.from_numpy(0.01 * f(C, dim)).to(dt)
    return xi, sg, out0, upd


def _j(t):
    """A torch tensor as a JAX array of its dtype, bit for bit."""
    import jax.numpy as jnp

    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@functools.lru_cache(maxsize=None)
def _jax_modes(name, dim, dtype):
    """JAX's repulsion of ``_inputs(dim, dtype, dim)`` in X's dtype, then
    jnp's ``out0 + rep`` and ``x + (upd + rep)``: {mode: f32 numpy}."""
    import jax.numpy as jnp

    from force2vec_tpu.ops.pallas_force import grouped_rep_force as jax_rep

    xi, sg, out0, upd = (_j(t) for t in _inputs(dim, dtype, dim))
    model = _jax_model(name)
    if name == "sigmoid_table":  # the jnp chain, as Pallas-off JAX runs it
        gid = jnp.arange(C) // GROUP
        rep = jnp.sum(model.sample_force(xi[:, None, :], sg[gid], STEP),
                      axis=1).astype(xi.dtype)
    else:
        rep = jax_rep(model, GROUP, xi, sg, STEP, interpret=True)
    assert rep.dtype == xi.dtype
    modes = {"store": rep, "add": out0 + rep, "apply": xi + (upd + rep)}
    return {m: np.asarray(v.astype(jnp.float32)) for m, v in modes.items()}


def _run(model, mode, xi, sg, out0, upd):
    """The wrapper in ``mode`` on copies of its operands."""
    kw = ({"out": out0.clone()} if mode == "add" else
          {"upd": upd.clone()} if mode == "apply" else {})
    return fk.grouped_rep_force(model, GROUP, xi.clone(), sg, STEP,
                                mode=mode, **kw)


def _bf16_bound(model, mode, xi, sg, out0, upd, want):
    """2^-6 of each element's Σ|terms| plus 2^-7 of every value the mode
    rounds: the repulsion, each operand it adds and the result (the dot
    models plus 2^-7 of their terms at a coefficient of 1)."""
    terms = fk.grouped_rep_force_terms(model, GROUP, xi, sg, STEP)
    bound = 2.0**-6 * terms.abs().sum(dim=1) + 2.0**-7 * (
        terms.sum(dim=1).abs() + want.abs())
    if mode == "add":
        bound += 2.0**-7 * out0.float().abs()
    if mode == "apply":
        bound += 2.0**-7 * (xi.float().abs() + upd.float().abs())
    if model.a_kind == "dot":
        gid = torch.arange(C) // GROUP
        unit = lambda v: torch.full_like(  # noqa: E731
            v.sum(dim=-1, keepdim=True), float("inf"))
        bound += 2.0**-7 * model.sample_force(
            xi.float()[:, None, :], sg[gid].float(), STEP,
            rsum=unit).abs().sum(dim=1)
    return bound


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,dim", CASES)
@pytest.mark.parametrize("mode", fk.REP_MODES)
def test_plain_mode_matches_jax(mode, name, dim, dtype):
    model = _model(name)
    xi, sg, out0, upd = _inputs(dim, dtype, dim)
    got = _run(model, mode, xi, sg, out0, upd)
    assert got.dtype == xi.dtype and got.shape == xi.shape
    want = torch.from_numpy(_jax_modes(name, dim, dtype)[mode].copy())
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_RTOL,
                                   atol=F32_ATOL)
        return
    bound = _bf16_bound(model, mode, xi, sg, out0, upd, want)
    d = (got.float() - want).abs()
    ratio = float(torch.where(d == 0, 0.0, d / bound).max())
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("ns", [NS, 40], ids=["ns5", "chunked"])
def test_add_and_apply_equal_store_then_add(ns, name, dtype):
    """``add`` is ``out.add_(store)`` and ``apply`` is ``upd.add_(store);
    x.add_(upd)``, bit for bit, with ``upd`` left as it was; at dim 1024,
    40 samples pass one launch's shared memory (chunked on the card)."""
    dim = 128 if ns == NS else 1024
    assert ns * dim * 4 > fk._MAX_SAMPLE_BYTES or ns == NS
    model = _model(name)
    xi, _, out0, upd = _inputs(dim, dtype, 5)
    sg = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (-(-C // GROUP), ns, dim)).astype(np.float32)).bfloat16()
    store = fk.grouped_rep_force(model, GROUP, xi, sg, STEP)
    assert torch.equal(store, fk.grouped_rep_force_terms(
        model, GROUP, xi, sg, STEP).sum(dim=1).to(xi.dtype))
    out = out0.clone()
    assert fk.grouped_rep_force(model, GROUP, xi, sg, STEP, mode="add",
                                out=out) is out
    assert torch.equal(out, out0.clone().add_(store))
    x, u = xi.clone(), upd.clone()
    assert fk.grouped_rep_force(model, GROUP, x, sg, STEP, mode="apply",
                                upd=u) is x
    assert torch.equal(u, upd)
    assert torch.equal(x, xi.clone().add_(upd.clone().add_(store)))


def test_modes_refuse_operands_off_their_contract():
    model = _model("tdist")
    xi, sg, out0, upd = _inputs(24, "float32", 3)
    for kw, match in (({"mode": "keep"}, "not in"),
                      ({"mode": "add"}, "needs out"),
                      ({"mode": "apply"}, "needs upd"),
                      ({"mode": "store", "out": out0}, "takes no out"),
                      ({"mode": "add", "out": out0, "upd": upd},
                       "takes no upd"),
                      ({"mode": "add", "out": out0[:10]}, "out"),
                      ({"mode": "apply", "upd": upd.bfloat16()}, "upd")):
        with pytest.raises(ValueError, match=match):
            fk.grouped_rep_force(model, GROUP, xi, sg, STEP, **kw)
    with pytest.raises(ValueError, match="energy"):
        fk.grouped_rep_force(get_model("linlog"), GROUP, xi, sg, STEP,
                             mode="apply", upd=upd)
    with pytest.raises(ValueError, match="energy"):
        fk.grouped_rep_force_plain(get_model("fr"), GROUP, xi, sg, STEP,
                                   mode="apply", upd=upd)


# -- the sync trainer ---------------------------------------------------------

DIM, BS, ITERS = 16, 8, 3
LAYOUT = dict(min_width=4, hub_width=8)
SYNC_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}  # test_torch_sync.py's,
ENERGY_TOL = {"float32": 1e-5, "bfloat16": 3.2e-2}  # test_torch_x_dtype.py's
SYNC_MODELS = {"tdist": "apply", "rwalk": "apply", "linlog": "add",
               "sigmoid": "apply"}


@pytest.fixture(scope="module")
def graph():
    return synth_powerlaw_graph(n=400, avg_deg=6, seed=3)


def _draws(graph, n_pad, walk):
    rng = np.random.default_rng(17)
    x0 = (rng.random((graph.n, DIM)) * 2 - 1).astype(np.float32)
    draws = []
    for _ in range(ITERS):
        negs = rng.integers(0, graph.n - 1,
                            size=(-(-n_pad // BS), 4)).astype(np.int32)
        walks = (rng.integers(0, graph.n, size=(n_pad, 5)).astype(np.int32)
                 if walk else None)
        draws.append((negs, walks))
    return x0, draws


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", ["tdist", "rwalk", "linlog"])
def test_sync_iterations_in_their_mode_match_jax(graph, model, dtype,
                                                monkeypatch):
    """The trainer's mode (apply, or add with an energy update) against the
    JAX iteration's ``x + (upd + rep)`` (its Pallas kernels in interpret
    mode); each launch bit for bit against the store launch and the
    ``add_``s."""
    from jax.experimental.pallas import tpu as pltpu

    from force2vec_tpu.graphs.csr import Graph as JaxGraph
    from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    kw = dict(dim=DIM, batch_size=BS, model=model, ns=4, dtype=dtype)
    with pltpu.force_tpu_interpret_mode():
        jfv = JaxSync(JaxGraph(graph.n, graph.rowptr, graph.colids),
                      JaxConfig(**kw), use_pallas=True, **LAYOUT)
        x0, draws = _draws(graph, jfv.layout.n_pad, model == "rwalk")
        xj = jfv.pad_embedding(x0)
        for negs, walks in draws:
            xj = jfv.run_iteration(xj, negs, walks=walks)
    tfv = SyncForce2Vec(graph, TrainConfig(**kw), device="cpu", **LAYOUT)
    assert tfv.rep_mode == SYNC_MODELS[model]
    launches = []
    real = fk.grouped_rep_force

    def composed(model, group, xi, sg, step, *, mode="store", out=None,
                 upd=None):
        # the store launch and the add_s, from copies of the operands
        rep = real(model, group, xi, sg, step)
        want = (out.clone().add_(rep) if mode == "add" else
                xi.clone().add_(upd.clone().add_(rep)))
        got = real(model, group, xi, sg, step, mode=mode, out=out, upd=upd)
        launches.append((mode, torch.equal(got, want)))
        return got

    monkeypatch.setattr(fk, "grouped_rep_force", composed)
    xt = embedding_from_jax(np.asarray(jfv.pad_embedding(x0)), "cpu")
    for negs, walks in draws:
        assert tfv.run_iteration(xt, negs, walks=walks) is xt
    assert launches == [(SYNC_MODELS[model], True)] * ITERS
    tol = (ENERGY_TOL if model == "linlog" else SYNC_TOL)[dtype]
    np.testing.assert_allclose(embedding_to_numpy(xt, DIM),
                               np.asarray(xj).astype(np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("model", list(SYNC_MODELS))
def test_trainer_picks_the_mode_and_apply_makes_no_add(graph, model,
                                                       monkeypatch):
    """At one rank the iteration's last repulsion call applies X (no
    ``add_`` after it, no separate X += update) or, with an energy update,
    adds into the update; under dp the rank stores its slice."""
    cfg = TrainConfig(dim=DIM, batch_size=BS, model=model, ns=4)
    fv = SyncForce2Vec(graph, cfg, device="cpu", **LAYOUT)
    assert fv.rep_mode == SYNC_MODELS[model]
    dp = SyncForce2Vec(graph, cfg, device="cpu",
                       spmd=SpmdAxes(n_dp=2, dp_index=0), **LAYOUT)
    assert dp.rep_mode == "store"
    modes = []
    real = fk.grouped_rep_force_plain

    def spy(*args, mode="store", **kw):
        modes.append(mode)
        return real(*args, mode=mode, **kw)

    monkeypatch.setattr(fk, "grouped_rep_force_plain", spy)
    x = fv.init_embedding(seed=2)
    negs = np.random.default_rng(4).integers(
        0, graph.n - 1, size=fv._neg_shape).astype(np.int32)
    walks = (fv.draw_walks(torch.Generator().manual_seed(4))
             if model == "rwalk" else None)
    adds = []
    add_ = torch.Tensor.add_

    def counted(t, *args, **kw):
        adds.append(t.shape)
        return add_(t, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "add_", counted)
    fv.run_iteration(x, negs, walks=walks, plain=True)
    monkeypatch.undo()
    assert modes == [SYNC_MODELS[model]]
    # apply: the one add_ is the plain apply's own x.add_; add: the plain
    # add's out.add_ and X += update
    assert len(adds) == (1 if SYNC_MODELS[model] == "apply" else 2)


@pytest.mark.parametrize("kw,mode", [
    (dict(), "apply"),
    (dict(model="rwalk"), "apply"),
    (dict(model="linlog"), "add"),
    (dict(model="forceatlas"), "add"),
    (dict(spmd=SpmdAxes(n_dp=2, dp_index=1)), "store"),
    (dict(model="linlog", spmd=SpmdAxes(n_dp=2, dp_index=0)), "store"),
    (dict(per_vertex_samples=True), None),
], ids=["tdist", "rwalk", "linlog", "forceatlas", "tdist-dp", "linlog-dp",
        "per-vertex"])
def test_trainer_derives_its_mode(graph, kw, mode):
    """The constructor's mode: apply at one rank with an add update, add
    with an energy update (which normalises the update before X takes it),
    store under dp (each rank's slice, gathered), none where no grouped
    launch runs."""
    spmd = kw.pop("spmd", SpmdAxes())
    cfg = TrainConfig(dim=DIM, batch_size=BS, ns=4, **kw)
    assert SyncForce2Vec(graph, cfg, device="cpu", spmd=spmd,
                         **LAYOUT).rep_mode == mode
