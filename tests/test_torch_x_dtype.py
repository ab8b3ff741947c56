"""X held in bf16 (``TrainConfig(dtype="bfloat16")``) against the JAX
package, which holds X, ``inv_deg`` and the step in ``config.dtype``.

The JAX package computes a bf16 X's forces in bf16 (its jnp path and its
elementwise Pallas kernels round every product and sum; its MXU kernel
forms ‖x_i‖² in bf16 and casts the f32 sum once); the port computes each
force in f32 from X's values and rounds it to bf16 once.  So the two agree
to bf16 rounding, not bit for bit, and every bound here says which
rounding it covers:

* sync iterations, three of them, on injected negatives and walks, on
  the JAX package's jnp path and its Pallas kernels in interpret mode:
  atol = rtol = 1.6e-2 (about 4 bf16 ulps at 1) for the add models; the
  layout family's energy apply moves each row by a unit-norm step whose
  direction JAX forms in bf16, so it takes 3.2e-2.  A sanity bound shows
  the difference is rounding, not another function: the port's bf16 run
  lies no farther from JAX's f32 run than JAX's own bf16 run does, ×1.25
  (max |ΔX|; mean |ΔX| for the layout family, whose maximum over a few
  hundred unit-step moves is one rounding's luck: 0.65–1.43 of JAX's over
  four seeds, the mean 0.86–1.05);
* each plain kernel version against its Pallas kernel: |Δ| ≤ 2^-6 of the
  element's Σ|terms| plus 2^-7 of its value, and for the sigmoid family
  plus 2^-7 of the terms at a coefficient of 1 (JAX's bf16 σ resolves 1 − σ
  only to a bf16 ulp of 1);
* the tp step (the split-dim pair's plain versions on 2 gloo ranks), the
  batch trainer and the vertex schedule (P = 1 here, P = 2 on gloo ranks)
  against the JAX runners at 1.6e-2, the batch trainer's layout family at
  3.2e-2 (plain torch in bf16 on both sides, rounded at other places: torch
  rounds each operation, XLA a fused chain);
* ``convert`` and checkpoints bit for bit, both ways, and the trainers'
  refusal of the dtypes the kernels lack (float16, float64).

The module imports no JAX at the top: its gloo ranks import it.
"""

import contextlib
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from force2vec_tpu_torch import Force2Vec, SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.convert import (embedding_from_jax,
                                         embedding_to_numpy)
from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.dist.vertex_sharded import VertexShardedForce2Vec
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  save_checkpoint,
                                                  train_with_checkpoints)

DIM, NS, BS, ITERS = 16, 4, 8, 3
LAYOUT = dict(min_width=4, hub_width=8)
GRAPH = dict(n=400, avg_deg=6, seed=3)
TOL = 1.6e-2  # about 4 bf16 ulps at 1
ENERGY_TOL = 3.2e-2
SANITY = 1.25
BF16 = "bfloat16"


def _graph():
    return synth_powerlaw_graph(**GRAPH)


def _jax_graph(g):
    from force2vec_tpu.graphs.csr import Graph as JaxGraph

    return JaxGraph(g.n, g.rowptr, g.colids)


def _jax_model(name):
    from force2vec_tpu.models.forces import get_model as jax_model

    return jax_model(name)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- sync iterations against the JAX package ----------------------------------

# (case, model, per-vertex negatives)
SYNC_CASES = [
    ("tdist", "tdist", False),
    ("tdist_per_vertex", "tdist", True),
    ("rwalk", "rwalk", False),
    ("sigmoid", "sigmoid", False),
    ("fr", "fr", False),
    ("linlog", "linlog", False),
    ("forceatlas", "forceatlas", False),
]


def _sync_kw(model, per_vertex, dtype):
    return dict(dim=DIM, batch_size=BS, model=model, ns=NS,
                per_vertex_samples=per_vertex, dtype=dtype)


def _sync_draws(jfv, per_vertex, walk):
    """X and ITERS injected negatives (and walks), from one numpy seed."""
    g = jfv.graph
    rng = np.random.default_rng(17)
    x0 = (rng.random((g.n, DIM)) * 2 - 1).astype(np.float32)
    n_pad = jfv.layout.n_pad
    shape = (n_pad, NS) if per_vertex else (-(-n_pad // BS), NS)
    draws = []
    for _ in range(ITERS):
        negs = rng.integers(0, g.n - 1, size=shape).astype(np.int32)
        walks = (rng.integers(0, g.n, size=(n_pad, 5)).astype(np.int32)
                 if walk else None)
        draws.append((negs, walks))
    return x0, draws


def _steps(model):
    m = _jax_model(model)
    return [m.default_lr * (0.999 ** it if m.lr_schedule == "decay999"
                            else 1.0) for it in range(ITERS)]


def _jax_sync(model, per_vertex, dtype, pallas):
    """The JAX package's sync run: the runner, its X after ITERS
    iterations and the draws."""
    from jax.experimental.pallas import tpu as pltpu

    from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    g = _jax_graph(_graph())
    ctx = (pltpu.force_tpu_interpret_mode() if pallas
           else contextlib.nullcontext())
    with ctx:
        jfv = JaxSync(g, JaxConfig(**_sync_kw(model, per_vertex, dtype)),
                      use_pallas=pallas, **LAYOUT)
        x0, draws = _sync_draws(jfv, per_vertex, model == "rwalk")
        x = jfv.pad_embedding(x0)
        for (negs, walks), step in zip(draws, _steps(model)):
            x = jfv.run_iteration(x, negs, walks=walks, step=step)
    return jfv, x, draws


@functools.lru_cache(maxsize=None)
def _jax_f32(model, per_vertex):
    """JAX's f32 run (jnp path), the sanity bound's yardstick."""
    jfv, x, _ = _jax_sync(model, per_vertex, "float32", False)
    return jfv.unpad_embedding(x).astype(np.float32)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", [c[0] for c in SYNC_CASES])
def test_bf16_sync_iterations_match_jax(case, pallas):
    import jax.numpy as jnp

    _, model, per_vertex = next(c for c in SYNC_CASES if c[0] == case)
    jfv, xj, draws = _jax_sync(model, per_vertex, BF16, pallas)
    assert xj.dtype == jnp.bfloat16
    tfv = SyncForce2Vec(_graph(), TrainConfig(**_sync_kw(
        model, per_vertex, BF16)), device="cpu", **LAYOUT)
    assert tfv.layout.buckets[-1].owners is not None  # a hub bucket runs
    x0, _ = _sync_draws(jfv, per_vertex, model == "rwalk")
    xt = embedding_from_jax(np.asarray(jfv.pad_embedding(x0)), "cpu")
    assert xt.dtype == torch.bfloat16
    assert tfv.inv_deg.dtype == torch.bfloat16
    for (negs, walks), step in zip(draws, _steps(model)):
        assert tfv.run_iteration(xt, negs, walks=walks, step=step) is xt
    assert xt.dtype == torch.bfloat16
    got = embedding_to_numpy(xt, DIM)
    want = np.asarray(xj).astype(np.float32)
    energy = _jax_model(model).update == "energy"
    _close(got, want, ENERGY_TOL if energy else TOL)

    # the difference is rounding: no farther from JAX's f32 run than
    # JAX's own bf16 run
    ref = _jax_f32(model, per_vertex)
    stat = np.mean if energy else np.max
    port = stat(np.abs(tfv.unpad_embedding(xt).float().numpy() - ref))
    jax_bf16 = stat(np.abs(jfv.unpad_embedding(xj).astype(np.float32) - ref))
    assert port <= SANITY * jax_bf16, (port, jax_bf16)


def test_bf16_sync_with_f32_gather_dtype_gathers_x():
    """A bf16 X is its own replica: ``gather_dtype="float32"`` beside it
    gives the same iteration as no gather dtype (JAX casts X up and
    straight back), and no replica is made."""
    g = _graph()
    runs = []
    for gather in (None, "float32", BF16):
        cfg = TrainConfig(dim=DIM, batch_size=BS, ns=NS, dtype=BF16,
                          gather_dtype=gather)
        fv = SyncForce2Vec(g, cfg, device="cpu", **LAYOUT)
        x = fv.init_embedding(seed=4)
        negs = np.random.default_rng(2).integers(
            0, g.n - 1, size=fv._neg_shape).astype(np.int32)
        runs.append(fv.run_iteration(x, negs))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_bf16_step_is_rounded_like_jax():
    """The step is rounded to X's dtype before any launch: lr, and for the
    decay999 schedule the decay factor then the product, as JAX's
    ``trainer.py:361-363``."""
    import jax.numpy as jnp

    from force2vec_tpu_torch.train.trainer import round_to, step_at

    for model in ("tdist", "fr"):
        m = get_model(model)
        for it in (0, 7, 300):
            want = (jnp.asarray(m.default_lr, jnp.bfloat16)
                    if m.lr_schedule != "decay999" else
                    m.default_lr * jnp.power(jnp.float32(0.999), it).astype(
                        jnp.bfloat16))
            assert step_at(m, m.default_lr, it, torch.bfloat16) == float(
                jnp.asarray(want, jnp.bfloat16))
    assert round_to(0.02, torch.float32) == float(np.float32(0.02))


# -- each plain kernel version against its Pallas kernel ----------------------

C, K, N_TABLE, STEP = 64, 8, 200, 0.02
SEPARABLE = ["tdist", "sigmoid", "fr", "linlog", "forceatlas"]


def _bf16_bucket(seed):
    """A bf16 X, its invd (bf16, as JAX holds it) and an ELL slot table
    over it whose rows never read themselves, deg covering 0 and K."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N_TABLE, DIM)).astype(
        np.float32)).bfloat16()
    idx = torch.from_numpy(rng.integers(N_TABLE // 2, N_TABLE, (C, K)).astype(
        np.int32))
    deg = torch.from_numpy(rng.integers(0, K + 1, C).astype(np.int32))
    deg[:2] = torch.tensor([0, K])
    xi_row = torch.arange(10, 10 + C, dtype=torch.int32)
    invd = torch.from_numpy((1.0 / rng.integers(1, 20, N_TABLE)).astype(
        np.float32)).bfloat16()
    return x, idx, deg, xi_row, invd


def _j(t):
    """A bf16 torch tensor as a JAX bf16 array, bit for bit."""
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _held(got, want, terms, unit_terms=None):
    """|got - want| ≤ 2^-6 Σ|terms| + 2^-7 |want| (+ 2^-7 Σ|unit terms|),
    elementwise; returns the largest ratio of |got - want| to it."""
    got, want = got.float(), torch.from_numpy(np.asarray(want, np.float32))
    bound = 2.0**-6 * terms.abs().sum(dim=1) + 2.0**-7 * want.abs()
    if unit_terms is not None:
        bound += 2.0**-7 * unit_terms.abs().sum(dim=1)
    d = (got - want).abs()
    ratio = float(torch.where(d == 0, 0.0, d / bound).max())
    assert ratio <= 1.0, ratio
    return ratio


def _unit(model):
    """The dot models' terms at a coefficient of 1 (σ pushed to 0 or 1)."""
    if model.a_kind != "dot":
        return None
    return lambda v: torch.full_like(v.sum(dim=-1, keepdim=True),
                                     float("inf"))


@pytest.mark.parametrize("name", SEPARABLE)
def test_bf16_plain_edge_matches_pallas(name):
    """ell_edge_force's plain version, one rounding to bf16, against
    ell_force_mxu and ell_force(kind="edge") with a bf16 xi."""
    import jax.numpy as jnp

    from force2vec_tpu.ops.pallas_force import ell_force, ell_force_mxu

    x, idx, deg, xi_row, invd = _bf16_bucket(7)
    model = get_model(name)
    args = (x, x, idx, deg, xi_row, invd, STEP)
    got = fk.ell_edge_force(model, *args)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fk.ell_edge_force_plain(model, *args))
    assert torch.equal(got, fk.ell_edge_force_terms(model, *args).sum(
        dim=1).bfloat16())
    terms = fk.ell_edge_force_terms(model, *args)
    unit = _unit(model)
    unit_terms = (None if unit is None else fk.ell_edge_force_terms(
        model, *args, rsum=lambda v: -unit(v)))
    jx, rows = _j(x), xi_row.numpy()
    xj = jnp.take(jx, jnp.asarray(idx.numpy().reshape(-1)), axis=0).reshape(
        C, K, DIM)
    jargs = (jx[rows], xj, jnp.asarray(deg.numpy()), _j(invd)[rows], STEP)
    mxu = ell_force_mxu(_jax_model(name), *jargs, interpret=True)
    elem = ell_force(_jax_model(name), "edge", *jargs, interpret=True)
    assert mxu.dtype == elem.dtype == jnp.bfloat16
    _held(got, mxu, terms)
    _held(got, elem, terms, unit_terms)


@pytest.mark.parametrize("name", SEPARABLE)
def test_bf16_plain_sample_matches_pallas(name):
    """ell_sample_force's plain version, storing and adding, against
    ell_force(kind="sample") with a bf16 xi; adding equals ``out.add_`` of
    the stored result bit for bit."""
    import jax.numpy as jnp

    from force2vec_tpu.ops.pallas_force import ell_force

    x, idx, deg, xi_row, _ = _bf16_bucket(14)
    model = get_model(name)
    args = (model, x, x, idx, deg, xi_row, STEP)
    got = fk.ell_sample_force(*args)
    assert got.dtype == torch.bfloat16
    terms = fk.ell_sample_force_terms(*args)
    unit = _unit(model)
    unit_terms = None if unit is None else fk.ell_sample_force_terms(
        *args, rsum=unit)
    jx = _j(x)
    xj = jnp.take(jx, jnp.asarray(idx.numpy().reshape(-1)), axis=0).reshape(
        C, K, DIM)
    want = ell_force(_jax_model(name), "sample", jx[xi_row.numpy()], xj,
                     jnp.asarray(deg.numpy()),
                     jnp.zeros(C, jnp.bfloat16), STEP, interpret=True)
    _held(got, want, terms, unit_terms)
    assert (got[deg == 0] == 0).all()
    base = torch.randn((C, DIM), generator=torch.Generator().manual_seed(3))
    base = base.bfloat16()
    out = fk.ell_sample_force(*args, out=base.clone(), accumulate=True)
    assert torch.equal(out, base.clone().add_(got))


@pytest.mark.parametrize("name", ["tdist", "sigmoid", "fr"])
def test_bf16_plain_grouped_rep_matches_pallas(name):
    import jax.numpy as jnp

    from force2vec_tpu.ops.pallas_force import grouped_rep_force as jax_rep

    c, group, ns = 400, 128, 5
    rng = np.random.default_rng(2)
    xi = torch.from_numpy(rng.standard_normal((c, DIM)).astype(
        np.float32)).bfloat16()
    sg = torch.from_numpy(rng.standard_normal((-(-c // group), ns, DIM))
                          .astype(np.float32)).bfloat16()
    model = get_model(name)
    got = fk.grouped_rep_force(model, group, xi, sg, STEP)
    assert got.dtype == torch.bfloat16
    want = jax_rep(_jax_model(name), group, _j(xi), _j(sg), STEP,
                   interpret=True)
    assert want.dtype == jnp.bfloat16
    terms = fk.grouped_rep_force_terms(model, group, xi, sg, STEP)
    unit = _unit(model)
    unit_terms = None
    if unit is not None:
        gid = torch.arange(c) // group
        unit_terms = model.sample_force(xi.float()[:, None, :],
                                        sg[gid].float(), STEP, rsum=unit)
    _held(got, want, terms, unit_terms)


def test_bf16_edge_table_adds_the_stored_result():
    """A table launch adding into a bf16 out adds the value it would store:
    ``out.add_`` of the stored result, bit for bit."""
    g = _graph()
    fv = SyncForce2Vec(g, TrainConfig(dim=DIM, batch_size=BS, ns=NS,
                                      dtype=BF16), device="cpu", **LAYOUT)
    x = fv.init_embedding(seed=2)
    t = fv.edge_table
    stored = fk.ell_edge_force_table(fv.model, x, x, t, fv.inv_deg, fv.lr)
    base = torch.randn(stored.shape,
                       generator=torch.Generator().manual_seed(5)).bfloat16()
    got = fk.ell_edge_force_table(fv.model, x, x, t, fv.inv_deg, fv.lr,
                                  out=base.clone(), accumulate=True)
    assert torch.equal(got, base.add_(stored))


def test_bf16_wrappers_reject_mixed_dtypes():
    """A bf16 X gathers only from bf16 rows, and out and invd take X's
    dtype; f32 X keeps taking either gather dtype."""
    x, idx, deg, xi_row, invd = _bf16_bucket(9)
    model = get_model("tdist")
    with pytest.raises(ValueError, match="gathers from bf16"):
        fk.ell_edge_force(model, x, x.float(), idx, deg, xi_row, invd, STEP)
    with pytest.raises(ValueError, match="invd"):
        fk.ell_edge_force(model, x, x, idx, deg, xi_row, invd.float(), STEP)
    with pytest.raises(ValueError, match="out"):
        fk.ell_sample_force(model, x, x, idx, deg, xi_row, STEP,
                            out=torch.zeros((C, DIM)))
    with pytest.raises(ValueError, match="gathers from bf16"):
        fk.grouped_rep_force(model, 8, x, x.float()[None], STEP)
    with pytest.raises(ValueError, match="float16"):
        fk.ell_sample_force(model, x.half(), x, idx, deg, xi_row, STEP)
    got = fk.ell_edge_force(model, x.float(), x, idx, deg, xi_row,
                            invd.float(), STEP)
    assert got.dtype == torch.float32


# -- the refusal of dtypes the kernels lack -----------------------------------


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_trainers_refuse_dtypes_the_kernels_lack(dtype):
    """The check the sync and vertex constructors make before any launch,
    on the card as here: it names the dtype.  The batch trainer, plain
    torch, takes it."""
    with pytest.raises(ValueError, match=dtype):
        fk.check_x_dtype(getattr(torch, dtype))
    g = _graph()
    cfg = TrainConfig(dim=DIM, batch_size=BS, ns=NS, dtype=dtype)
    with pytest.raises(ValueError, match=dtype):
        SyncForce2Vec(g, cfg, device="cpu", **LAYOUT)
    with pytest.raises(ValueError, match=dtype):
        VertexShardedForce2Vec(g, cfg, device="cpu", **LAYOUT)
    fk.reset_launch_counts()
    for d in fk.X_DTYPES:
        fk.check_x_dtype(d)
    assert not any(fk.launch_counts.values())


# -- the batch trainer --------------------------------------------------------


@pytest.mark.parametrize("model,per_vertex", [("tdist", False),
                                              ("sigmoid", True),
                                              ("fr", False)])
def test_bf16_batch_trainer_matches_jax(model, per_vertex):
    from force2vec_tpu.train.trainer import Force2Vec as JaxForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    g = _graph()
    kw = dict(dim=DIM, batch_size=16, model=model, ns=NS,
              per_vertex_samples=per_vertex, edge_chunk=64, dtype=BF16)
    jfv = JaxForce2Vec(_jax_graph(g), JaxConfig(**kw))
    tfv = Force2Vec(g, TrainConfig(**kw), device="cpu")
    rng = np.random.default_rng(5)
    x0 = rng.random((g.n, DIM)).astype(np.float32)
    if model != "sigmoid":
        x0 = x0 * 2 - 1
    xj, xt = jfv.pad_embedding(x0), tfv.pad_embedding(x0)
    assert xt.dtype == torch.bfloat16
    m = NS * 16 if per_vertex else NS
    for step in _steps(model):
        negs = rng.integers(0, g.n - 1, size=(tfv.dg.num_batches, m)).astype(
            np.int32)
        xj = jfv.run_iteration(xj, neg_ids=negs, step=step)
        tfv.run_iteration(xt, neg_ids=negs, step=step)
    energy = _jax_model(model).update == "energy"
    _close(tfv.unpad_embedding(xt).float().numpy(),
           np.asarray(xj[: g.n]).astype(np.float32),
           ENERGY_TOL if energy else TOL)


# -- the vertex schedule and the tp step --------------------------------------

VP_ITERS = 2


def _vertex_inputs():
    g = _graph()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((g.n, DIM)) * 0.1).astype(np.float32)
    pools = [rng.integers(0, g.n - 1, size=NS).astype(np.int32)
             for _ in range(VP_ITERS)]
    return x, pools


def _port_vertex(x_host, pools, device="cpu"):
    v = VertexShardedForce2Vec(_graph(), TrainConfig(dim=DIM, ns=NS,
                                                     dtype=BF16),
                               device=device, **LAYOUT)
    x = v.pad_embedding(x_host)
    assert x.dtype == torch.bfloat16
    for pool in pools:
        v.run_iteration(x, pool)
    out = v.unpad_embedding(x)
    return (None if out is None else out.float().numpy()), v.comm_stats()


def _jax_vertex(x_host, pools, n_dev):
    """The JAX vertex runner on ``n_dev`` virtual devices, its eager
    ``shard_map`` wrapped in ``jax.jit``."""
    import jax

    from force2vec_tpu.dist.vertex_sharded import VertexShardedForce2Vec as J
    from force2vec_tpu.dist.vertex_sharded import make_vp_mesh
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    orig = jax.shard_map
    jax.shard_map = lambda f, **kw: jax.jit(orig(f, **kw))
    try:
        v = J(_jax_graph(_graph()), JaxConfig(dim=DIM, ns=NS, dtype=BF16),
              mesh=make_vp_mesh(jax.devices()[:n_dev]), **LAYOUT)
        x = v.pad_embedding(x_host)
        for pool in pools:
            x = v.run_iteration(x, pool)
    finally:
        jax.shard_map = orig
    return v.unpad_embedding(x).astype(np.float32), v.comm_stats()


def _tp_draws():
    g = _graph()
    fv = SyncForce2Vec(g, TrainConfig(dim=DIM, batch_size=BS, ns=NS,
                                      dtype=BF16), device="cpu", **LAYOUT)
    rng = np.random.default_rng(11)
    x = (rng.random((g.n, DIM)) * 2 - 1).astype(np.float32)
    negs = [rng.integers(0, g.n - 1, size=fv._neg_shape).astype(np.int32)
            for _ in range(VP_ITERS)]
    return x, negs


def _ranks(rank, world, vertex_in, tp_in):
    """On 2 gloo ranks: the vertex schedule at P = 2, and the sync trainer
    at tp = 2 (the split-dim pair's plain versions and the all_reduce of
    their f32 scalars)."""
    vx, pools = vertex_in
    out = {"vertex": _port_vertex(vx, pools)}
    x_host, negs = tp_in
    fv = SyncForce2Vec(_graph(), TrainConfig(dim=DIM, batch_size=BS, ns=NS,
                                             dtype=BF16),
                       spmd=multihost.pod_mesh(2), device="cpu", **LAYOUT)
    x = fv.pad_embedding(x_host)
    for n in negs:
        fv.run_iteration(x, n)
    out["tp"] = (fv.unpad_embedding(x).float().numpy(), fv.tp_all_reduces,
                 str(x.dtype))
    return out


@pytest.fixture(scope="module")
def ranks():
    vin = _vertex_inputs()
    tin = _tp_draws()
    res = multihost.spawn(_ranks, 2, "gloo", args=(vin, tin), timeout=240,
                          threads=1)
    return res[0], vin, tin


def test_bf16_vertex_p1_matches_jax():
    """P = 1 in this process: no process group, no collective."""
    x, pools = _vertex_inputs()
    got, stats = _port_vertex(x, pools)
    want, jstats = _jax_vertex(x, pools, 1)
    _close(got, want, TOL)
    assert stats["bytes_per_iter_per_shard"] == jstats[
        "bytes_per_iter_per_shard"]


def test_bf16_vertex_p2_matches_jax_and_counts_two_bytes(ranks):
    res, (x, pools), _ = ranks
    got, stats = res["vertex"]
    want, jstats = _jax_vertex(x, pools, 2)
    _close(got, want, TOL)
    # the exchange moves bf16 rows: 2 bytes an element, as JAX counts
    rows = (stats["cold_alltoall_rows_sent"] + stats["hot_allgather_rows_recv"]
            + stats["pool_psum_rows"])
    assert rows > 0
    assert stats["bytes_per_iter_per_shard"] == rows * DIM * 2
    assert stats["bytes_per_iter_per_shard"] == jstats[
        "bytes_per_iter_per_shard"]


def test_bf16_tp_step_matches_jax(ranks):
    """The split-dim pair's plain versions at tp = 2, bf16 X, against the
    JAX package's jnp tp step under ``shard_map`` on 2 virtual devices.
    The port's pair scalars and their all_reduce stay f32; JAX forms them
    in bf16."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec as JSync
    from force2vec_tpu.dist.sharded import make_mesh

    res, _, (x_host, negs) = ranks
    got, reduces, dtype = res["tp"]
    assert dtype == "torch.bfloat16" and reduces == VP_ITERS
    cfg = JaxConfig(dim=DIM, batch_size=BS, ns=NS, dtype=BF16)
    mesh = make_mesh(jax.devices()[:2], dp=1, tp=2)
    sfv = JSync(_jax_graph(_graph()), cfg, mesh, **LAYOUT)
    fv = sfv.fv
    iteration = fv._build_iteration_fn(sfv.spmd)
    step = jnp.float32(fv.lr)

    def body(garr, x, n):
        return iteration(garr, x, n, None, step)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(), P(None, "tp"), P()),
                              out_specs=P(None, "tp"), check_vma=False))
    x = jnp.asarray(fv.pad_embedding(x_host))
    assert x.dtype == jnp.bfloat16
    for n in negs:
        x = f(fv._garr, x, jnp.asarray(n))
    _close(got, fv.unpad_embedding(x).astype(np.float32), TOL)


# -- convert and checkpoints --------------------------------------------------


def _bf16_words(shape, seed):
    """An ml_dtypes bf16 array, its |V2 words and the f32 values."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 3).astype(ml_dtypes.bfloat16)
    return a, a.view(np.dtype("V2")), a.astype(np.float32)


def test_convert_keeps_bf16_bit_for_bit():
    a, words, f32 = _bf16_words((24, 20), 1)
    for src in (a, words):
        t = embedding_from_jax(src, "cpu")
        assert t.dtype == torch.bfloat16 and t.shape == (24, 24)
        assert (t[:, 20:] == 0).all()
        np.testing.assert_array_equal(
            t[:, :20].view(torch.int16).numpy().view(np.uint16),
            a.view(np.uint16))
        back = embedding_to_numpy(t, 20)
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, f32)
    assert embedding_from_jax(f32, "cpu").dtype == torch.float32


def test_bf16_checkpoints_cross_both_ways(tmp_path):
    """A bf16 X written by the JAX package loads into a bf16 trainer bit
    for bit; the port writes the same |V2 words back."""
    from force2vec_tpu.train import checkpoint as jck

    a, words, f32 = _bf16_words((_graph().n, DIM), 2)
    jck.save_checkpoint(str(tmp_path / "j.npz"), a, 5, {"seed": 1})
    with np.load(tmp_path / "j.npz") as z:
        assert z["emb"].dtype == np.dtype("V2")
    emb, it = load_checkpoint(str(tmp_path / "j.npz"))
    assert it == 5 and emb.dtype == np.float32
    np.testing.assert_array_equal(emb, f32)
    fv = SyncForce2Vec(_graph(), TrainConfig(dim=DIM, batch_size=BS, ns=NS,
                                             dtype=BF16), device="cpu",
                       **LAYOUT)
    back = fv.unpad_embedding(fv.pad_embedding(emb))
    assert back.dtype == torch.bfloat16
    save_checkpoint(str(tmp_path / "t.npz"), back, 6, {"seed": 1})
    jemb, jit = jck.load_checkpoint(str(tmp_path / "t.npz"))
    assert jit == 6 and jemb.dtype == np.dtype("V2")
    np.testing.assert_array_equal(jemb.view(np.uint16), words.view(np.uint16))


@pytest.mark.parametrize("schedule", ["sync", "batch"])
def test_bf16_resume_equals_straight_run(tmp_path, schedule):
    g = _graph()
    cfg = TrainConfig(dim=DIM, batch_size=BS, ns=NS, dtype=BF16)
    make = ((lambda: SyncForce2Vec(g, cfg, device="cpu", **LAYOUT))
            if schedule == "sync" else
            (lambda: Force2Vec(g, cfg, device="cpu")))
    straight = train_with_checkpoints(make(), 4, seed=3, every=2,
                                      ckpt_dir=str(tmp_path / "a"))
    assert straight.dtype == torch.bfloat16
    mid, it = load_checkpoint(str(tmp_path / "a" / "ckpt_0000002.npz"))
    resumed = train_with_checkpoints(make(), 4, seed=3, x0=mid,
                                     start_iter=it, every=2,
                                     ckpt_dir=str(tmp_path / "b"))
    assert torch.equal(resumed, straight)
    end, _ = load_checkpoint(str(tmp_path / "b" / "ckpt_0000004.npz"))
    np.testing.assert_array_equal(end, straight.float().numpy())


def test_port_reads_bf16_without_ml_dtypes():
    """The port reads the JAX package's bf16 words through ``np.uint16``:
    importing every module of it, and ``chip_smoke.py``, loads no
    ml_dtypes (the card's host has no JAX, and ml_dtypes comes with it)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import force2vec_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "assert 'ml_dtypes' not in sys.modules\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
