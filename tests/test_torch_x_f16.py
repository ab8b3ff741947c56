"""X held in f16 (``TrainConfig(dtype="float16")``) and the f16 gather
replica (``gather_dtype="float16"``) against the JAX package, which holds
X, ``inv_deg`` and the step in ``config.dtype``.

The JAX package computes an f16 X's forces in f16 (its jnp path and its
elementwise Pallas kernels round every product and sum; its MXU kernel
casts the f32 sum once); the port computes each force in f32 from X's
values and rounds it to f16 once.  So the two agree to f16 rounding (an
ulp at 1 is 2^-10), not bit for bit, and every bound here says which
rounding it covers:

* sync iterations, three of them, on injected negatives and walks, on
  the JAX package's jnp path and its Pallas kernels in interpret mode:
  atol = rtol = 2^-9 (2 f16 ulps at 1) for the add models; the layout
  family's energy apply moves each row by a unit-norm step whose
  direction JAX forms in f16, so it takes 2^-7.  The sanity bound of the
  bf16 module: the port's f16 run no farther from JAX's f32 run than
  JAX's own f16 run, ×1.25 (max |ΔX|; mean |ΔX| for the layout family);
* the energy update's row norm in f16: a row whose Σ upd² passes 65,504
  has an infinite norm and a step of 0 in JAX; the port leaves exactly
  the same rows unmoved (fr, forceatlas, linlog at dim 128);
* an f32 X with the f16 replica: 2^-9 (a replica element that rounds
  the other way once the two X's differ by an f32 ulp moves a force by an
  f16 ulp of that element); the cross-replica pairs, formed as a replica
  in X's own dtype: a bf16 X with the f16 replica at the bf16 module's
  bounds (1.6e-2, the layout family 3.2e-2; f16 holds every normal bf16
  value), an f16 X with the bf16
  replica at 2^-9 for the dot models; for tdist JAX's f16 force is not
  resolved on rows whose group draws the row itself (its bf16-rounded
  self lies a hair away: JAX's f16 coefficient 2 / (r (1 + r)) of a
  subnormal r overflows, and inf times an unchanged column is NaN), so
  the port, finite there, is held to JAX on the other rows;
* each plain kernel version against its Pallas kernel with an f16 xi:
  |Δ| ≤ 2^-9 of the element's Σ|terms| plus 2^-10 of its value plus
  2^-24 a slot (JAX's f16 terms under 2^-14 are subnormal, with an
  absolute ulp of 2^-24), and for the sigmoid family plus 2^-10 of the
  terms at a coefficient of 1 (JAX's f16 σ resolves 1 − σ only to an f16
  ulp);
* the tp step (the split-dim pair's plain versions on 2 gloo ranks), the
  batch trainer and the vertex schedule (P = 1 here, P = 2 on gloo ranks)
  against the JAX runners at 2^-9, the batch trainer's layout family at
  2^-7 (plain torch in f16 on both sides, rounded at other places);
* the step's rounding, ``convert`` and checkpoints bit for bit, both
  ways.

The module imports no JAX at the top: its gloo ranks import it.
"""

import _jax_inline_dispatch  # noqa: F401  (first: before any JAX client)
import contextlib

import numpy as np
import pytest
import torch
from test_torch_x_dtype import (BS, DIM, ITERS, LAYOUT, NS, SANITY,
                                SEPARABLE, SYNC_CASES, VP_ITERS, C, K,
                                N_TABLE, STEP, _close, _graph, _jax_f32,
                                _jax_graph, _jax_model, _jax_sync,
                                _jax_vertex, _port_vertex, _ranks, _steps,
                                _sync_draws, _sync_kw, _tp_draws, _unit,
                                _vertex_inputs)
from test_torch_x_dtype import ENERGY_TOL as BF16_ENERGY_TOL
from test_torch_x_dtype import TOL as BF16_TOL

from force2vec_tpu_torch import Force2Vec, SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.convert import (embedding_from_jax,
                                         embedding_to_numpy)
from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  save_checkpoint,
                                                  train_with_checkpoints)

TOL = 2.0**-9  # 2 f16 ulps at 1
ENERGY_TOL = 2.0**-7
F16 = "float16"
FROZEN_DIM = 128


def _port_sync(model, per_vertex, dtype, x_pad, draws, gather=None,
               iters=ITERS):
    """The port's sync run from the JAX package's padded X (numpy): the
    runner and its X after ``iters`` of ``draws``."""
    kw = _sync_kw(model, per_vertex, dtype)
    tfv = SyncForce2Vec(_graph(), TrainConfig(**kw, gather_dtype=gather),
                        device="cpu", **LAYOUT)
    xt = embedding_from_jax(np.asarray(x_pad), "cpu")
    assert xt.dtype == getattr(torch, dtype)
    for (negs, walks), step in list(zip(draws, _steps(model)))[:iters]:
        assert tfv.run_iteration(xt, negs, walks=walks, step=step) is xt
    return tfv, xt


# -- sync iterations against the JAX package ----------------------------------


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", [c[0] for c in SYNC_CASES])
def test_f16_sync_iterations_match_jax(case, pallas):
    import jax.numpy as jnp

    _, model, per_vertex = next(c for c in SYNC_CASES if c[0] == case)
    jfv, xj, draws = _jax_sync(model, per_vertex, F16, pallas)
    assert xj.dtype == jnp.float16
    x0, _ = _sync_draws(jfv, per_vertex, model == "rwalk")
    tfv, xt = _port_sync(model, per_vertex, F16, jfv.pad_embedding(x0),
                         draws)
    assert tfv.layout.buckets[-1].owners is not None  # a hub bucket runs
    assert xt.dtype == tfv.inv_deg.dtype == torch.float16
    got = embedding_to_numpy(xt, DIM)
    assert got.dtype == np.float16
    energy = _jax_model(model).update == "energy"
    _close(got, np.asarray(xj), ENERGY_TOL if energy else TOL)

    # the difference is rounding: no farther from JAX's f32 run than
    # JAX's own f16 run
    ref = _jax_f32(model, per_vertex)
    stat = np.mean if energy else np.max
    port = stat(np.abs(tfv.unpad_embedding(xt).float().numpy() - ref))
    jax_f16 = stat(np.abs(jfv.unpad_embedding(xj).astype(np.float32) - ref))
    assert port <= SANITY * jax_f16, (port, jax_f16)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("model", ["fr", "forceatlas", "linlog"])
def test_f16_energy_rows_freeze_where_jax_freezes(model, pallas):
    """One iteration at dim 128 from the trainers' [-1, 1) init: in f16 a
    row whose Σ upd² passes 65,504 gets an infinite norm and stays put.
    The port leaves the same rows unmoved as JAX, row for row (fr: 399 of
    400; the f32 run moves them all), and the moved ones within 2^-9."""
    from jax.experimental.pallas import tpu as pltpu

    from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    g = _graph()
    kw = dict(dim=FROZEN_DIM, batch_size=BS, model=model, ns=NS, dtype=F16)
    step = _jax_model(model).default_lr
    rng = np.random.default_rng(17)
    x0 = (rng.random((g.n, FROZEN_DIM)) * 2 - 1).astype(np.float32)
    ctx = (pltpu.force_tpu_interpret_mode() if pallas
           else contextlib.nullcontext())
    with ctx:
        jfv = JaxSync(_jax_graph(g), JaxConfig(**kw), use_pallas=pallas,
                      **LAYOUT)
        negs = rng.integers(0, g.n - 1, size=(-(-jfv.layout.n_pad // BS),
                                              NS)).astype(np.int32)
        xj0 = np.asarray(jfv.pad_embedding(x0))
        xj = np.asarray(jfv.run_iteration(xj0, negs, step=step))
    tfv = SyncForce2Vec(g, TrainConfig(**kw), device="cpu", **LAYOUT)
    xt = tfv.run_iteration(embedding_from_jax(xj0, "cpu"), negs, step=step)
    got = embedding_to_numpy(xt, FROZEN_DIM)
    jax_moved = (xj != xj0).any(axis=1)
    port_moved = (got != xj0).any(axis=1)
    np.testing.assert_array_equal(port_moved, jax_moved)
    assert 0 < (~jax_moved).sum() < len(jax_moved)
    if model == "fr":
        assert (~jax_moved[: g.n]).sum() == 399
    _close(got, xj, TOL)
    # in f32 no row freezes
    t32 = SyncForce2Vec(g, TrainConfig(**{**kw, "dtype": "float32"}),
                        device="cpu", **LAYOUT)
    x32 = embedding_from_jax(xj0.astype(np.float32), "cpu")
    moved32 = (t32.run_iteration(x32.clone(), negs, step=step)
               != x32).any(dim=1)
    assert bool(moved32[: g.n].all())


def _jnp_run(model, dtype, gather, iters=ITERS):
    """The JAX package's jnp sync run with ``gather``: its padded X0, X
    after ``iters`` iterations, and the draws."""
    from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    kw = _sync_kw(model, False, dtype)
    jfv = JaxSync(_jax_graph(_graph()), JaxConfig(**kw, gather_dtype=gather),
                  use_pallas=False, **LAYOUT)
    x0, draws = _sync_draws(jfv, False, model == "rwalk")
    x = x_pad = np.asarray(jfv.pad_embedding(x0))
    for (negs, walks), step in list(zip(draws, _steps(model)))[:iters]:
        x = jfv.run_iteration(x, negs, walks=walks, step=step)
    return x_pad, np.asarray(x), draws


@pytest.mark.parametrize("model", ["tdist", "sigmoid", "fr"])
def test_f32_x_with_f16_replica_matches_jax(model):
    """``gather_dtype="float16"`` beside an f32 X: the replica is X cast to
    f16, and each force is summed in f32 from its rows."""
    x_pad, want, draws = _jnp_run(model, "float32", F16)
    fv, xt = _port_sync(model, False, "float32", x_pad, draws, gather=F16)
    assert xt.dtype == torch.float32 and fv._replica(xt).dtype == (
        torch.float16)
    _close(embedding_to_numpy(xt, DIM), want, TOL)


@pytest.mark.parametrize("model", ["tdist", "sigmoid", "fr"])
def test_bf16_x_with_f16_replica_matches_jax(model):
    """A bf16 X beside ``gather_dtype="float16"``: X's values rounded
    through f16 (exact for bf16 values in f16's normal range), held in
    bf16."""
    x_pad, want, draws = _jnp_run(model, "bfloat16", F16)
    _, xt = _port_sync(model, False, "bfloat16", x_pad, draws, gather=F16)
    assert xt.dtype == torch.bfloat16
    energy = _jax_model(model).update == "energy"
    _close(embedding_to_numpy(xt, DIM), want.astype(np.float32),
           BF16_ENERGY_TOL if energy else BF16_TOL)


@pytest.mark.parametrize("model", ["sigmoid", "rwalk"])
def test_f16_x_with_bf16_replica_matches_jax(model):
    """An f16 X beside ``gather_dtype="bfloat16"``: X's values rounded
    through bf16, held in f16, as JAX gathers bf16 rows and casts them to
    f16.  The dot models' forces stay finite on both sides."""
    x_pad, want, draws = _jnp_run(model, F16, "bfloat16")
    assert np.isfinite(want.astype(np.float32)).all()
    fv, xt = _port_sync(model, False, F16, x_pad, draws, gather="bfloat16")
    xg = fv._replica(xt)
    assert xg.dtype == torch.float16
    assert torch.equal(xg, xt.bfloat16().half())
    _close(embedding_to_numpy(xt, DIM), want, TOL)


def test_f16_x_with_bf16_replica_tdist_off_self_samples():
    """tdist, one iteration: on rows whose group draws the row itself, its
    bf16-rounded self lies a hair away, and JAX's f16 repulsion from it is
    not resolved (2 / (r (1 + r)) of a subnormal r overflows: NaN where
    it meets an unchanged column); the port's f32 sum is finite
    everywhere, and within 2^-9 of JAX on every other row."""
    x_pad, want, draws = _jnp_run("tdist", F16, "bfloat16", iters=1)
    _, xt = _port_sync("tdist", False, F16, x_pad, draws, gather="bfloat16",
                       iters=1)
    got = embedding_to_numpy(xt, DIM).astype(np.float32)
    assert np.isfinite(got).all()
    want = want.astype(np.float32)
    bad = ~np.isfinite(want).all(axis=1)
    rows = np.arange(len(want))
    negs = draws[0][0]
    self_sampled = (negs[rows // BS] == rows[:, None]).any(axis=1)
    assert bad.any() and not (bad & ~self_sampled).any()
    _close(got[~self_sampled], want[~self_sampled], TOL)


def test_f16_sync_own_replica_for_f16_or_f32_gather_dtype():
    """An f16 X is its own replica: ``gather_dtype="float32"`` or
    ``"float16"`` beside it gives the same iteration as none, and no
    replica is made."""
    g = _graph()
    runs = []
    for gather in (None, "float32", F16):
        cfg = TrainConfig(dim=DIM, batch_size=BS, ns=NS, dtype=F16,
                          gather_dtype=gather)
        fv = SyncForce2Vec(g, cfg, device="cpu", **LAYOUT)
        x = fv.init_embedding(seed=4)
        assert fv._replica(x) is x
        negs = np.random.default_rng(2).integers(
            0, g.n - 1, size=fv._neg_shape).astype(np.int32)
        runs.append(fv.run_iteration(x, negs))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def _jax_decay_steps(lr, its, dtype):
    """JAX's decay999 step at each of ``its`` as its trainers form it
    (``trainer.py:361-363``, ``sync.py:712-714``): ``it`` a traced int32
    in a loop, so ``jnp.power`` is an f32 ``stablehlo.power``.  (A Python
    int exponent would make it ``lax.integer_pow``, which rounds
    otherwise.)"""
    import jax
    import jax.numpy as jnp

    steps = jax.jit(lambda i: jax.lax.map(
        lambda t: lr * jnp.power(jnp.float32(0.999), t).astype(dtype), i))(
            jnp.asarray(its, jnp.int32))
    return [float(v) for v in np.asarray(steps.astype(jnp.float32))]


def test_f16_step_is_rounded_like_jax():
    """The step is rounded to X's dtype before any launch: lr, and for the
    decay999 schedule the decay factor then the product, as JAX's
    ``trainer.py:361-363`` and ``sync.py:712-714`` with a traced ``it``."""
    import jax.numpy as jnp

    from force2vec_tpu_torch.train.trainer import round_to, step_at

    its = (0, 1, 7, 300, 1199, 5000)
    for model in ("tdist", "fr", "sigmoid"):
        m = get_model(model)
        for lr in (m.default_lr, 0.0173, 0.3):
            want = ([float(jnp.asarray(lr, jnp.float16))] * len(its)
                    if m.lr_schedule != "decay999" else
                    _jax_decay_steps(lr, its, jnp.float16))
            got = [step_at(m, lr, it, torch.float16) for it in its]
            assert got == want, (model, lr)
    assert round_to(65519.0, torch.float16) == 65504.0
    assert round_to(1e-8, torch.float16) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_decay_step_matches_jax_at_every_iteration(dtype):
    """The decay999 step of every iteration 0–3000, in each X dtype, equals
    JAX's with a traced ``it``, bit for bit (the f32 decay factor is the
    C library's ``powf``, as XLA's CPU backend computes it)."""
    import jax.numpy as jnp

    from force2vec_tpu_torch.train.trainer import step_at

    m = get_model("fr")
    assert m.lr_schedule == "decay999"
    its = range(3001)
    for lr in (m.default_lr, 0.0173, 0.3):
        want = _jax_decay_steps(lr, its, jnp.dtype(dtype))
        got = [step_at(m, lr, it, getattr(torch, dtype)) for it in its]
        bad = [it for it, g, w in zip(its, got, want) if g != w]
        assert not bad, (lr, bad[:10], len(bad))


# -- each plain kernel version against its Pallas kernel ----------------------


def _f16_bucket(seed):
    """An f16 X, its invd (f16, as JAX holds it) and an ELL slot table over
    it whose rows never read themselves, deg covering 0 and K."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N_TABLE, DIM)).astype(
        np.float16))
    idx = torch.from_numpy(rng.integers(N_TABLE // 2, N_TABLE, (C, K)).astype(
        np.int32))
    deg = torch.from_numpy(rng.integers(0, K + 1, C).astype(np.int32))
    deg[:2] = torch.tensor([0, K])
    xi_row = torch.arange(10, 10 + C, dtype=torch.int32)
    invd = torch.from_numpy((1.0 / rng.integers(1, 20, N_TABLE)).astype(
        np.float16))
    return x, idx, deg, xi_row, invd


def _j(t):
    """An f16 torch tensor as a JAX f16 array, bit for bit."""
    import jax.numpy as jnp

    return jnp.asarray(t.numpy())


def _held(got, want, terms, unit_terms=None):
    """|got - want| ≤ 2^-9 Σ|terms| + 2^-10 |want| + K·2^-24 (+ 2^-10
    Σ|unit terms|), elementwise, K the slots (JAX forms each term in f16,
    where a value under 2^-14 keeps an absolute ulp of 2^-24); returns the
    largest ratio of |got - want| to it."""
    got, want = got.float(), torch.from_numpy(np.asarray(want, np.float32))
    bound = (2.0**-9 * terms.abs().sum(dim=1) + 2.0**-10 * want.abs()
             + terms.shape[1] * 2.0**-24)
    if unit_terms is not None:
        bound += 2.0**-10 * unit_terms.abs().sum(dim=1)
    d = (got - want).abs()
    ratio = float(torch.where(d == 0, 0.0, d / bound).max())
    assert ratio <= 1.0, ratio
    return ratio


@pytest.mark.parametrize("name", SEPARABLE)
def test_f16_plain_edge_matches_pallas(name):
    """ell_edge_force's plain version, one rounding to f16, against
    ell_force_mxu and ell_force(kind="edge") with an f16 xi."""
    import jax.numpy as jnp

    from force2vec_tpu.ops.pallas_force import ell_force, ell_force_mxu

    x, idx, deg, xi_row, invd = _f16_bucket(7)
    model = get_model(name)
    args = (x, x, idx, deg, xi_row, invd, STEP)
    got = fk.ell_edge_force(model, *args)
    assert got.dtype == torch.float16
    assert torch.equal(got, fk.ell_edge_force_plain(model, *args))
    terms = fk.ell_edge_force_terms(model, *args)
    assert torch.equal(got, terms.sum(dim=1).half())
    unit = _unit(model)
    unit_terms = (None if unit is None else fk.ell_edge_force_terms(
        model, *args, rsum=lambda v: -unit(v)))
    jx, rows = _j(x), xi_row.numpy()
    xj = jnp.take(jx, jnp.asarray(idx.numpy().reshape(-1)), axis=0).reshape(
        C, K, DIM)
    jargs = (jx[rows], xj, jnp.asarray(deg.numpy()), _j(invd)[rows], STEP)
    mxu = ell_force_mxu(_jax_model(name), *jargs, interpret=True)
    elem = ell_force(_jax_model(name), "edge", *jargs, interpret=True)
    assert mxu.dtype == elem.dtype == jnp.float16
    _held(got, mxu, terms)
    _held(got, elem, terms, unit_terms)


@pytest.mark.parametrize("name", SEPARABLE)
def test_f16_plain_sample_matches_pallas(name):
    """ell_sample_force's plain version, storing and adding, against
    ell_force(kind="sample") with an f16 xi; adding equals ``out.add_`` of
    the stored result bit for bit."""
    import jax.numpy as jnp

    from force2vec_tpu.ops.pallas_force import ell_force

    x, idx, deg, xi_row, _ = _f16_bucket(14)
    model = get_model(name)
    args = (model, x, x, idx, deg, xi_row, STEP)
    got = fk.ell_sample_force(*args)
    assert got.dtype == torch.float16
    terms = fk.ell_sample_force_terms(*args)
    unit = _unit(model)
    unit_terms = None if unit is None else fk.ell_sample_force_terms(
        *args, rsum=unit)
    jx = _j(x)
    xj = jnp.take(jx, jnp.asarray(idx.numpy().reshape(-1)), axis=0).reshape(
        C, K, DIM)
    want = ell_force(_jax_model(name), "sample", jx[xi_row.numpy()], xj,
                     jnp.asarray(deg.numpy()),
                     jnp.zeros(C, jnp.float16), STEP, interpret=True)
    _held(got, want, terms, unit_terms)
    assert (got[deg == 0] == 0).all()
    base = torch.randn((C, DIM), generator=torch.Generator().manual_seed(3))
    base = base.half()
    out = fk.ell_sample_force(*args, out=base.clone(), accumulate=True)
    assert torch.equal(out, base.clone().add_(got))


@pytest.mark.parametrize("name", ["tdist", "sigmoid", "fr"])
def test_f16_plain_grouped_rep_matches_pallas(name):
    import jax.numpy as jnp

    from force2vec_tpu.ops.pallas_force import grouped_rep_force as jax_rep

    c, group, ns = 400, 128, 5
    rng = np.random.default_rng(2)
    xi = torch.from_numpy(rng.standard_normal((c, DIM)).astype(np.float16))
    sg = torch.from_numpy(rng.standard_normal((-(-c // group), ns, DIM))
                          .astype(np.float16))
    model = get_model(name)
    got = fk.grouped_rep_force(model, group, xi, sg, STEP)
    assert got.dtype == torch.float16
    want = jax_rep(_jax_model(name), group, _j(xi), _j(sg), STEP,
                   interpret=True)
    assert want.dtype == jnp.float16
    terms = fk.grouped_rep_force_terms(model, group, xi, sg, STEP)
    unit = _unit(model)
    unit_terms = None
    if unit is not None:
        gid = torch.arange(c) // group
        unit_terms = model.sample_force(xi.float()[:, None, :],
                                        sg[gid].float(), STEP, rsum=unit)
    _held(got, want, terms, unit_terms)


def test_f16_plain_versions_round_once_and_overflow_to_inf():
    """A sum past f16's range rounds to ±inf once, as the JAX cast does
    and the kernels' ``__float2half_rn``; ``apply`` and ``add`` are
    ``upd.add_(rep); x.add_(upd)`` and ``out.add_(rep)`` bit for bit."""
    model = get_model("fr")
    x = torch.zeros((16, DIM), dtype=torch.float16)
    x[1:] = 30.0  # row 0 sees 15 rows at distance² 14,400 each
    nbr = torch.arange(1, 16, dtype=torch.int32)[None].repeat(16, 1)
    deg = torch.full((16,), 15, dtype=torch.int32)
    rows = torch.arange(16, dtype=torch.int32)
    invd = torch.ones(16, dtype=torch.float16)
    got = fk.ell_edge_force(model, x, x, nbr, deg, rows, invd, STEP)
    terms = fk.ell_edge_force_terms(model, x, x, nbr, deg, rows, invd, STEP)
    assert torch.equal(got, terms.sum(dim=1).half())
    assert bool(torch.isinf(got[0]).all()) and bool(torch.isfinite(
        terms.sum(dim=1)[0]).all())
    xi, sg = _f16_bucket(4)[0][:40], _f16_bucket(5)[0][:10].view(2, 5, DIM)
    upd = (torch.randn((40, DIM), generator=torch.Generator().manual_seed(1))
           * 0.01).half()
    tdist = get_model("tdist")
    rep = fk.grouped_rep_force(tdist, 20, xi, sg, STEP)
    out = fk.grouped_rep_force(tdist, 20, xi, sg, STEP, mode="add",
                               out=upd.clone())
    assert torch.equal(out, upd.clone().add_(rep))
    xa = fk.grouped_rep_force(tdist, 20, xi.clone(), sg, STEP, mode="apply",
                              upd=upd)
    assert torch.equal(xa, xi.clone().add_(upd.clone().add_(rep)))


def test_f16_wrappers_refuse_pairs_the_kernels_lack():
    """An f16 X gathers only from f16 rows, and out and invd take X's
    dtype; float64 stays refused by name; f32 X takes f16 gathers."""
    x, idx, deg, xi_row, invd = _f16_bucket(9)
    model = get_model("tdist")
    for other in (x.float(), x.bfloat16()):
        with pytest.raises(ValueError, match="gathers from f16"):
            fk.ell_edge_force(model, x, other, idx, deg, xi_row, invd, STEP)
        with pytest.raises(ValueError, match="gathers from f16"):
            fk.grouped_rep_force(model, 8, x, other[None], STEP)
    with pytest.raises(ValueError, match="gathers from bf16"):
        fk.ell_sample_force(model, x.bfloat16(), x, idx, deg, xi_row, STEP)
    with pytest.raises(ValueError, match="invd"):
        fk.ell_edge_force(model, x, x, idx, deg, xi_row, invd.float(), STEP)
    with pytest.raises(ValueError, match="out"):
        fk.ell_sample_force(model, x, x, idx, deg, xi_row, STEP,
                            out=torch.zeros((C, DIM)))
    with pytest.raises(ValueError, match="float64"):
        fk.ell_sample_force(model, x.double(), x, idx, deg, xi_row, STEP)
    with pytest.raises(ValueError, match="float64"):
        fk.check_x_dtype(torch.float64)
    got = fk.ell_edge_force(model, x.float(), x, idx, deg, xi_row,
                            invd.float(), STEP)
    assert got.dtype == torch.float32
    assert torch.equal(got, fk.ell_edge_force_terms(
        model, x.float(), x, idx, deg, xi_row, invd.float(), STEP).sum(dim=1))


# -- the batch trainer --------------------------------------------------------


@pytest.mark.parametrize("model,per_vertex", [("tdist", False),
                                              ("sigmoid", True),
                                              ("fr", False)])
def test_f16_batch_trainer_matches_jax(model, per_vertex):
    from force2vec_tpu.train.trainer import Force2Vec as JaxForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    g = _graph()
    kw = dict(dim=DIM, batch_size=16, model=model, ns=NS,
              per_vertex_samples=per_vertex, edge_chunk=64, dtype=F16)
    jfv = JaxForce2Vec(_jax_graph(g), JaxConfig(**kw))
    tfv = Force2Vec(g, TrainConfig(**kw), device="cpu")
    rng = np.random.default_rng(5)
    x0 = rng.random((g.n, DIM)).astype(np.float32)
    if model != "sigmoid":
        x0 = x0 * 2 - 1
    xj, xt = jfv.pad_embedding(x0), tfv.pad_embedding(x0)
    assert xt.dtype == torch.float16
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


@pytest.fixture(scope="module")
def ranks():
    vin = _vertex_inputs()
    tin = _tp_draws()
    res = multihost.spawn(_ranks, 2, "gloo", args=(vin, tin, F16),
                          timeout=240, threads=1)
    return res[0], vin, tin


def test_f16_vertex_p1_matches_jax():
    """P = 1 in this process: no process group, no collective."""
    x, pools = _vertex_inputs()
    got, stats = _port_vertex(x, pools, dtype=F16)
    want, jstats = _jax_vertex(x, pools, 1, F16)
    _close(got, want, TOL)
    assert stats["bytes_per_iter_per_shard"] == jstats[
        "bytes_per_iter_per_shard"]


def test_f16_vertex_p2_matches_jax_and_counts_two_bytes(ranks):
    res, (x, pools), _ = ranks
    got, stats = res["vertex"]
    want, jstats = _jax_vertex(x, pools, 2, F16)
    _close(got, want, TOL)
    # the exchange moves f16 rows: 2 bytes an element, as JAX counts
    rows = (stats["cold_alltoall_rows_sent"] + stats["hot_allgather_rows_recv"]
            + stats["pool_psum_rows"])
    assert rows > 0
    assert stats["bytes_per_iter_per_shard"] == rows * DIM * 2
    assert stats["bytes_per_iter_per_shard"] == jstats[
        "bytes_per_iter_per_shard"]


def test_f16_tp_step_matches_jax(ranks):
    """The split-dim pair's plain versions at tp = 2, f16 X, against the
    JAX package's jnp tp step under ``shard_map`` on 2 virtual devices.
    The port's pair scalars and their all_reduce stay f32; JAX forms them
    in f16."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec as JSync
    from force2vec_tpu.dist.sharded import make_mesh
    from force2vec_tpu.train.trainer import TrainConfig as JaxConfig

    res, _, (x_host, negs) = ranks
    got, reduces, dtype = res["tp"]
    assert dtype == "torch.float16" and reduces == VP_ITERS
    cfg = JaxConfig(dim=DIM, batch_size=BS, ns=NS, dtype=F16)
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
    assert x.dtype == jnp.float16
    for n in negs:
        x = f(fv._garr, x, jnp.asarray(n))
    _close(got, fv.unpad_embedding(x).astype(np.float32), TOL)


# -- convert and checkpoints --------------------------------------------------


def _f16_array(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 3).astype(np.float16)


def test_convert_keeps_f16_bit_for_bit():
    a = _f16_array((24, 20), 1)
    t = embedding_from_jax(a, "cpu")
    assert t.dtype == torch.float16 and t.shape == (24, 24)
    assert (t[:, 20:] == 0).all()
    np.testing.assert_array_equal(t[:, :20].view(torch.int16).numpy(),
                                  a.view(np.int16))
    back = embedding_to_numpy(t, 20)
    assert back.dtype == np.float16
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
    assert embedding_from_jax(a.astype(np.float32), "cpu").dtype == (
        torch.float32)


def test_f16_checkpoints_cross_both_ways(tmp_path):
    """An f16 X written by the JAX package (native ``<f2``) loads into an
    f16 trainer bit for bit; the port writes the same ``<f2`` back."""
    from force2vec_tpu.train import checkpoint as jck

    a = _f16_array((_graph().n, DIM), 2)
    jck.save_checkpoint(str(tmp_path / "j.npz"), a, 5, {"seed": 1})
    with np.load(tmp_path / "j.npz") as z:
        assert z["emb"].dtype == np.dtype("<f2")
    emb, it = load_checkpoint(str(tmp_path / "j.npz"))
    assert it == 5 and emb.dtype == np.float16
    np.testing.assert_array_equal(emb.view(np.uint16), a.view(np.uint16))
    fv = SyncForce2Vec(_graph(), TrainConfig(dim=DIM, batch_size=BS, ns=NS,
                                             dtype=F16), device="cpu",
                       **LAYOUT)
    back = fv.unpad_embedding(fv.pad_embedding(emb))
    assert back.dtype == torch.float16
    save_checkpoint(str(tmp_path / "t.npz"), back, 6, {"seed": 1})
    jemb, jit = jck.load_checkpoint(str(tmp_path / "t.npz"))
    assert jit == 6 and jemb.dtype == np.float16
    np.testing.assert_array_equal(jemb.view(np.uint16), a.view(np.uint16))


@pytest.mark.parametrize("schedule", ["sync", "batch"])
def test_f16_resume_equals_straight_run(tmp_path, schedule):
    g = _graph()
    cfg = TrainConfig(dim=DIM, batch_size=BS, ns=NS, dtype=F16)
    make = ((lambda: SyncForce2Vec(g, cfg, device="cpu", **LAYOUT))
            if schedule == "sync" else
            (lambda: Force2Vec(g, cfg, device="cpu")))
    straight = train_with_checkpoints(make(), 4, seed=3, every=2,
                                      ckpt_dir=str(tmp_path / "a"))
    assert straight.dtype == torch.float16
    mid, it = load_checkpoint(str(tmp_path / "a" / "ckpt_0000002.npz"))
    assert mid.dtype == np.float16
    resumed = train_with_checkpoints(make(), 4, seed=3, x0=mid,
                                     start_iter=it, every=2,
                                     ckpt_dir=str(tmp_path / "b"))
    assert torch.equal(resumed, straight)
    end, _ = load_checkpoint(str(tmp_path / "b" / "ckpt_0000004.npz"))
    np.testing.assert_array_equal(end, straight.numpy())
