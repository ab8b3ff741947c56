"""The split-dim (tp) force kernels' plain versions, ``tp_pair_partial`` and
``tp_pair_force``, against the JAX package's force models at full width
(the step its tp runners compute with jnp ops and a psum over tp): the
columns split over two simulated ranks, the partial scalars summed as
the ``all_reduce`` sums them; two tables laid end to end
(``concat_work_tables``, the sync trainer's one partial launch an
iteration) against each on its own.  Also the wrappers' input checks,
the CUDA contract among them.  The CUDA kernels themselves run only on the
card, where ``chip_smoke.py`` holds them to these plain versions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from force2vec_tpu.models.forces import get_model as jax_model
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk

N, D, STEP = 120, 16, 0.02
WIDTHS = ((24, 8), (40, 3))  # (rows, width) of the table's two entries
MODELS = [("tdist", False), ("sigmoid", False), ("fr", False),
          ("linlog", False), ("forceatlas", False), ("sigmoid", True)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _table(seed, n_gather=N):
    """Two entries over rows below N // 2, whose neighbours lie in the
    upper half of the gather table (a ≠ 0, as 1/a models need)."""
    rng = np.random.default_rng(seed)
    parts, out = [], 0
    for rows, width in WIDTHS:
        nbr = rng.integers(n_gather // 2, n_gather, (rows, width))
        deg = rng.integers(0, width + 1, rows)
        xi = rng.integers(0, N // 2, rows)
        parts.append((torch.from_numpy(nbr.astype(np.int32)),
                      torch.from_numpy(deg.astype(np.int32)),
                      torch.from_numpy(xi.astype(np.int32)), out))
        out += rows
    return fk.edge_work_table(parts, N, out, n_gather=n_gather)


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    invd = (1.0 / rng.integers(1, 20, N)).astype(np.float32)
    xg = torch.from_numpy(x).to(getattr(torch, dtype))
    return x, xg, invd


def _split(model, kind, x, xg, table, invd, ranks=2):
    """The tp step on ``ranks`` column slices: partial scalars, their sum,
    the force on each slice; the slices' forces side by side."""
    cols = np.array_split(np.arange(D), ranks)
    xs = [torch.from_numpy(x[:, c].copy()) for c in cols]
    gs = [xg[:, c].contiguous() for c in cols]
    a = sum(fk.tp_pair_partial(model, xr, gr, table)
            for xr, gr in zip(xs, gs))
    return torch.cat([fk.tp_pair_force(model, kind, xr, gr, table, a,
                                       torch.from_numpy(invd), STEP)
                      for xr, gr in zip(xs, gs)], dim=1).numpy()


def _jax(name, table_sm, kind, x, xg, table, invd):
    """The JAX model's force at full width, summed over each row's real
    slots, in table order."""
    m = jax_model(name, sm_table=table_sm)
    g = jnp.asarray(xg.float().numpy())
    out = np.zeros((table.out_rows, D), np.float32)
    for nbr, deg, xi_row, ob in table.parts():
        nbr, deg, rows = nbr.numpy(), deg.numpy(), xi_row.numpy()
        xi = jnp.asarray(x[rows])[:, None, :]
        xj = g[jnp.asarray(nbr)]
        mask = jnp.asarray(np.arange(nbr.shape[1])[None, :] < deg[:, None])
        f = (m.edge_force(xi, xj, jnp.asarray(invd[rows])[:, None, None],
                          STEP, mask=mask[:, :, None]) if kind == "edge"
             else m.sample_force(xi, xj, STEP, mask=mask[:, :, None]))
        out[ob: ob + nbr.shape[0]] = np.asarray(f.sum(axis=1))
    return out


@pytest.mark.parametrize("kind", ["edge", "sample"])
@pytest.mark.parametrize("name,table_sm", MODELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_forces_match_jax_at_full_width(kind, name, table_sm, dtype):
    x, xg, invd = _inputs(3, dtype)
    table = _table(4)
    model = get_model(name, sm_table=table_sm)
    np.testing.assert_allclose(_split(model, kind, x, xg, table, invd),
                               _jax(name, table_sm, kind, x, xg, table, invd),
                               **TOL)


@pytest.mark.parametrize("name", ["tdist", "sigmoid"])
def test_tp_partials_sum_to_the_pair_scalar(name):
    """Over four column slices the partials sum to each real slot's
    |x_i - xg_j|² (or x_i · xg_j), and are exactly 0 in padded slots."""
    x, xg, _ = _inputs(5, "float32")
    table, model = _table(6), get_model(name)
    cols = np.array_split(np.arange(D), 4)
    a = sum(fk.tp_pair_partial(model, torch.from_numpy(x[:, c].copy()),
                               xg[:, c].contiguous(), table) for c in cols)
    for (rb, nb, _, rows, width), (nbr, deg, xi_row, _) in zip(
            table.entries.tolist(), table.parts()):
        xi = torch.from_numpy(x)[xi_row.long()][:, None, :]
        xj = xg[nbr.long()]
        want = ((xi * xj) if name == "sigmoid" else (xi - xj) ** 2).sum(-1)
        got = a[nb: nb + rows * width].view(rows, width)
        real = fk._slot_mask(nbr, deg)[:, :, 0]
        np.testing.assert_allclose(got[real], want[real], **TOL)
        assert (got[~real] == 0).all()


@pytest.mark.parametrize("case", ["kind", "a_len", "x_rows", "xg_rows",
                                  "no_edge_force",
                                  "dim_not_multiple_of_8",
                                  "misaligned_row_base"])
def test_tp_kernels_reject_bad_operands(case):
    x, xg, invd = _inputs(9, "float32")
    table, model = _table(10), get_model("tdist")
    xt, it = torch.from_numpy(x), torch.from_numpy(invd)
    a = fk.tp_pair_partial(model, xt, xg, table)
    if case.startswith(("dim", "misaligned")):
        # the CUDA wrappers' contract (the fused kernels'), which they check
        # only for CUDA tensors: called here on CPU tensors
        if case == "dim_not_multiple_of_8":
            xt, xg = xt[:, :12].contiguous(), xg[:, :12].contiguous()
            match = "multiple of 8"
        else:
            xt = torch.zeros(N * D + 1)[1:].view(N, D)
            match = "16-byte aligned"
        with pytest.raises(ValueError, match=match):
            fk._check_cuda_operands(xt.shape[1], xt, xg)
        return
    kind = "edge"
    if case == "kind":
        kind = "both"
    elif case == "a_len":
        a = a[:-1]
    elif case == "x_rows":
        xt = xt[:-1]
    elif case == "xg_rows":
        xg = torch.cat([xg, xg[:1]])
    elif case == "no_edge_force":
        model = get_model("tdist_exact")
    with pytest.raises(ValueError):
        fk.tp_pair_force(model, kind, xt, xg, table, a, it, STEP)


def _sample_table(seed, rows=30, ns=5):
    """A per-row sample table as the tp trainer builds it: every row with
    ns ids of the upper half of the gather table."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(
        rng.integers(N // 2, N, (rows, ns)).astype(np.int32))
    xi = torch.from_numpy(rng.integers(0, N // 2, rows).astype(np.int32))
    return fk.EdgeWorkTable.single(idx, torch.full((rows,), ns,
                                                   dtype=torch.int32), xi, N)


@pytest.mark.parametrize("name", ["tdist", "sigmoid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_concatenated_table_is_the_tables_end_to_end(name, dtype):
    """One partial over two tables laid end to end is their partials laid
    end to end, bit for bit, and each force on its slice of the scalars is
    the force on its own table, bit for bit."""
    x, xg, invd = _inputs(11, dtype)
    xt, it, model = torch.from_numpy(x), torch.from_numpy(invd), get_model(name)
    tables = [_table(12), _sample_table(13)]
    cat, views = fk.concat_work_tables(tables)
    assert cat.entries.shape[0] == sum(t.entries.shape[0] for t in tables)
    part = fk.tp_pair_partial(model, xt, xg, cat)
    own = [fk.tp_pair_partial(model, xt, xg, t) for t in tables]
    assert torch.equal(part, torch.cat(own))
    off = 0
    for kind, t, v, a in zip(("edge", "sample"), tables, views, own):
        n = t.nbr.shape[0]
        got = fk.tp_pair_force(model, kind, xt, xg, v, part[off: off + n],
                               it, STEP)
        assert torch.equal(got, fk.tp_pair_force(model, kind, xt, xg, t, a,
                                                 it, STEP))
        off += n


def test_concatenated_table_views_write_its_ids():
    """A view's ids are the concatenated table's: ids written into the
    repulsion's view (as each tp iteration writes its negatives) are the
    ones the one partial launch reads."""
    x, xg, _ = _inputs(14, "float32")
    xt, model = torch.from_numpy(x), get_model("tdist")
    edge, rep = _table(15), _sample_table(16)
    cat, (_, view) = fk.concat_work_tables([edge, rep])
    ids = torch.from_numpy(np.random.default_rng(17).integers(
        N // 2, N, rep.nbr.shape).astype(np.int32))
    fresh = dataclasses.replace(rep, nbr=ids)
    view.nbr.copy_(ids)
    part = fk.tp_pair_partial(model, xt, xg, cat)
    assert torch.equal(part[edge.nbr.shape[0]:],
                       fk.tp_pair_partial(model, xt, xg, fresh))


def test_concatenation_past_the_entry_limit_raises():
    """Tables of more entries than one launch takes raise, naming the
    limit; they are never split."""
    tables = [_table(18)] * (fk._MAX_ENTRIES // 2 + 1)
    with pytest.raises(ValueError, match=f"at most {fk._MAX_ENTRIES}"):
        fk.concat_work_tables(tables)
