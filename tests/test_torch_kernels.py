"""The kernels' plain versions against the JAX Pallas kernels (interpret
mode: ``ell_force_mxu``, ``ell_force`` of both kinds, ``grouped_rep_force``),
and the wrappers' input checks.  The CUDA kernels themselves run
only on the card, where ``chip_smoke.py`` holds them to these plain
versions (this directory's conftest imports JAX, which the card's host
lacks)."""

import _jax_inline_dispatch  # noqa: F401  (first: before any JAX client)
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from force2vec_tpu.models.forces import get_model as jax_model
from force2vec_tpu.ops.pallas_force import ell_force, ell_force_mxu
from force2vec_tpu.ops.pallas_force import grouped_rep_force as jax_rep
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import _build
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.train.sync import DeviceBucket

C, K, D = 64, 8, 16
N_TABLE = 200
STEP = 0.02
SEPARABLE = ["tdist", "sigmoid", "fr", "linlog", "forceatlas"]


def _bucket(seed, dtype, xi_row=None):
    """A random table, its gather replica and one ELL bucket over it.
    Bucket rows (below N_TABLE // 2) never neighbour themselves: a → 0
    makes the 1/a coefficients of fr and forceatlas ill-conditioned."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_TABLE, D)).astype(np.float32)
    xg = torch.from_numpy(x).to(getattr(torch, dtype))
    nbr = rng.integers(N_TABLE // 2, N_TABLE, (C, K)).astype(np.int32)
    deg = rng.integers(0, K + 1, C).astype(np.int32)
    if xi_row is None:
        xi_row = np.arange(10, 10 + C, dtype=np.int32)
    invd = (1.0 / rng.integers(1, 20, N_TABLE)).astype(np.float32)
    return x, xg, nbr, deg, xi_row, invd


def _port_edge(name, x, xg, nbr, deg, xi_row, invd):
    return fk.ell_edge_force(get_model(name), torch.from_numpy(x), xg,
                             torch.from_numpy(nbr), torch.from_numpy(deg),
                             torch.from_numpy(xi_row), torch.from_numpy(invd),
                             STEP).numpy()


def _jax_edge(name, x, xg, nbr, deg, xi_row, invd):
    """ell_force_mxu in interpret mode on xj = xg[nbr], as sync.py feeds it."""
    jxg = jnp.asarray(xg.float().numpy()).astype(str(xg.dtype).split(".")[1])
    xj = jnp.take(jxg, jnp.asarray(nbr.reshape(-1)), axis=0).reshape(C, K, D)
    return np.asarray(ell_force_mxu(
        jax_model(name), jnp.asarray(x[xi_row]), xj, jnp.asarray(deg),
        jnp.asarray(invd[xi_row]), STEP, interpret=True))


@pytest.mark.parametrize("name", SEPARABLE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_edge_force_matches_pallas(name, dtype):
    args = _bucket(7, dtype)
    # the MXU kernel's norm-form a differs from the diff form by f32
    # rounding, which 1/a coefficients amplify near a → 0
    tol = 2e-4 if dtype == "float32" else 6e-3
    np.testing.assert_allclose(_port_edge(name, *args), _jax_edge(name, *args),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_edge_force_hub_rows_match_pallas(dtype):
    """Hub virtual rows: several bucket rows read one owner's x and invd."""
    owners = np.repeat(np.arange(20, 20 + C // 4, dtype=np.int32), 4)
    args = _bucket(8, dtype, xi_row=owners)
    tol = 2e-4 if dtype == "float32" else 6e-3
    np.testing.assert_allclose(_port_edge("tdist", *args),
                               _jax_edge("tdist", *args), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", SEPARABLE)
def test_ell_edge_force_zero_degree_rows_are_zero(name):
    x, xg, nbr, _, xi_row, invd = _bucket(9, "bfloat16")
    got = _port_edge(name, x, xg, nbr, np.zeros(C, np.int32), xi_row, invd)
    np.testing.assert_array_equal(got, 0.0)


def test_ell_edge_force_writes_into_out():
    x, xg, nbr, deg, xi_row, invd = _bucket(10, "float32")
    model = get_model("tdist")
    t = [torch.from_numpy(a) for a in (x, nbr, deg, xi_row, invd)]
    out = torch.full((C + 4, D), 7.0)
    got = fk.ell_edge_force(model, t[0], xg, t[1], t[2], t[3], t[4], STEP,
                            out=out[2:2 + C])
    assert got.data_ptr() == out[2].data_ptr()
    want = fk.ell_edge_force_plain(model, t[0], xg, *t[1:], STEP)
    torch.testing.assert_close(out[2:2 + C], want)
    assert (out[:2] == 7.0).all() and (out[2 + C:] == 7.0).all()


# -- the work table: every bucket of a layout in one launch ---------------------

# (n, avg_deg, min_width, hub_width): layouts with several buckets and a hub
TABLE_LAYOUTS = [(600, 10, 4, 32), (500, 8, 4, 16)]


def _table_sync(layout, gather_dtype=None, model="tdist"):
    n, avg_deg, min_width, hub_width = layout
    g = synth_powerlaw_graph(n=n, avg_deg=avg_deg, seed=3)
    return SyncForce2Vec(g, TrainConfig(dim=D, ns=4, batch_size=8, model=model,
                                        gather_dtype=gather_dtype),
                         min_width=min_width, hub_width=hub_width, device="cpu")


def _table_inputs(fv, dtype, seed=21):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.uniform(-1, 1, (fv.layout.n_pad, D)).astype(np.float32))
    return x, x.to(getattr(torch, dtype))


@pytest.mark.parametrize("layout", TABLE_LAYOUTS)
def test_edge_table_covers_every_bucket_row_once(layout):
    """The trainer's table: entries widest first; each bucket's rows once,
    a non-hub bucket at its own rows, the hub's virtual rows at n_pad on,
    and a width-0 entry over the rows no bucket writes (hub owners and
    padding)."""
    fv = _table_sync(layout)
    lay, t = fv.layout, fv.edge_table
    hub = lay.buckets[-1]
    assert hub.owners is not None
    widths = t.entries[:, 4].tolist()
    assert widths == sorted(widths, reverse=True) and widths[-1] == 0
    assert t.n_pad == lay.n_pad and t.out_rows == lay.n_pad + hub.count
    written = np.zeros(t.out_rows, np.int64)
    parts = t.parts()
    for nbr, deg, xi_row, ob in parts:
        written[ob: ob + nbr.shape[0]] += 1
    np.testing.assert_array_equal(written, 1)
    by_start = {ob: (nbr, deg, xi_row) for nbr, deg, xi_row, ob in parts}
    for b in fv.device_buckets:
        nbr, deg, xi_row = by_start[lay.n_pad if b.owner_off is not None
                                    else b.start]
        assert torch.equal(nbr, b.nbr) and torch.equal(deg, b.deg)
        assert torch.equal(xi_row, b.xi_row)
    # the hub is the first entry; the width-0 entry zeroes [hub start, n_pad)
    assert t.entries[0, 2] == lay.n_pad and widths[0] == hub.width
    nbr, deg, xi_row, ob = parts[-1]
    assert ob == hub.start and nbr.shape == (lay.n_pad - hub.start, 0)
    assert (deg == 0).all()


@pytest.mark.parametrize("name", SEPARABLE)
def test_edge_table_plain_is_the_per_bucket_loop(name):
    """The table's plain version equals the per-bucket plain calls, bit
    for bit, each in its output rows; the rows no bucket writes are 0."""
    fv = _table_sync(TABLE_LAYOUTS[0])
    x, xg = _table_inputs(fv, "bfloat16")
    model = get_model(name)
    got = fk.ell_edge_force_table(model, x, xg, fv.edge_table, fv.inv_deg,
                                  STEP)
    n_pad = fv.layout.n_pad
    want = torch.zeros_like(got)
    for b in fv.device_buckets:
        rows = fk.ell_edge_force_plain(model, x, xg, b.nbr, b.deg, b.xi_row,
                                       fv.inv_deg, STEP)
        start = n_pad if b.owner_off is not None else b.start
        want[start: start + rows.shape[0]] = rows
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", SEPARABLE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_table_matches_pallas(name, dtype):
    """The table launch over a multi-bucket layout with a hub, against
    ell_force_mxu in interpret mode on each bucket (rows padded to the
    kernel's 8-row groups)."""
    fv = _table_sync(TABLE_LAYOUTS[0])
    x, xg = _table_inputs(fv, dtype)
    got = fk.ell_edge_force_table(get_model(name), x, xg, fv.edge_table,
                                  fv.inv_deg, STEP).numpy()
    jxg = jnp.asarray(xg.float().numpy()).astype(dtype)
    invd = fv.inv_deg.numpy()
    tol = 2e-4 if dtype == "float32" else 6e-3
    for nbr, deg, xi_row, ob in fv.edge_table.parts():
        c, k = nbr.shape
        if k == 0:
            np.testing.assert_array_equal(got[ob: ob + c], 0.0)
            continue
        pad = -c % 8
        nbr_p = np.pad(nbr.numpy(), ((0, pad), (0, 0)))
        rows = np.pad(xi_row.numpy(), (0, pad))
        xj = jnp.take(jxg, jnp.asarray(nbr_p.reshape(-1)), axis=0).reshape(
            c + pad, k, D)
        want = np.asarray(ell_force_mxu(
            jax_model(name), jnp.asarray(x.numpy()[rows]), xj,
            jnp.asarray(np.pad(deg.numpy(), (0, pad))),
            jnp.asarray(invd[rows]), STEP, interpret=True))[:c]
        np.testing.assert_allclose(got[ob: ob + c], want, rtol=tol, atol=tol)


def _bad_parts(fv, case):
    """The trainer's table parts with one fault planted (``case``)."""
    parts = [p[:3] + (p[3],) for p in fv.edge_table.parts()]
    nbr, deg, xi_row, ob = parts[1]
    n_pad = fv.layout.n_pad
    if case == "deg_past_width":
        deg = deg.clone()
        deg[0] = nbr.shape[1] + 1
    elif case == "negative_deg":
        deg = deg.clone()
        deg[0] = -1
    elif case == "xi_row_past_table":
        xi_row = xi_row.clone()
        xi_row[0] = n_pad
    elif case == "nbr_past_table":
        nbr = nbr.clone()
        nbr[0, 0] = n_pad
    elif case == "rows_overlap":
        ob -= 1
    elif case == "int64_nbr":
        nbr = nbr.long()
    elif case == "deg_length":
        deg = deg[:-1]
    elif case == "rows_missing":
        return parts[:1] + parts[2:]
    elif case == "too_many_entries":
        return parts + [(nbr[:0], deg[:0], xi_row[:0], 0)] + [
            (nbr[:1], deg[:1], xi_row[:1], ob)] * 64
    parts[1] = (nbr, deg, xi_row, ob)
    return parts


@pytest.mark.parametrize("case", [
    "deg_past_width", "negative_deg", "xi_row_past_table", "nbr_past_table",
    "rows_overlap", "int64_nbr", "deg_length", "rows_missing",
    "too_many_entries"])
def test_edge_table_rejects_malformed_tables(case):
    fv = _table_sync(TABLE_LAYOUTS[1])
    t = fv.edge_table
    fk.edge_work_table(_bad_parts(fv, "none"), t.n_pad, t.out_rows)
    with pytest.raises(ValueError):
        fk.edge_work_table(_bad_parts(fv, case), t.n_pad, t.out_rows)


@pytest.mark.parametrize("case", ["x_rows", "invd_rows", "out_rows", "xg_dtype",
                                  "no_separable_force"])
def test_edge_table_launch_rejects_bad_operands(case):
    fv = _table_sync(TABLE_LAYOUTS[1])
    x, xg = _table_inputs(fv, "bfloat16")
    args = dict(model=get_model("tdist"), x=x, xg=xg, table=fv.edge_table,
                invd=fv.inv_deg, step=STEP, out=None)
    fk.ell_edge_force_table(**args)
    args.update({
        "x_rows": dict(x=x[:-8], xg=xg[:-8]),
        "invd_rows": dict(invd=fv.inv_deg[:-1]),
        "out_rows": dict(out=torch.empty(fv.layout.n_pad, D)),
        "xg_dtype": dict(xg=xg.double()),
        "no_separable_force": dict(model=get_model("tdist_exact")),
    }[case])
    with pytest.raises(ValueError):
        fk.ell_edge_force_table(**args)


@pytest.mark.parametrize("name", SEPARABLE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_sample_force_accumulate_matches_pallas(name, dtype):
    """accumulate=True adds ell_force(kind='sample') (interpret mode) to
    the prior out, in place; the plain version takes the same flag."""
    x, xg, idx, deg, xi_row, invd = _ell_inputs(18, dtype)
    prior = np.random.default_rng(3).standard_normal((C, D)).astype(np.float32)
    want = prior + _jax_ell_force(name, "sample", x, xg, idx, deg, xi_row,
                                  invd)
    args = (get_model(name), torch.from_numpy(x), xg, torch.from_numpy(idx),
            torch.from_numpy(deg), torch.from_numpy(xi_row), STEP)
    out = torch.from_numpy(prior.copy())
    assert fk.ell_sample_force(*args, out=out, accumulate=True) is out
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    plain = torch.from_numpy(prior.copy())
    fk.ell_sample_force_plain(*args, out=plain, accumulate=True)
    assert torch.equal(plain, out)
    with pytest.raises(ValueError):  # nothing to add into
        fk.ell_sample_force(*args, accumulate=True)


@pytest.mark.parametrize("name", ["tdist", "sigmoid", "fr"])
@pytest.mark.parametrize("c,group", [(512, 128), (400, 128), (256, 256)])
def test_grouped_rep_force_matches_pallas(name, c, group):
    ns = 5
    ng = -(-c // group)
    rng = np.random.default_rng(2)
    xi = rng.standard_normal((c, D)).astype(np.float32)
    sg = jnp.asarray(rng.standard_normal((ng, ns, D)), jnp.bfloat16)
    want = jax_rep(jax_model(name), group, jnp.asarray(xi), sg, STEP,
                   interpret=True)
    got = fk.grouped_rep_force(
        get_model(name), group, torch.from_numpy(xi),
        torch.from_numpy(np.array(sg.astype(jnp.float32))).bfloat16(), STEP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _ell_inputs(seed, dtype):
    """A random table, its gather replica and an [C, K] slot table over it,
    with deg covering 0 and K.  Rows below N_TABLE // 2 never read
    themselves, as in ``_bucket``."""
    x, xg, idx, deg, xi_row, invd = _bucket(seed, dtype)
    deg[:2] = (0, K)
    return x, xg, idx, deg, xi_row, invd


def _jax_ell_force(name, kind, x, xg, idx, deg, xi_row, invd):
    """ell_force in interpret mode on xj = xg[idx], as sync.py feeds it."""
    jxg = jnp.asarray(xg.float().numpy()).astype(str(xg.dtype).split(".")[1])
    xj = jnp.take(jxg, jnp.asarray(idx.reshape(-1)), axis=0).reshape(C, K, D)
    return np.asarray(ell_force(
        jax_model(name), kind, jnp.asarray(x[xi_row]), xj, jnp.asarray(deg),
        jnp.asarray(invd[xi_row]), STEP, interpret=True))


@pytest.mark.parametrize("name", SEPARABLE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_sample_force_matches_pallas(name, dtype):
    x, xg, idx, deg, xi_row, invd = _ell_inputs(14, dtype)
    got = fk.ell_sample_force_plain(
        get_model(name), torch.from_numpy(x), xg, torch.from_numpy(idx),
        torch.from_numpy(deg), torch.from_numpy(xi_row), STEP).numpy()
    want = _jax_ell_force(name, "sample", x, xg, idx, deg, xi_row, invd)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[deg == 0], 0.0)


@pytest.mark.parametrize("name", SEPARABLE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_edge_force_matches_elementwise_pallas(name, dtype):
    """ell_force with kind 'edge' is the function ell_edge_force computes,
    in the same diff form."""
    x, xg, idx, deg, xi_row, invd = _ell_inputs(15, dtype)
    got = _port_edge(name, x, xg, idx, deg, xi_row, invd)
    want = _jax_ell_force(name, "edge", x, xg, idx, deg, xi_row, invd)
    # The two sum the same K terms in another order.  fr's and
    # forceatlas's terms reach ~100 here and can cancel to a sum near 0,
    # so each element is held to 1e-5 of its own Σ|terms| (chip_smoke.py's
    # bound) plus 1e-6, which is rtol 1e-5 wherever the terms do not cancel.
    terms = fk.ell_edge_force_terms(
        get_model(name), torch.from_numpy(x), xg, torch.from_numpy(idx),
        torch.from_numpy(deg), torch.from_numpy(xi_row),
        torch.from_numpy(invd), STEP)
    scale = terms.abs().sum(dim=1).numpy()
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-6).all()
    np.testing.assert_array_equal(got[deg == 0], 0.0)


def test_ell_sample_force_writes_into_out_and_rejects_bad_inputs():
    x, xg, idx, deg, xi_row, _ = _ell_inputs(16, "bfloat16")
    model = get_model("tdist")
    t = dict(x=torch.from_numpy(x), xg=xg, idx=torch.from_numpy(idx),
             deg=torch.from_numpy(deg), xi_row=torch.from_numpy(xi_row))

    def sample(out=None, **over):
        a = {**t, **over}
        return fk.ell_sample_force(model, a["x"], a["xg"], a["idx"],
                                   a["deg"], a["xi_row"], STEP, out=out)

    out = torch.full((C + 4, D), 7.0)
    got = sample(out=out[2:2 + C])
    assert got.data_ptr() == out[2].data_ptr()
    torch.testing.assert_close(
        out[2:2 + C], fk.ell_sample_force_plain(model, *t.values(), STEP))
    assert (out[:2] == 7.0).all() and (out[2 + C:] == 7.0).all()
    for bad in (dict(x=t["x"].double()), dict(idx=t["idx"].long()),
                dict(xg=xg.double()), dict(deg=t["deg"][:-1]),
                dict(xi_row=t["xi_row"][:-1]), dict(x=t["x"].t()),
                dict(xg=xg[:-1]), dict(out=torch.empty(C, D + 1))):
        with pytest.raises(ValueError):
            sample(**bad)
    with pytest.raises(ValueError):  # no sample force kernel for a lambda
        fk.ell_sample_force(
            dataclasses.replace(model, sample_force=lambda *a, **k: 0),
            *t.values(), STEP)


def test_wrappers_reject_bad_inputs():
    x, xg, nbr, deg, xi_row, invd = _bucket(11, "bfloat16")
    model = get_model("tdist")
    t = dict(x=torch.from_numpy(x), xg=xg, nbr=torch.from_numpy(nbr),
             deg=torch.from_numpy(deg), xi_row=torch.from_numpy(xi_row),
             invd=torch.from_numpy(invd))

    def edge(**over):
        a = {**t, **over}
        return fk.ell_edge_force(model, a["x"], a["xg"], a["nbr"], a["deg"],
                                 a["xi_row"], a["invd"], STEP)

    edge()
    for bad in (dict(x=t["x"].double()), dict(nbr=t["nbr"].long()),
                dict(xg=xg.double()), dict(deg=t["deg"][:-1]),
                dict(x=t["x"].t()), dict(invd=t["invd"][:-1]),
                dict(xg=xg[:-1])):
        with pytest.raises(ValueError):
            edge(**bad)
    with pytest.raises(ValueError):  # tdist_exact has no separable form
        fk.ell_edge_force(get_model("tdist_exact"), *t.values(), STEP)
    xs = torch.from_numpy(x)
    sg = xg[:5].reshape(1, 5, D)
    fk.grouped_rep_force(model, 256, xs, sg, STEP)
    with pytest.raises(ValueError):  # one group of 64 cannot cover 200 rows
        fk.grouped_rep_force(model, 64, xs, sg, STEP)
    with pytest.raises(ValueError):
        fk.grouped_rep_force(model, 256, xs, sg.reshape(5, D), STEP)


def test_plain_path_launches_nothing():
    fk.reset_launch_counts()
    x, xg, nbr, deg, xi_row, invd = _bucket(12, "bfloat16")
    _port_edge("tdist", x, xg, nbr, deg, xi_row, invd)
    x, xg, idx, deg, xi_row, _ = _ell_inputs(12, "bfloat16")
    fk.ell_sample_force(get_model("tdist"), torch.from_numpy(x), xg,
                        torch.from_numpy(idx), torch.from_numpy(deg),
                        torch.from_numpy(xi_row), STEP)
    fv = _table_sync(TABLE_LAYOUTS[1])
    fk.ell_edge_force_table(get_model("tdist"), *_table_inputs(fv, "bfloat16"),
                            fv.edge_table, fv.inv_deg, STEP)
    assert fk.launch_counts == {"ell_edge_force": 0, "grouped_rep_force": 0,
                                "ell_sample_force": 0, "tp_pair_partial": 0,
                                "tp_pair_force": 0, "tp_all_reduce": 0,
                                "ell_edge_apply": 0}


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libf2v_kernels_") and path.suffix == ".so"
    assert {p.name for p in _build.sources()} == {
        "ell_edge_force.cu", "grouped_rep_force.cu", "ell_sample_force.cu",
        "ell_edge_apply.cu",
        "take_sum.cu", "tile_force_tc.cu", "resident_gather.cu",
        "read_sum.cu", "tp_pair_force.cu"}
    # an edited source gets another library
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.CSRC_DIR.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    assert _build.library_path() == path
    (src / "common.cuh").write_text("// edited\n")
    assert _build.library_path() != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.os, "access",
                        lambda p, mode: False if "nvcc" in str(p) else True)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_bound_passes_plain_and_rejects_planted_faults():
    """chip_smoke.py's elementwise bound, on the CPU wrappers (the plain
    versions): the true outputs pass it, and both planted faults fail it."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(13)
    x = torch.from_numpy(
        rng.uniform(-1, 1, (N_TABLE, D)).astype(np.float32))
    xg = x.bfloat16()
    _, _, nbr, deg, xi_row, invd = _bucket(13, "bfloat16")
    b = DeviceBucket(start=0, nbr=torch.from_numpy(nbr),
                     deg=torch.from_numpy(deg), xi_row=torch.from_numpy(xi_row))
    invd = torch.from_numpy(invd)
    group, model = 20, get_model("tdist")
    sg = xg[torch.from_numpy(rng.integers(0, N_TABLE, (N_TABLE // group, 5)))]
    edge = fk.ell_edge_force(model, x, xg, b.nbr, b.deg, b.xi_row, invd, STEP)
    terms = fk.ell_edge_force_terms(model, x, xg, b.nbr, b.deg, b.xi_row,
                                    invd, STEP)
    assert smoke.bound_ratio(edge, terms) == 0.0
    rep = fk.grouped_rep_force(model, group, x, sg, STEP)
    assert smoke.bound_ratio(
        rep, fk.grouped_rep_force_terms(model, group, x, sg, STEP)) == 0.0
    # a row with no terms must be exactly zero
    assert smoke.bound_ratio(edge + 1e-30, terms) == float("inf")
    rep_ratio, edge_ratio = smoke.planted_fault_ratios(
        model, group, x, xg, b, invd, sg, STEP)
    assert rep_ratio > 1.0 and edge_ratio > 1.0


def test_smoke_sample_bound_rejects_planted_faults():
    """The same bound on ell_sample_force's CPU wrapper: the true output
    passes, x_i from the bf16 replica and a skipped last sample fail."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(17)
    x = torch.from_numpy(
        rng.uniform(-1, 1, (N_TABLE, D)).astype(np.float32))
    xg = x.bfloat16()
    idx = torch.from_numpy(rng.integers(0, N_TABLE, (N_TABLE, 5)).astype(
        np.int32))
    deg = torch.full((N_TABLE,), 5, dtype=torch.int32)
    rows = torch.arange(N_TABLE, dtype=torch.int32)
    model = get_model("tdist")
    got = fk.ell_sample_force(model, x, xg, idx, deg, rows, STEP)
    assert smoke.bound_ratio(got, fk.ell_sample_force_terms(
        model, x, xg, idx, deg, rows, STEP)) == 0.0
    bf16_xi, skip_last = smoke.sample_planted_fault_ratios(
        model, x, xg, idx, deg, rows, STEP)
    assert bf16_xi > 1.0 and skip_last > 1.0


@pytest.mark.parametrize("layout", TABLE_LAYOUTS)
def test_smoke_table_bound_rejects_planted_faults(layout):
    """chip_smoke.py's table check on the CPU wrapper: the true output
    passes every entry, the width-0 entry included; each warp's second row
    dropped and the first entry skipped both fail."""
    smoke = _chip_smoke()
    fv = _table_sync(layout)
    x, xg = _table_inputs(fv, "bfloat16")
    model = get_model("tdist")
    err, ratio = smoke.check_table(model, x, xg, fv.edge_table, fv.inv_deg,
                                   STEP, "tdist")
    assert err == 0.0 and ratio == 0.0
    dropped, skipped = smoke.table_planted_fault_ratios(
        model, x, xg, fv.edge_table, fv.inv_deg, STEP)
    assert dropped > 1.0 and skipped > 1.0


def test_smoke_work_counts_each_byte_once():
    smoke = _chip_smoke()
    x = torch.zeros((6, D))
    xg = x.bfloat16()
    idx = torch.tensor([[1, 2, 9], [3, 1, 9]], dtype=torch.int32)
    deg = torch.tensor([2, 2], dtype=torch.int32)
    rows = torch.tensor([0, 0], dtype=torch.int32)
    nbytes, terms = smoke.ell_work([(idx, deg, rows)], x, xg, True)
    # x_0 and invd_0 once, replica rows 1, 2, 3 once (slot 2 is padding),
    # 4 real ids, deg and xi_row of 2 rows, 2 output rows
    assert terms == 4
    assert nbytes == D * 4 + 4 + 3 * D * 2 + 4 * 4 + 2 * 8 + 2 * D * 4
    # adding into out reads its rows once more
    more, _ = smoke.ell_work([(idx, deg, rows)], x, xg, True, True)
    assert more == nbytes + 2 * D * 4
    ms, by = smoke.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    assert smoke.bound_ms(1.0, 67e9) == (1.0, "operations")


def test_smoke_walk_check_passes_walks_and_rejects_faults():
    smoke = _chip_smoke()
    g = synth_powerlaw_graph(n=16384, avg_deg=16, seed=5)
    fv = SyncForce2Vec(g, TrainConfig(dim=D, model="rwalk", ns=5,
                                      walk_length=1),
                       min_width=8, hub_width=64, device="cpu")
    walks = fv.draw_walks(torch.Generator().manual_seed(1))
    moved, share, expect = smoke.check_walks(fv, walks)
    assert moved == int((fv.layout.deg > 0).sum())
    rows = torch.arange(fv.layout.n_pad, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="neighbour"):  # no self loops
        smoke.check_walks(fv, rows[:, None].clone())
    # every step on slot 0 of its row
    slot0 = torch.where(fv.walk_db[:, 0] > 0,
                        fv.walk_pool[fv.walk_db[:, 1].long()], rows)
    with pytest.raises(RuntimeError, match="slot-0"):
        smoke.check_walks(fv, slot0[:, None].clone())


def test_smoke_ptxas_summary_names_each_instance():
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN3f2v50_GLOBAL__N__c2860a92"
        "_17_ell_edge_force_cu_f6deec6b21ell_edge_force_kernelI13__nv_bfloat16"
        "Li0EEEvNS_7EllArgsIT_EE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3f2v5",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 48 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN3f2v53_GLOBAL__N__011_20"
        "_grouped_rep_force_cu_b4d24grouped_rep_force_kernelIfLi4ELi2EEEvNS0_"
        "7RepArgsIT_EE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers",
    ])
    assert _chip_smoke().ptxas_summary(log) == [
        "ell_edge_force_kernel<bf16, 0>: Used 48 registers, used 0 "
        "barriers; 8 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
        "loads",
        "grouped_rep_force_kernel<f32, 4, 2>: Used 32 registers, used 1 "
        "barriers; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads",
    ]


def test_profile_tool_needs_a_card(monkeypatch, capsys):
    from force2vec_tpu_torch.tools import profile_iter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_iter.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
