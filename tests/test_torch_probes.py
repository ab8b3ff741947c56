"""The probe kernels' plain versions against the JAX package's four Pallas
probes (interpret mode): ``exp_r3.vmem_take``, ``exp_r3.mxu_force``,
``exp_r4._dg_call`` and ``exp_r4.ro_call``; the wrappers' input checks;
and ``tools/probes.py``'s experiments at a tiny size on the CPU.  The CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them to these
plain versions.

``mxu_force`` and ``ro_call`` are nested inside ``exp_sweepvar`` and
``exp_sweepfloor``: the tests read the benchmark files as text and run
those functions' source unchanged (``_nested``)."""

import ast
import functools
import importlib.util
import re
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from force2vec_tpu.models.forces import get_model as jax_model
from force2vec_tpu.ops.pallas_force import ell_force
from force2vec_tpu.train.sync import SyncForce2Vec as JaxSync
from force2vec_tpu.train.trainer import TrainConfig as JaxConfig
from force2vec_tpu.graphs.csr import Graph as JaxGraph
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.ops import probe_kernels as pk
from force2vec_tpu_torch.tools import probes

ROOT = Path(__file__).resolve().parents[1]
D = 128
STEP = 0.02
U = 2.0**-24  # f32 unit roundoff


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exp_r3():
    return _load("exp_r3")


@pytest.fixture(scope="module")
def exp_r4():
    return _load("exp_r4")


def _nested(file, outer, names, **env):
    """The functions ``names`` defined inside ``outer`` in
    ``benchmarks/<file>``, exec'd from their source in a namespace holding
    JAX, Pallas and ``env``."""
    src = (ROOT / "benchmarks" / file).read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == outer)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, ft=functools, **env)
    for node in fn.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            exec(textwrap.dedent(ast.get_source_segment(src, node)), ns)
    return [ns[n] for n in names]


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _table(rng, shape, dtype):
    """The same table for both frameworks: f32 normals, rounded to bf16 by
    each (both round to nearest even)."""
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype)), _jax(a, dtype)


def _within(got, want, scale, rtol):
    """|got - want| ≤ rtol · scale elementwise, scale the Σ|terms|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) <= rtol * np.asarray(scale)).all(), \
        float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


# -- take_sum vs exp_r3.vmem_take ------------------------------------------------


@pytest.mark.parametrize("mode", ["take", "rowloop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_sum_matches_vmem_take(exp_r3, mode, dtype):
    h, c, k = 64, 512, 4
    rng = np.random.default_rng(3)
    tbl, jtbl = _table(rng, (h, D), dtype)
    idx = rng.integers(0, h, (c, k)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(exp_r3.vmem_take(mode, jtbl, jnp.asarray(idx)))
    tidx = torch.from_numpy(idx)
    got = pk.take_sum(tbl, tidx).numpy()
    scale = pk.take_sum_terms(tbl, tidx).abs().sum(dim=1).numpy()
    _within(got, want, scale, 1e-6)


# -- resident_gather vs exp_r4._dg_call --------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_resident_gather_matches_dg_call(exp_r4, dtype, n_chunks):
    """_dg_call writes every chunk's gather into one out block, so its
    result is the last chunk's: the last H rows of the port's."""
    h = 64
    rng = np.random.default_rng(4)
    tbl, jtbl = _table(rng, (h, D), dtype)
    idx = rng.integers(0, h, n_chunks * h).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        # built inside the context: built outside, the call refuses the CPU
        call = exp_r4._dg_call(jnp, pl, pltpu, h, D, n_chunks,
                               getattr(jnp, dtype))
        want = np.asarray(call(jnp.asarray(idx[:, None]), jtbl)
                          .astype(jnp.float32))
    got = pk.resident_gather(tbl, torch.from_numpy(idx))
    assert got.shape == (n_chunks * h, D) and got.dtype == tbl.dtype
    np.testing.assert_array_equal(got[-h:].float().numpy(), want)
    if n_chunks > 1:
        assert not np.array_equal(got[:h].float().numpy(), want)


# -- tile_force_tc vs exp_r3.mxu_force and ell_force(kind="edge") -------------------


def test_tile_force_tc_matches_mxu_force_and_ell_force():
    mxu_kernel, mxu_force = _nested("exp_r3.py", "exp_sweepvar",
                                    ["mxu_kernel", "mxu_force"])
    del mxu_kernel  # mxu_force calls it by name
    c, k = 64, 8
    rng = np.random.default_rng(5)
    xi = rng.uniform(-1, 1, (c, D)).astype(np.float32)
    xj, jxj = _table(rng, (c, k, D), "bfloat16")
    deg = rng.integers(0, k + 1, c).astype(np.int32)
    deg[:2] = (0, k)  # a ragged tile: deg from 0 to K
    with pltpu.force_tpu_interpret_mode():
        want_mxu = np.asarray(mxu_force(jnp.asarray(xi), jxj,
                                        jnp.asarray(deg), STEP))
        want_edge = np.asarray(ell_force(
            jax_model("tdist"), "edge", jnp.asarray(xi), jxj,
            jnp.asarray(deg), jnp.ones(c, jnp.float32), STEP,
            interpret=True))
    args = (torch.from_numpy(xi), xj, torch.from_numpy(deg), STEP)
    got = pk.tile_force_tc(*args).numpy()
    scale = pk.tile_force_tc_terms(*args).abs().sum(dim=1).numpy()
    _within(got, want_mxu, scale, 1e-6)
    _within(got, want_edge, scale, 1e-6)
    np.testing.assert_array_equal(got[deg == 0], 0.0)


def _ragged_tile(rng, c, k, dtype):
    """(xi [c, D] f32, xj [c, k, D], deg [c]) as numpy and torch, deg from
    0 to K (rows 0 and 1 hold 0 and K)."""
    xi = rng.uniform(-1, 1, (c, D)).astype(np.float32)
    xj, jxj = _table(rng, (c, k, D), dtype)
    deg = rng.integers(0, k + 1, c).astype(np.int32)
    deg[:2] = (0, k)
    return xi, xj, jxj, deg


@pytest.fixture(scope="module")
def tile_table():
    """A 3-entry work table of widths 8, 16 and 128 (in that order) with
    ragged deg, its parts as numpy and JAX arrays, and mxu_force."""
    mxu_kernel, mxu_force = _nested("exp_r3.py", "exp_sweepvar",
                                    ["mxu_kernel", "mxu_force"])
    del mxu_kernel  # mxu_force calls it by name
    rng = np.random.default_rng(7)
    raw = [_ragged_tile(rng, c, k, "bfloat16")
           for c, k in ((24, 8), (16, 16), (8, 128))]
    work = pk.tile_work_table([(torch.from_numpy(xi), xj,
                                torch.from_numpy(deg))
                               for xi, xj, _, deg in raw])
    return work, raw, mxu_force


def test_tile_force_tc_table_is_the_per_entry_sweep(tile_table):
    """The plain table equals ``tile_force_tc_plain`` per entry, bit for
    bit, in the caller's order; entries launch widest first."""
    work, _, _ = tile_table
    assert work.order == (2, 1, 0)
    assert work.entries[:, 5].tolist() == [128, 16, 8]
    assert work.entries[:, 3].tolist() == [40, 24, 0]  # first output rows
    assert work.out_rows == 48
    got = pk.tile_force_tc_table(work, STEP)
    assert [tuple(g.shape) for g in got] == [(24, D), (16, D), (8, D)]
    for g, (xi, xj, deg) in zip(got, work.parts):
        assert torch.equal(g, pk.tile_force_tc_plain(xi, xj, deg, STEP))
        assert torch.equal(g, pk.tile_force_tc(xi, xj, deg, STEP))
        assert torch.equal(g[deg == 0], torch.zeros_like(g[deg == 0]))


@pytest.mark.parametrize("entry", range(3))
def test_tile_force_tc_table_entry_matches_mxu_force(tile_table, entry):
    work, raw, mxu_force = tile_table
    xi, _, jxj, deg = raw[entry]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mxu_force(jnp.asarray(xi), jxj, jnp.asarray(deg),
                                    STEP))
    got = pk.tile_force_tc_table(work, STEP)[entry].numpy()
    scale = pk.tile_force_tc_terms(*work.parts[entry], STEP).abs().sum(
        dim=1).numpy()
    _within(got, want, scale, 1e-6)


# -- read_sum vs exp_r4.ro_call ---------------------------------------------------


def test_read_sum_matches_ro_call_with_zeroed_accumulator():
    """ro_kernel adds into its out block from grid step 0 without zeroing
    it, so the reference is run with uninitialized memory read as 0; with
    the interpreter's default (NaN) the result is all NaN."""
    t_rows, t_tile, k = 24, 8, 4
    _, ro_call = _nested("exp_r4.py", "exp_sweepfloor",
                         ["ro_kernel", "ro_call"],
                         t_rows=t_rows, t_tile=t_tile, k=k)
    rng = np.random.default_rng(6)
    tile, jtile = _table(rng, (t_rows, k, D), "bfloat16")
    zero = pltpu.InterpretParams(uninitialized_memory="zero")
    with pltpu.force_tpu_interpret_mode(zero):
        want = np.asarray(ro_call(jtile))
    with pltpu.force_tpu_interpret_mode():
        assert np.isnan(np.asarray(ro_call(jtile))).all()
    got = pk.read_sum(tile).numpy()
    assert got.shape == (1, D)
    # two f32 sums of n terms in different orders: each within γ_n·Σ|x|
    n = t_rows * k
    scale = tile.float().abs().sum(dim=(0, 1)).numpy()[None]
    _within(got, want, scale, 2 * n * U / (1 - n * U))


@pytest.mark.parametrize("rows,dtype", [(0, torch.bfloat16),
                                        (1, torch.float32),
                                        (64368, torch.bfloat16),
                                        (300_000, torch.float32),
                                        (3_000_000, torch.bfloat16)])
def test_read_sum_plan_covers_the_rows(rows, dtype):
    blocks, per_block, adds = pk.read_sum_plan(rows, dtype)
    assert 1 <= blocks <= pk.READ_MAX_BLOCKS and blocks * per_block >= rows
    assert (blocks - 1) * per_block < max(rows, 1)  # no block is empty
    if rows == 64368:  # one take group of the probe: 252 blocks of 256
        assert (blocks, per_block, adds) == (252, 256, 16 + 16 + 252)


# -- the wrappers' input checks -----------------------------------------------------


def _bad_calls():
    tbl = torch.zeros((8, D), dtype=torch.bfloat16)
    idx = torch.zeros((4, 2), dtype=torch.int32)
    xi = torch.zeros((4, D))
    xj = torch.zeros((4, 2, D), dtype=torch.bfloat16)
    deg = torch.zeros(4, dtype=torch.int32)
    meta = torch.empty((8, D), dtype=torch.bfloat16, device="meta")
    # xj whose rows start 2 bytes past a 16-byte boundary
    shifted = torch.zeros(4 * 2 * D + 1, dtype=torch.bfloat16)[1:].view(4, 2, D)
    table = pk.tile_work_table
    return [
        lambda: pk.take_sum(tbl, idx.long()),
        lambda: pk.take_sum(tbl.half(), idx),
        lambda: pk.take_sum(tbl, idx[:, 0]),
        lambda: pk.take_sum(meta, idx.to("meta")),
        lambda: pk.resident_gather(tbl, idx),
        lambda: pk.resident_gather(tbl, idx[:, 0], out=torch.zeros((3, D))),
        lambda: pk.resident_gather(meta, idx[:, 0].to("meta")),
        lambda: pk.read_sum(tbl),
        lambda: pk.read_sum(xj.transpose(0, 1)),
        lambda: pk.read_sum(xj.to("meta")),
        lambda: pk.tile_force_tc(xi, xj, deg[:3], STEP),
        lambda: pk.tile_force_tc(xi[:3], xj, deg, STEP),
        lambda: pk.tile_force_tc(xi.double(), xj, deg, STEP),
        lambda: pk.tile_force_tc(xi.to("meta"), xj.to("meta"),
                                 deg.to("meta"), STEP),
        # tile_work_table's input checks
        lambda: table([]),
        lambda: table([(xi, xj, deg)] * 65),
        lambda: table([(xi.double(), xj, deg)]),
        lambda: table([(xi, xj.half(), deg)]),
        lambda: table([(xi, xj, deg.long())]),
        lambda: table([(xi, xj, deg), (xi, xj.float(), deg)]),
        lambda: table([(xi[:3], xj, deg)]),
        lambda: table([(xi, xj, deg[:3])]),
        lambda: table([(xi, xj[:, 0], deg)]),
        lambda: table([(xi[:, :64].contiguous(), xj[:, :, :64].contiguous(),
                        deg)]),
        lambda: table([(xi, xj, deg.to("meta"))]),
        lambda: table([(xi, xj, deg), (xi.to("meta"), xj.to("meta"),
                                       deg.to("meta"))]),
        lambda: table([(xi, xj, deg + 3)]),
        lambda: table([(xi, xj, deg - 1)]),
        lambda: table([(xi, shifted, deg)]),
        lambda: table([(xi[:0], xj[:0], deg[:0])]),
    ]


@pytest.mark.parametrize("case", range(len(_bad_calls())))
def test_probe_wrappers_reject_bad_inputs(case):
    """Wrong dtype, rank, shape or layout raises; so does a device with no
    kernel (the wrappers fall back to the plain version only on the CPU)."""
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_probe_wrappers_count_no_cpu_launch(tile_table):
    pk.reset_launch_counts()
    tbl = torch.ones((8, D))
    pk.take_sum(tbl, torch.zeros((2, 3), dtype=torch.int32))
    pk.read_sum(tbl[None])
    work = tile_table[0]
    pk.tile_force_tc_table(work, STEP)
    pk.tile_force_tc(*work.parts[0], STEP)
    assert set(pk.launch_counts.values()) == {0}


@pytest.mark.parametrize("k,rows", [(1, 32), (5, 6), (16, 2), (32, 1)])
def test_take_sum_stage_holds_whole_rows(k, rows):
    assert pk.take_sum_rows_per_stage(k) == rows
    assert rows * k <= pk.TAKE_STAGE_IDS


# -- tools/probes.py on the CPU ------------------------------------------------------


@pytest.fixture(scope="module")
def small_graph():
    return synth_powerlaw_graph(n=400, avg_deg=6, seed=3)


def _untimed(recs, *fields):
    for r in recs:
        for f in fields:
            assert f in r and r[f] is None, (r, f)


def test_exp_vmem_take_on_cpu():
    recs = probes.exp_vmem_take("cpu", h=64, c=512, k=4)
    assert [r["dtype"] for r in recs] == ["bfloat16", "float32"]
    assert all(r["max_abs_err"] == 0.0 and r["rows"] == 512 for r in recs)
    assert all((r["filler"], r["stages"]) == ("cp.async", pk.TAKE_STAGES)
               for r in recs)
    _untimed(recs, "ms", "m_rows_per_s", "l2_tb_per_s", "library_ms")


def test_exp_dg_on_cpu():
    recs = probes.exp_dg("cpu", hs=(64, 96), total=256)
    assert [(r["dtype"], r["H"], r["rows"]) for r in recs] == [
        ("bfloat16", 64, 256), ("bfloat16", 96, 192),
        ("float32", 64, 256), ("float32", 96, 192)]
    assert all(r["exact"] for r in recs)
    _untimed(recs, "ms", "m_rows_per_s", "gb_per_s", "library_ms")


def test_exp_sweepfloor_on_cpu(small_graph):
    group_bytes = 8 * 16 * D * 2  # 128 rows per group
    recs = probes.exp_sweepfloor(small_graph, "cpu", group_bytes=group_bytes,
                                 min_width=4, hub_width=8)
    assert [r["variant"] for r in recs] == ["copy_rw", "read_sum",
                                           "read_sum_whole", "take_static"]
    assert all((r["rows_per_group"], r["t_rows"]) == (128, 8)
               and r["groups"] > 1 for r in recs)
    assert recs[1]["max_abs_err"] == recs[2]["max_abs_err"] == 0.0
    _untimed(recs, "ms")
    _untimed(recs[1:3], "gb_per_s", "library_ms")


def test_exp_sweepvar_on_cpu(small_graph):
    recs = probes.exp_sweepvar(small_graph, "cpu", min_width=4, hub_width=8,
                               parity_bucket=1)
    assert [r["kind"] for r in recs] == ["cuda", "tc", "plain", "mxu_parity"]
    _untimed(recs[:3], "ms")
    # the clipped diff form against the edge kernel's coefficient form, f32
    assert recs[3]["width"] == 8 and recs[3]["max_err"] < 1e-7


@pytest.mark.parametrize("padded,group_bytes", [(2_574_784, None),
                                                (1000, None), (50_000, 65536)])
def test_take_group_shape(padded, group_bytes):
    """The JAX package's take-group size at the bench layout's 2,574,784
    padded slots (exp_r4.py's 40 groups of [4023, 16, 128]), and its 8 MB
    floor."""
    rows, groups, t_rows = probes.take_group_shape(padded,
                                                   group_bytes=group_bytes)
    if padded == 2_574_784:
        assert (rows, groups, t_rows) == (64368, 40, 4023)
    want_bytes = group_bytes or max(8 << 20, min(32 << 20, padded * 256 // 40))
    assert rows == want_bytes // 256 // 16 * 16 and t_rows * 16 == rows
    assert groups == padded // rows


def test_take_group_size_is_the_jax_package_s(small_graph):
    g = JaxGraph(small_graph.n, small_graph.rowptr, small_graph.colids)
    jfv = JaxSync(g, JaxConfig(dim=D, model="tdist", ns=5, batch_size=256,
                               gather_dtype="bfloat16"),
                  min_width=8, hub_width=128, use_pallas=False)
    assert probes.take_group_shape(jfv.layout.padded_edges)[0] == (
        jfv.take_group_bytes // (D * 2) // 16 * 16)


def test_every_bound_entry_point_is_defined_once():
    """Each C function ``_build`` declares is defined in exactly one
    source, with one argument per declared type (nvcc cannot run here, so
    a misspelt or mis-declared binding would show only on the card)."""
    from force2vec_tpu_torch.ops import _build
    srcs = "\n".join(p.read_text() for p in _build.sources())
    for name, argtypes in _build._SIGNATURES.items():
        defs = re.findall(rf'extern "C" int {name}\(([^)]*)\)', srcs)
        assert len(defs) == 1, name
        assert len(defs[0].split(",")) == len(argtypes), name


def test_probe_tool_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probes.main(["dg"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_ptxas_summary_names_the_probe_kernels():
    smoke = _smoke()
    prefix = "ptxas info    : Compiling entry function '_ZN3f2v50_GLOBAL__N__"
    names = [
        "c28_17_take_sum_cu_f6deec6b15take_sum_kernelI13__nv_bfloat16EEvPKT_"
        "PKiPfiii",
        "c28_17_tile_force_tc_cu_f6deec6b20tile_force_tc_kernelIfEEvN3f2v12_"
        "GLOBAL__N_18TileArgsE",
        "c28_17_resident_gather_cu_f6deec6b22resident_gather_kernelILi32EEEv"
        "PK5uint4PKiPS2_l",
        "c28_17_read_sum_cu_f6deec6b24read_sum_partial_kernelI13__nv_bfloat16"
        "Li128EEEvPKT_Pfll",
        "c28_17_read_sum_cu_f6deec6b21read_sum_final_kernelILi128EEEvPKfPfi",
    ]
    log = "\n".join(f"{prefix}{n}' for 'sm_90a'\n"
                    "ptxas info    : Used 40 registers, used 0 barriers"
                    for n in names)
    assert [s.split(":")[0] for s in smoke.ptxas_summary(log)] == [
        "take_sum_kernel<bf16>", "tile_force_tc_kernel<f32>",
        "resident_gather_kernel<32>", "read_sum_partial_kernel<bf16, 128>",
        "read_sum_final_kernel<128>"]
    assert set(smoke.CUDA_KERNELS) >= {s.split("<")[0] for s in
                                       smoke.ptxas_summary(log)}


def test_smoke_take_sum_bound_rejects_planted_faults():
    """chip_smoke.py's take_sum check on the CPU wrapper: the true output
    meets the bound exactly, and both planted faults (the last of K rows
    skipped, each ring stage one row short) fail it."""
    smoke = _smoke()
    rng = np.random.default_rng(8)
    tbl, _ = _table(rng, (64, D), "bfloat16")
    idx = torch.from_numpy(rng.integers(0, 64, (10, 16)).astype(np.int32))
    got = pk.take_sum(tbl, idx)
    assert smoke.bound_ratio(got, pk.take_sum_terms(tbl, idx)) == 0.0
    skip, short = smoke.take_sum_planted_fault_ratios(tbl, idx, got)
    assert skip > 1.0 and short > 1.0


def test_smoke_tile_table_bound_rejects_planted_faults(tile_table):
    """chip_smoke.py's tile table check on the CPU wrapper: both planted
    faults (each row's last slot skipped, the first entry skipped) fail the
    bound, and the first entry is the widest part."""
    smoke = _smoke()
    work = tile_table[0]
    got = pk.tile_force_tc_table(work, STEP)
    for out, part in zip(got, work.parts):
        assert smoke.bound_ratio(out, pk.tile_force_tc_terms(*part, STEP),
                                 smoke.TC_RTOL) == 0.0
    skip, first = smoke.tile_table_planted_fault_ratios(work, got, STEP)
    assert skip > 1.0 and first > 1.0
