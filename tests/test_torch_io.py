"""The port's graph IO, native loader, graph tools and the rest of ``Graph``
against the JAX package's, on the same files.

The JAX readers run with ``F2V_NO_NATIVE=1``: their numpy path is the
reference.  The port's readers run both ways, native (C++, built with g++
at first use) and numpy, and must give equal arrays; its writers must give
the same bytes as the JAX package's.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import force2vec_tpu_torch
from force2vec_tpu.graphs import io as jio
from force2vec_tpu.graphs import tools as jtools
from force2vec_tpu.graphs.csr import Graph as JaxGraph
from force2vec_tpu_torch.graphs import io as tio
from force2vec_tpu_torch.graphs import native, synth_powerlaw_graph
from force2vec_tpu_torch.graphs import tools as ttools
from force2vec_tpu_torch.graphs.csr import Graph

KARATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "karate.mtx")

MTX_FILES = {
    # pattern, symmetric, with self-loops (dropped) and a comment block
    "sym_pattern_loops": "%%MatrixMarket matrix coordinate pattern symmetric\n"
                         "% two comment\n% lines\n"
                         "6 6 8\n1 1\n2 1\n3 2\n3 3\n4 1\n5 4\n6 5\n6 2\n",
    # real, general: taken verbatim, self-loop and values kept
    "general_real": "%%MatrixMarket matrix coordinate real general\n"
                    "5 5 7\n1 2 0.5\n2 1 1.25\n2 3 -3\n3 3 2\n4 5 7.5\n"
                    "5 1 1e-3\n1 4 2\n",
    # real, symmetric: mirrored with its values, self-loop dropped
    "sym_real": "%%MatrixMarket matrix coordinate real symmetric\n"
                "4 4 5\n2 1 0.25\n3 1 4\n3 3 9\n4 2 -1.5\n4 3 8\n",
}


def _set_native(monkeypatch, on: bool):
    if on:
        monkeypatch.delenv("F2V_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("F2V_NO_NATIVE", "1")


def _jax_read(monkeypatch, fn, *args, **kw):
    """A JAX reader on its numpy reference path."""
    _set_native(monkeypatch, False)
    return fn(*args, **kw)


def _assert_same_graph(g, ref, values=True):
    assert g.n == ref.n
    np.testing.assert_array_equal(g.rowptr, ref.rowptr)
    np.testing.assert_array_equal(g.colids, ref.colids)
    assert g.rowptr.dtype == np.int64 and g.colids.dtype == np.int32
    if values:
        if ref.values is None:
            assert g.values is None
        else:
            np.testing.assert_array_equal(g.values, ref.values)


def _big_mtx(path):
    """A >1 MiB symmetric pattern file (the native parser splits it over
    threads), written by the JAX package's writer."""
    g = synth_powerlaw_graph(n=30000, avg_deg=12, seed=5)
    jtools.write_mtx(JaxGraph(g.n, g.rowptr, g.colids), str(path))
    assert os.path.getsize(path) > 1 << 20
    return g


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("name", sorted(MTX_FILES) + ["karate", "big"])
def test_read_mtx_matches_jax(tmp_path, monkeypatch, name, native_on):
    if name == "karate":
        path = KARATE
    elif name == "big":
        path = str(tmp_path / "big.mtx")
        _big_mtx(path)
    else:
        path = str(tmp_path / f"{name}.mtx")
        with open(path, "w") as f:
            f.write(MTX_FILES[name])
    ref = _jax_read(monkeypatch, jio.read_mtx, path)
    _set_native(monkeypatch, native_on)
    g = tio.read_mtx(path)
    assert tio.last_parser == ("native" if native_on else "numpy")
    # the native reader gives no values for a pattern file, numpy ones
    pattern = "pattern" in open(path).readline()
    _assert_same_graph(g, ref, values=not (native_on and pattern))
    if native_on and pattern:
        assert g.values is None
    assert g.is_sorted()


def test_karate_is_zacharys_club():
    g = tio.read_mtx(KARATE)
    assert (g.n, g.nnz) == (34, 156)
    assert g.degrees.max() == 17 and g.degrees.argmax() == 33
    assert g.degrees[0] == 16


EDGELIST = "# comment\n0 1\n1 2\n2 0\n1 0\n3 3\n2 4\n4 2\n5 1\n"


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("zero_based", [True, False])
@pytest.mark.parametrize("symmetrize", [True, False])
def test_read_edgelist_matches_jax(tmp_path, monkeypatch, native_on,
                                   zero_based, symmetrize):
    """Both directions listed, a duplicate pair and a self-loop; ids 0- or
    1-based."""
    p = tmp_path / "g.edgelist"
    body = EDGELIST
    if not zero_based:
        body = "\n".join(" ".join(str(int(t) + 1) for t in ln.split())
                         if not ln.startswith("#") else ln
                         for ln in EDGELIST.splitlines()) + "\n"
    p.write_text(body)
    kw = dict(zero_based=zero_based, symmetrize=symmetrize)
    ref = _jax_read(monkeypatch, jio.read_edgelist, str(p), **kw)
    _set_native(monkeypatch, native_on)
    g = tio.read_edgelist(str(p), **kw)
    assert tio.last_parser == ("native" if native_on else "numpy")
    _assert_same_graph(g, ref, values=not native_on)
    if native_on:
        assert g.values is None  # no value column in the file


@pytest.mark.parametrize("native_on", [True, False])
def test_read_weighted_edgelist_matches_jax(tmp_path, monkeypatch, native_on):
    p = tmp_path / "w.txt"
    p.write_text("0 1 0.5\n1 2 2.5\n2 0 -1\n1 0 0.5\n3 2 4\n")
    ref = _jax_read(monkeypatch, jio.read_edgelist, str(p))
    _set_native(monkeypatch, native_on)
    _assert_same_graph(tio.read_edgelist(str(p)), ref)


def _write_bcsr(path, m, n, rows, cols, vals):
    with open(path, "wb") as f:
        np.asarray([m, n, len(rows)], np.uint32).tofile(f)
        np.asarray(rows, np.uint32).tofile(f)
        np.asarray(cols, np.uint32).tofile(f)
        np.asarray(vals, np.float32).tofile(f)


def test_read_binary_csr_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 40, 300)
    cols = rng.integers(0, 50, 300)
    path = str(tmp_path / "g.bcsr")
    _write_bcsr(path, 40, 50, rows, cols, rng.normal(size=300))
    ref = _jax_read(monkeypatch, jio.read_binary_csr, path)
    g = tio.read_binary_csr(path)
    assert g.n == 50
    _assert_same_graph(g, ref)


@pytest.mark.parametrize("ext", [".mtx", ".bcsr", ".edgelist", ".txt"])
def test_load_graph_dispatch(tmp_path, monkeypatch, ext):
    path = str(tmp_path / f"g{ext}")
    if ext == ".mtx":
        with open(path, "w") as f:
            f.write(MTX_FILES["sym_real"])
    elif ext == ".bcsr":
        _write_bcsr(path, 5, 5, [0, 1, 4], [1, 2, 0], [1.0, 2.0, 3.0])
    else:
        with open(path, "w") as f:
            f.write(EDGELIST)
    ref = _jax_read(monkeypatch, jio.load_graph, path)
    _set_native(monkeypatch, False)
    _assert_same_graph(force2vec_tpu_torch.load_graph(path), ref)
    _set_native(monkeypatch, True)
    _assert_same_graph(force2vec_tpu_torch.load_graph(path), ref,
                       values=ext == ".bcsr" or ext == ".mtx")


def _embedding(n=37, d=9, seed=0):
    rng = np.random.default_rng(seed)
    emb = (rng.normal(size=(n, d)) * 10.0 ** rng.integers(-8, 8, (n, d))
           ).astype(np.float32)
    emb[0, :4] = [0.0, -0.0, 1e-30, 123456789.0]
    return emb


def test_embd_writers_give_identical_bytes(tmp_path, monkeypatch):
    """The native writer, the numpy writer and the JAX package's numpy
    writer all write the same bytes."""
    emb = _embedding()
    paths = {k: str(tmp_path / f"{k}.embd") for k in ("native", "numpy", "jax")}
    _set_native(monkeypatch, True)
    assert native.write_embd_native(paths["native"], emb)
    _set_native(monkeypatch, False)
    tio.write_embeddings(paths["numpy"], emb)
    jio.write_embeddings(paths["jax"], emb)
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert blobs["native"] == blobs["numpy"] == blobs["jax"]
    assert blobs["native"].startswith(b"37 9\n1 ")


def test_embd_files_cross_packages(tmp_path, monkeypatch):
    """JAX writes and the port reads; the port writes (native, from a
    tensor) and JAX reads.  Every value within the ``%.6g`` text's
    rounding: relative 5e-6, absolute 1e-30 near 0."""
    emb = _embedding(seed=1)
    a, b = str(tmp_path / "jax.embd"), str(tmp_path / "port.embd")
    _set_native(monkeypatch, False)
    jio.write_embeddings(a, emb)
    _set_native(monkeypatch, True)
    force2vec_tpu_torch.write_embeddings(b, torch.from_numpy(emb))
    for path in (a, b):
        got = force2vec_tpu_torch.read_embeddings(path)
        np.testing.assert_array_equal(got, jio.read_embeddings(path))
        np.testing.assert_allclose(got, emb, rtol=5e-6, atol=1e-30)
        assert got.dtype == np.float32 and got.shape == emb.shape


def test_read_embeddings_unordered_ids(tmp_path):
    p = tmp_path / "u.embd"
    p.write_text("3 2\n3 5 6\n1 1 2\n2 3 4\n")
    np.testing.assert_array_equal(tio.read_embeddings(str(p)),
                                  [[1, 2], [3, 4], [5, 6]])


def test_third_party_embedding_readers(tmp_path):
    """Format option codes of the reference eval scripts
    (runnodeclassclust.py:233-245): 3=HOPE, 4=ROLX, 5=HARP, else binary;
    the port's reader equals the JAX package's on each."""
    x = np.arange(15, dtype=np.float32).reshape(5, 3) / 7.0
    cases = []
    p = tmp_path / "h.txt"
    p.write_text("5 3\n" + "\n".join(" ".join(map(str, r)) for r in x))
    cases.append((str(p), 3, 0))
    p = tmp_path / "r.csv"
    p.write_text("a,b,c\n" + "\n".join(",".join(map(str, r)) for r in x))
    cases.append((str(p), 4, 0))
    p = tmp_path / "x.npy"
    np.save(p, x)
    cases.append((str(p), 5, 0))
    p = tmp_path / "x.bin"
    x.tofile(p)
    cases.append((str(p), 2, 3))
    for path, fmt, dim in cases:
        got = tio.read_embeddings_any(path, fmt, dim=dim)
        np.testing.assert_array_equal(got, jio.read_embeddings_any(path, fmt,
                                                                   dim=dim))
        np.testing.assert_allclose(got, x, rtol=1e-6)
    with pytest.raises(ValueError):
        tio.read_embeddings_any(str(p), 2)


@pytest.mark.parametrize("pattern", [True, False])
def test_write_mtx_matches_jax_bytes(tmp_path, monkeypatch, pattern):
    rng = np.random.default_rng(4)
    g = synth_powerlaw_graph(n=300, avg_deg=6, seed=2)
    src = np.repeat(np.arange(g.n), g.degrees)
    # symmetric values: the same weight on both directions of an edge
    w = (rng.random(g.n * g.n).astype(np.float32)
         [np.minimum(src, g.colids) * g.n + np.maximum(src, g.colids)])
    g = Graph(g.n, g.rowptr, g.colids, None if pattern else w)
    a, b = str(tmp_path / "port.mtx"), str(tmp_path / "jax.mtx")
    ttools.write_mtx(g, a, pattern=pattern)
    jtools.write_mtx(JaxGraph(g.n, g.rowptr, g.colids, g.values), b,
                     pattern=pattern)
    assert open(a, "rb").read() == open(b, "rb").read()
    _set_native(monkeypatch, True)
    back = tio.read_mtx(a)
    np.testing.assert_array_equal(back.rowptr, g.rowptr)
    np.testing.assert_array_equal(back.colids, g.colids)
    if not pattern:
        np.testing.assert_allclose(back.values, g.values, rtol=1e-6)


def test_tools_main(tmp_path, capsys, monkeypatch):
    """``edgelist2mtx`` writes the JAX tool's bytes; ``avgdeg`` prints the
    same average degree; no command prints the usage and returns 2."""
    p = tmp_path / "g.edgelist"
    p.write_text(EDGELIST)
    _set_native(monkeypatch, False)
    jax_out = str(tmp_path / "jax.mtx")
    assert jtools.main(["edgelist2mtx", str(p), jax_out]) == 0
    _set_native(monkeypatch, True)
    assert ttools.main(["edgelist2mtx", str(p)]) == 0
    port_out = str(p) + ".mtx"
    assert f"wrote {port_out}" in capsys.readouterr().out
    assert open(port_out, "rb").read() == open(jax_out, "rb").read()
    assert ttools.main(["avgdeg", KARATE]) == 0
    assert capsys.readouterr().out.strip() == (
        f"Average Degree: {156 / 34}")
    assert ttools.average_degree(tio.read_mtx(KARATE)) == \
        jtools.average_degree(_jax_read(monkeypatch, jio.read_mtx, KARATE))
    assert ttools.main([]) == 2
    assert "edgelist2mtx" in capsys.readouterr().out


def _graphs():
    g = synth_powerlaw_graph(n=200, avg_deg=6, seed=9)
    vals = np.random.default_rng(1).random(g.nnz).astype(np.float32)
    return [tio.read_mtx(KARATE), Graph(g.n, g.rowptr, g.colids, vals)]


@pytest.mark.parametrize("which", [0, 1])
def test_graph_methods_match_jax(which):
    g = _graphs()[which]
    j = JaxGraph(g.n, g.rowptr, g.colids, g.values)
    for seed in (0, 1):
        _assert_same_graph(g.shuffled_ids(seed), j.shuffled_ids(seed))
    rng = np.random.default_rng(2)
    for nodes in (np.arange(10), rng.choice(g.n, g.n // 2, replace=False)):
        _assert_same_graph(g.induced_subgraph(nodes), j.induced_subgraph(nodes))
    shuffled = g.shuffled_ids(0)
    assert g.is_sorted() and j.is_sorted()
    assert not shuffled.is_sorted()
    assert not JaxGraph(g.n, shuffled.rowptr, shuffled.colids).is_sorted()
    assert Graph(3, np.array([0, 1, 1, 2]), np.array([2, 0], np.int32)
                 ).is_sorted()


def test_native_build_concurrent(tmp_path, monkeypatch):
    """Builds started at once all land on one keyed library, which loads:
    each builds in its own temporary directory and renames into place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: native.build(), range(4)))
    assert len(set(paths)) == 1 and paths[0] == native.library_path()
    assert paths[0].parent == tmp_path / "build"
    assert paths[0].name.startswith("libgraphio_")
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        paths[0].name]
    assert native.build() == paths[0]


def test_no_compiler_falls_back_to_numpy(tmp_path, monkeypatch):
    """Without g++ the loaders return None and the numpy readers run."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    _set_native(monkeypatch, True)
    assert native.load_mtx_native(KARATE) is None
    assert not native.write_embd_native(str(tmp_path / "x.embd"),
                                        np.zeros((2, 2), np.float32))
    g = tio.read_mtx(KARATE)
    assert tio.last_parser == "numpy" and g.nnz == 156


def test_package_exports_io():
    for name in ("load_graph", "read_mtx", "read_embeddings",
                 "write_embeddings"):
        assert name in force2vec_tpu_torch.__all__
        assert getattr(force2vec_tpu_torch, name) is getattr(tio, name)
