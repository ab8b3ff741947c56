"""Graph and embedding IO, a copy of ``force2vec_tpu/graphs/io.py``.

MatrixMarket reading follows the reference reader's semantics
(sample/IO.h:60-156): a ``symmetric`` header mirrors every off-diagonal
entry and *drops* self-loops entirely; a missing value column means weight
1.0; a general (non-symmetric) file is taken verbatim.  The binary ``.bcsr``
format matches ``ReadBinary`` (sample/IO.h:11-57): ``m, n, nnz`` as uint32
followed by ``rows[nnz]`` (uint32), ``cols[nnz]`` (uint32), ``vals[nnz]``
(float32), i.e. a raw COO dump.

Embedding files use the reference's text ``.embd`` schema
(sample/algorithms.h:118-136): header ``N D`` then one line per node of
``id+1 v0 … vD-1``.

The native C++ reader and writer (``graphs/native.py``) run unless
``F2V_NO_NATIVE=1``; the numpy code below is the reference path and the
fallback, and gives identical arrays and bytes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from force2vec_tpu_torch.graphs import native
from force2vec_tpu_torch.graphs.csr import Graph


def _parse_numeric_body(text_lines, ncols_hint: Optional[int] = None) -> np.ndarray:
    """Whitespace-split a block of numeric lines into a [k, ncols] float64
    array. MatrixMarket bodies have a consistent column count."""
    blob = " ".join(text_lines)
    flat = np.array(blob.split(), dtype=np.float64)
    if ncols_hint is None:
        ncols_hint = len(text_lines[0].split())
    return flat.reshape(-1, ncols_hint)


def _native_enabled() -> bool:
    return os.environ.get("F2V_NO_NATIVE", "") != "1"


#: which parser produced the last read_mtx/read_edgelist result —
#: "native" (C++ mmap+OpenMP) or "numpy" (fallback), so a measurement can
#: say which one it timed.
last_parser: str = "none"


def _dedupe_rows(g: Graph) -> Graph:
    """Drop duplicate (row, col) entries from a per-row-sorted CSR
    (vectorized; values of kept entries preserved)."""
    rows = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.rowptr))
    keep = np.ones(g.nnz, dtype=bool)
    if g.nnz > 1:
        keep[1:] = (rows[1:] != rows[:-1]) | (g.colids[1:] != g.colids[:-1])
    if keep.all():
        return g
    colids = g.colids[keep]
    values = g.values[keep] if g.values is not None else None
    counts = np.bincount(rows[keep], minlength=g.n)
    rowptr = np.zeros(g.n + 1, dtype=g.rowptr.dtype)
    np.cumsum(counts, out=rowptr[1:])
    return Graph(n=g.n, rowptr=rowptr, colids=colids, values=values)


def read_mtx(path: str) -> Graph:
    """Read a MatrixMarket coordinate file into a CSR :class:`Graph`.

    Semantics match sample/IO.h:60-156: symmetric headers mirror
    off-diagonal entries and drop self-loops; entries are 1-based.
    """
    global last_parser
    if _native_enabled():
        out = native.load_mtx_native(path)
        if out is not None:
            last_parser = "native"
            n, rowptr, colids, values = out
            return Graph(n=n, rowptr=rowptr, colids=colids, values=values)
    last_parser = "numpy"

    with open(path, "r") as f:
        header = f.readline()
        is_symmetric = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, _nnz = (int(tok) for tok in line.split()[:3])
        body = f.read()

    toks = body.split()
    # Column count: total tokens must divide evenly by 2 or 3.
    if len(toks) % 3 == 0 and len(toks) % 2 == 0:
        # ambiguous (e.g. 6 tokens): count tokens on the first data line
        first_line = body.lstrip().split("\n", 1)[0]
        ncols = len(first_line.split())
    elif len(toks) % 3 == 0:
        ncols = 3
    else:
        ncols = 2
    data = np.array(toks, dtype=np.float64).reshape(-1, ncols)

    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = data[:, 2].astype(np.float32) if ncols == 3 else np.ones(len(rows), np.float32)

    if is_symmetric:
        off = rows != cols  # drop self-loops (sample/IO.h:130-134)
        rows, cols, vals = rows[off], cols[off], vals[off]
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        vals = np.concatenate([vals, vals])

    return Graph.from_coo(rows, cols, vals, n=max(m, n))


def read_edgelist(
    path: str,
    zero_based: bool = True,
    symmetrize: bool = True,
    drop_self_loops: bool = True,
) -> Graph:
    """Read a whitespace edge list (``u v [w]`` per line)."""
    global last_parser
    if _native_enabled():
        out = native.load_edgelist_native(
            path,
            zero_based=zero_based,
            symmetrize=symmetrize,
            drop_self_loops=drop_self_loops,
        )
        if out is not None:
            last_parser = "native"
            n, rowptr, colids, values = out
            g = Graph(n=n, rowptr=rowptr, colids=colids, values=values)
            if symmetrize:
                g = _dedupe_rows(g)  # both-direction inputs double up on mirror
            return g
    last_parser = "numpy"

    with open(path, "r") as f:
        body = f.read()
    lines = [ln for ln in body.splitlines() if ln.strip() and not ln.startswith(("#", "%"))]
    data = _parse_numeric_body(lines)
    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    vals = data[:, 2].astype(np.float32) if data.shape[1] > 2 else np.ones(len(rows), np.float32)
    if not zero_based:
        rows, cols = rows - 1, cols - 1
    # vertex count includes vertices whose only edge is a (dropped) self-loop
    n = int(max(rows.max(), cols.max())) + 1 if len(rows) else 0
    if drop_self_loops:
        off = rows != cols
        rows, cols, vals = rows[off], cols[off], vals[off]
    if symmetrize:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        vals = np.concatenate([vals, vals])
        # dedupe in case the list already contained both directions
        key = rows * n + cols
        _, idx = np.unique(key, return_index=True)
        rows, cols, vals = rows[idx], cols[idx], vals[idx]
    return Graph.from_coo(rows, cols, vals, n=n)


def read_binary_csr(path: str) -> Graph:
    """Read the reference's raw binary COO dump (sample/IO.h:11-57)."""
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype=np.uint32, count=3)
        m, n, nnz = (int(x) for x in head)
        rows = np.fromfile(f, dtype=np.uint32, count=nnz).astype(np.int64)
        cols = np.fromfile(f, dtype=np.uint32, count=nnz).astype(np.int64)
        vals = np.fromfile(f, dtype=np.float32, count=nnz)
    return Graph.from_coo(rows, cols, vals, n=max(m, n))


def load_graph(path: str, **kwargs) -> Graph:
    """Load a graph by file extension (.mtx, .bcsr, else edge list)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mtx":
        return read_mtx(path)
    if ext == ".bcsr":
        return read_binary_csr(path)
    return read_edgelist(path, **kwargs)


def write_embeddings(path: str, emb) -> None:
    """Write a text ``.embd`` file: ``N D`` header then ``id+1 v…`` rows
    (schema of algorithms::writeToFile, sample/algorithms.h:118-136).

    ``emb`` is an [n, d] array or tensor (a tensor is copied to the host).
    The native OpenMP writer formats the rows in parallel; the numpy
    fallback batches the formatting through ``np.savetxt``."""
    if hasattr(emb, "detach"):
        emb = emb.detach().cpu().numpy()
    emb = np.asarray(emb, dtype=np.float32)
    n, d = emb.shape
    if _native_enabled() and native.write_embd_native(path, emb):
        return
    with open(path, "w") as f:
        f.write(f"{n} {d}\n")
        body = np.concatenate(
            [np.arange(1, n + 1, dtype=np.float32)[:, None], emb], axis=1
        )
        np.savetxt(f, body, fmt=["%d"] + ["%.6g"] * d, newline=" \n")


def read_embeddings(path: str) -> np.ndarray:
    """Read a text ``.embd`` file (ids are 1-based and may be unordered)."""
    with open(path, "r") as f:
        n, d = (int(t) for t in f.readline().split()[:2])
        data = np.array(f.read().split(), dtype=np.float64).reshape(n, d + 1)
    emb = np.zeros((n, d), dtype=np.float32)
    ids = data[:, 0].astype(np.int64) - 1
    emb[ids] = data[:, 1:].astype(np.float32)
    return emb


def read_embeddings_binary(path: str, dim: int) -> np.ndarray:
    """Raw float32 [n, dim] dump (readBinEmbeddings,
    performancescores/runnodeclassclust.py:81-99)."""
    flat = np.fromfile(path, dtype=np.float32)
    return flat.reshape(-1, int(dim))


def read_embeddings_hope(path: str) -> np.ndarray:
    """HOPE text output: one header line, then whitespace-separated rows in
    vertex order (readEmbeddingsHOPE, runnodeclassclust.py:35-50)."""
    with open(path, "r") as f:
        f.readline()
        rows = [
            [float(t) for t in line.split()] for line in f if line.strip()
        ]
    return np.asarray(rows, dtype=np.float32)


def read_embeddings_rolx(path: str) -> np.ndarray:
    """ROLX CSV output: one header line, then comma-separated rows in vertex
    order (readEmbeddingsROLX, runnodeclassclust.py:18-33)."""
    with open(path, "r") as f:
        f.readline()
        rows = [
            [float(t) for t in line.strip().split(",")] for line in f if line.strip()
        ]
    return np.asarray(rows, dtype=np.float32)


def read_embeddings_harp(path: str) -> np.ndarray:
    """HARP ``.npy`` dump (readEmbeddingsHARP, runnodeclassclust.py:52-55)."""
    return np.asarray(np.load(path), dtype=np.float32)


def read_embeddings_any(path: str, fmt: int = 1, dim: int = 0) -> np.ndarray:
    """Dispatch on the reference eval scripts' embedding-format option codes
    (runnodeclassclust.py:233-245): 1 = Force2Vec text ``.embd``, 3 = HOPE,
    4 = ROLX CSV, 5 = HARP ``.npy``, anything else = raw float32 binary
    (needs ``dim``), so the evaluation can score other embedding tools'
    output too."""
    if fmt == 1:
        return read_embeddings(path)
    if fmt == 3:
        return read_embeddings_hope(path)
    if fmt == 4:
        return read_embeddings_rolx(path)
    if fmt == 5:
        return read_embeddings_harp(path)
    if dim <= 0:
        raise ValueError("binary embedding format needs dim > 0")
    return read_embeddings_binary(path, dim)
