"""Offline data tooling, a copy of ``force2vec_tpu/graphs/tools.py``: the
reference's two dataset utilities, vectorized.

* ``edgelist2mtx``: edge list → MatrixMarket symmetric-pattern file
  (datasets/edgelist2mtx.py:1-19, which goes through networkx; here the
  package's own edge-list reader + a vectorized writer).
* ``avgdeg``: average degree of an ``.mtx`` graph
  (datasets/input/averagedeg.py:1-22 — networkx degree dict; here one
  rowptr diff).

CLI: ``python -m force2vec_tpu_torch.graphs.tools edgelist2mtx <edges> [out.mtx]``
     ``python -m force2vec_tpu_torch.graphs.tools avgdeg <graph.mtx>``
"""

from __future__ import annotations

import sys

import numpy as np

from force2vec_tpu_torch.graphs.csr import Graph
from force2vec_tpu_torch.graphs.io import load_graph, read_edgelist


def write_mtx(graph: Graph, path: str, pattern: bool = True) -> None:
    """Write a Graph as a MatrixMarket coordinate file.

    Symmetric graphs (the package's canonical form) are written as
    ``symmetric`` with each undirected edge once (lower triangle, 1-based),
    matching what the reference's converter produces and its reader
    (sample/IO.h:60-156) expects."""
    deg = graph.degrees
    src = np.repeat(np.arange(graph.n, dtype=np.int64), deg)
    dst = graph.colids.astype(np.int64)
    keep = src >= dst  # lower triangle once (self-loops impossible post-load)
    src, dst = src[keep], dst[keep]
    vals = None if pattern else graph.values[keep]
    kind = "pattern" if pattern else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {kind} symmetric\n")
        f.write("%\n")
        f.write(f"{graph.n} {graph.n} {len(src)}\n")
        if pattern:
            body = np.stack([src + 1, dst + 1], axis=1)
            np.savetxt(f, body, fmt="%d")
        else:
            np.savetxt(
                f,
                np.stack([src + 1, dst + 1, vals], axis=1),
                fmt=("%d", "%d", "%.7g"),
            )


def edgelist_to_mtx(edge_path: str, out_path: str | None = None) -> str:
    """Convert an edge-list file to ``<edge_path>.mtx`` (or ``out_path``)."""
    g = read_edgelist(edge_path)
    out = out_path or (edge_path + ".mtx")
    write_mtx(g, out)
    return out


def average_degree(path_or_graph) -> float:
    """Average degree (2·|E| / n, as the reference computes it: networkx
    degree sums count every undirected edge at both endpoints, and the
    mirrored CSR's nnz is exactly 2·|E|)."""
    if isinstance(path_or_graph, Graph):
        g = path_or_graph
    else:
        g = load_graph(path_or_graph)
    return g.nnz / float(g.n) if g.n else 0.0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("edgelist2mtx", "avgdeg"):
        print(__doc__)
        return 2
    cmd, *rest = argv
    if cmd == "edgelist2mtx":
        out = edgelist_to_mtx(rest[0], rest[1] if len(rest) > 1 else None)
        print(f"wrote {out}")
    else:
        print(f"Average Degree: {average_degree(rest[0])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
