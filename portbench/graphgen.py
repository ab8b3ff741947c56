"""A public graph's shape, generated from a seed.

The public graphs cannot be fetched where the benchmark runs, so each
configuration names its graph's published vertex and undirected edge
counts and the generator draws a graph of exactly that size: a power-law
degree tail (edge ends drawn with weight ``(i + 1) ** -skew``) under
planted communities (``community_share`` of the edges close inside a
community; community sizes Zipf with ``community_skew`` over one
community per ``community_per_vertices`` vertices), the structure of
``benchmarks/bigrun.py::synth_big``.  Vertex ids are scrambled, so an id
says nothing of a vertex's degree or community, as in the published files.

Every draw is an inverse-CDF lookup (``searchsorted`` on uniform draws),
and draws repeat in rounds until the distinct undirected edges, self-loops
left out, reach the published count; the last round's surplus is dropped
at random.  The same seed gives the same graph.  ``csr`` lays the edges
out for the reference; the program gets the same edges as a loaded graph
file gives them (``Graph.from_coo``).
"""

from __future__ import annotations

import numpy as np


def _inverse_cdf(rng: np.random.Generator, weights: np.ndarray,
                 size: int) -> np.ndarray:
    """``size`` indices drawn with probability ∝ ``weights``."""
    cdf = np.cumsum(weights)
    idx = np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")
    return np.minimum(idx, len(weights) - 1)


def edges(shape: dict, seed: int) -> tuple:
    """``(src, dst)`` int64 arrays of ``shape["edges"]`` distinct undirected
    edges over ``shape["vertices"]`` vertices, no self-loop, ``src < dst``.

    ``shape``: ``vertices``, ``edges``, ``skew``, ``community_share``,
    ``community_per_vertices``, ``community_skew`` (a configuration's
    ``graph`` entry)."""
    n, m = int(shape["vertices"]), int(shape["edges"])
    if m > n * (n - 1) // 2:
        raise ValueError(f"{m} edges do not fit {n} vertices")
    rng = np.random.default_rng(seed % 2**64)
    hub_w = (np.arange(n, dtype=np.float64) + 1.0) ** -float(shape["skew"])
    n_comm = max(n // int(shape["community_per_vertices"]), 1)
    comm_w = ((np.arange(n_comm, dtype=np.float64) + 1.0)
              ** -float(shape["community_skew"]))
    # each structured id's community, as contiguous id ranges
    comm_of = np.sort(_inverse_cdf(rng, comm_w, n))
    starts = np.searchsorted(comm_of, np.arange(n_comm))
    span = np.maximum(np.searchsorted(comm_of, np.arange(n_comm),
                                      side="right") - starts, 1)
    scramble = rng.permutation(n).astype(np.int64)
    share = float(shape["community_share"])

    keys = np.zeros(0, dtype=np.int64)
    while keys.size < m:
        k = int((m - keys.size) * 1.1) + 1024
        k_in = int(k * share)
        src = rng.integers(0, n, size=k, dtype=np.int64)
        c = comm_of[src[:k_in]]
        dst = np.concatenate([
            starts[c] + rng.integers(0, 1 << 62, size=k_in) % span[c],
            _inverse_cdf(rng, hub_w, k - k_in)])
        src, dst = scramble[src], scramble[dst]
        keep = src != dst
        lo = np.minimum(src, dst)[keep]
        hi = np.maximum(src, dst)[keep]
        keys = np.union1d(keys, lo * n + hi)
    if keys.size > m:
        keys = np.sort(rng.choice(keys, size=m, replace=False))
    return keys // n, keys % n


def csr(src: np.ndarray, dst: np.ndarray, n: int) -> tuple:
    """``(rowptr, colids)`` int64: the symmetric CSR of the undirected
    edges ``(src, dst)`` over ``n`` vertices, each edge both ways, every
    row's columns ascending.  The reference reads this, and not the
    program's graph, so that a fault in the program's graph building
    shows."""
    rows = np.concatenate([src, dst]).astype(np.int64)
    keys = np.sort(rows * n + np.concatenate([dst, src]))
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=rowptr[1:])
    return rowptr, keys % n
