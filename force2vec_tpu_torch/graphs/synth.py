"""The synthetic power-law graph that ``bench.py`` trains on."""

import numpy as np

from force2vec_tpu_torch.graphs.csr import Graph


def synth_powerlaw_graph(n=131072, avg_deg=16, seed=42):
    """Deterministic preferential-attachment-flavored graph: each vertex
    draws `avg_deg/2` endpoints with probability ∝ (rank+1)^-0.5, then the
    edge set is symmetrized. Gives a heavy-tailed degree distribution like
    the reference's com-* configs.  Same draws as
    ``bench.py::synth_powerlaw_graph``."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    w = (np.arange(n, dtype=np.float64) + 1.0) ** -0.5
    w /= w.sum()
    src = rng.integers(0, n, size=m)
    dst = rng.choice(n, size=m, p=w)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    return Graph.from_coo(rows, cols, None, n=n)
