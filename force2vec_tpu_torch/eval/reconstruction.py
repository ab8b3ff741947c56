"""Graph reconstruction accuracy.

Parity with ``performancescores/runnodeclassclust.py::graphReconstruction``
(:194-219, shipped disabled): sample V vertices; for each, rank all other
vertices by cosine similarity of embeddings and count how many of the top
``deg(i)`` ranks are true neighbors.  The same picks as the JAX package
(``rng.choice``), with the per-pick loop of ``force2vec_tpu/eval/
reconstruction.py:30-41`` batched over the picks: one matmul and one
``topk`` per chunk of picks on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from force2vec_tpu_torch.eval._fit import as_tensor
from force2vec_tpu_torch.eval.linkpred import _edge_keys
from force2vec_tpu_torch.graphs.csr import Graph

# similarity elements ([picks, n]) formed at once
_CHUNK_ELEMS = 1 << 27


def graph_reconstruction_accuracy(
    graph: Graph,
    emb,
    num_vertices: int = 1000,
    seed: int = 0,
    device="cuda",
) -> float:
    rng = np.random.default_rng(seed)
    n = graph.n
    picks = rng.choice(n, size=min(num_vertices, n), replace=False)
    deg = graph.degrees[picks]
    picks, deg = picks[deg > 0], deg[deg > 0]
    total = int(deg.sum())
    if not total:
        return 0.0
    x = as_tensor(emb, device, torch.float32)
    xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
    keys = as_tensor(_edge_keys(graph), device)
    p_all = as_tensor(picks, device)
    d_all = as_tensor(deg, device)
    rows = max(1, _CHUNK_ELEMS // n)
    correct = 0
    for i in range(0, len(picks), rows):
        p, d = p_all[i:i + rows], d_all[i:i + rows]
        sims = xn[p] @ xn.T  # [rows, n]
        sims[torch.arange(len(p), device=sims.device), p] = -torch.inf
        top = torch.topk(sims, min(int(deg[i:i + rows].max()), n),
                         dim=1).indices
        q = p[:, None] * n + top
        pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
        hit = (keys[pos] == q) & (torch.arange(top.shape[1], device=q.device)
                                  < d[:, None])
        correct += int(hit.sum())
    return correct / total
