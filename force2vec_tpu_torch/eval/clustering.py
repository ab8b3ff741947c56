"""Clustering quality: KMeans sweep scored by graph modularity, plus the
silhouette / Davies-Bouldin indices.

Parity with ``performancescores/runnodeclassclust.py:311-331`` (KMeans
k ∈ [2, 50), partition scored by modularity of the graph under the cluster
assignment — the reference calls python-louvain's ``modularity``; here
Newman modularity is computed directly and vectorized) and with
``runvisualization.py:185-188`` (silhouette, Davies-Bouldin against
ground-truth communities).  KMeans and both indices run in torch on the
device (float64), where the JAX package calls scikit-learn.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from force2vec_tpu_torch.eval._fit import as_tensor
from force2vec_tpu_torch.graphs.csr import Graph

# distance elements ([rows, n]) formed at once by the silhouette
_CHUNK_ELEMS = 1 << 25
# scikit-learn's KMeans defaults as the JAX package calls it: 3 seedings,
# Lloyd until the labels settle or the centers move by at most 1e-4 of
# the mean per-column variance, at most 300 iterations
N_INIT = 3
LLOYD_TOL = 1e-4
LLOYD_MAX_ITER = 300


def modularity(graph: Graph, assignment: np.ndarray) -> float:
    """Newman modularity Q = Σ_c (e_c/m − (d_c/2m)²) of a partition.

    ``e_c`` counts intra-community edge endpoints over 2m (directed-pair
    count of the symmetric CSR), ``d_c`` sums community degrees — the same
    quantity python-louvain computes for the reference.
    """
    assignment = np.asarray(assignment)
    src = np.repeat(np.arange(graph.n), graph.degrees)
    dst = graph.colids
    m2 = graph.nnz  # = 2m for symmetric CSR
    if m2 == 0:
        return 0.0
    same = assignment[src] == assignment[dst]
    e_in = np.bincount(assignment[src][same], minlength=assignment.max() + 1) / m2
    d_c = np.bincount(assignment, weights=graph.degrees.astype(np.float64))
    return float(np.sum(e_in) - np.sum((d_c / m2) ** 2))


def _sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[n, k] squared distances, ‖x‖² − 2x·c + ‖c‖², clamped at 0."""
    d2 = ((x * x).sum(1, keepdim=True) - 2.0 * x @ centers.T
          + (centers * centers).sum(1)[None, :])
    return d2.clamp(min=0.0)


def _kmeans_plusplus(x: torch.Tensor, k: int,
                     gen: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ seeding (scikit-learn's ``_kmeans_plusplus``): the
    first center uniform, each next one the best of 2 + ⌊ln k⌋ candidates
    drawn ∝ squared distance to the nearest center."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    centers = [x[first[0]]]
    closest = _sq_dist(x, x[first])[:, 0]
    for _ in range(1, k):
        pot = closest.sum()
        r = torch.rand(trials, generator=gen, device=x.device,
                       dtype=torch.float64) * pot
        cand = torch.searchsorted(torch.cumsum(closest, 0), r).clamp(max=n - 1)
        d = torch.minimum(closest[None, :], _sq_dist(x, x[cand]).T)
        best = torch.argmin(d.sum(1))
        centers.append(x[cand[best]])
        closest = d[best]
    return torch.stack(centers)


def _lloyd(x: torch.Tensor, centers: torch.Tensor,
           tol: float) -> Tuple[torch.Tensor, float]:
    """Lloyd iterations until the labels stop changing or the centers move
    by at most ``tol`` (sum of squared shifts); an empty cluster takes the
    point farthest from its center.  Returns (labels, inertia)."""
    k = centers.shape[0]
    labels = None
    for _ in range(LLOYD_MAX_ITER):
        d2 = _sq_dist(x, centers)
        new_labels = torch.argmin(d2, dim=1)
        counts = torch.bincount(new_labels, minlength=k)
        sums = torch.zeros_like(centers).index_add_(0, new_labels, x)
        new_centers = sums / counts.clamp(min=1)[:, None]
        if bool((counts == 0).any()):
            far = torch.argsort(d2.min(dim=1).values, descending=True)
            for j, c in enumerate(torch.nonzero(counts == 0).squeeze(1)):
                new_centers[c] = x[far[j]]
        shift = float(((new_centers - centers) ** 2).sum())
        centers = new_centers
        if labels is not None and torch.equal(labels, new_labels):
            break
        labels = new_labels
        if shift <= tol:
            break
    d2 = _sq_dist(x, centers)
    best = d2.min(dim=1)
    return best.indices, float(best.values.sum())


def kmeans(x: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """KMeans labels of the rows of ``x``: ``N_INIT`` k-means++ seedings
    from ``gen``, each refined by Lloyd iterations, the lowest inertia
    kept."""
    tol = float(x.var(dim=0, unbiased=False).mean()) * LLOYD_TOL
    best_labels, best_inertia = None, float("inf")
    for _ in range(N_INIT):
        labels, inertia = _lloyd(x, _kmeans_plusplus(x, k, gen), tol)
        if inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels


def _encode(labels, device) -> Tuple[torch.Tensor, int]:
    lab = as_tensor(np.unique(np.asarray(labels), return_inverse=True)[1]
                    .reshape(-1), device)
    return lab, int(lab.max()) + 1


def silhouette_score(x: torch.Tensor, labels) -> float:
    """Mean silhouette coefficient (Euclidean), over row chunks: s = (b −
    a) / max(a, b), 0 for a point alone in its cluster."""
    lab, k = _encode(labels, x.device)
    n = x.shape[0]
    if not 2 <= k <= n - 1:
        raise ValueError(f"silhouette needs 2 <= labels <= n - 1, got {k}")
    counts = torch.bincount(lab, minlength=k).double()
    onehot = torch.nn.functional.one_hot(lab, k).double()
    total = 0.0
    rows = max(1, _CHUNK_ELEMS // n)
    for i in range(0, n, rows):
        d = torch.cdist(x[i:i + rows], x,
                        compute_mode="donot_use_mm_for_euclid_dist")
        sums = d @ onehot  # [rows, k] distance sums to each cluster
        own = lab[i:i + rows]
        a = sums.gather(1, own[:, None])[:, 0] / (counts[own] - 1)
        mean_other = (sums / counts).scatter(1, own[:, None], torch.inf)
        b = mean_other.min(dim=1).values
        # a point alone in its cluster gives 0/0 here, which counts as 0
        total += float(torch.nan_to_num((b - a) / torch.maximum(a, b)).sum())
    return total / n


def davies_bouldin_score(x: torch.Tensor, labels) -> float:
    """Davies–Bouldin index: mean over clusters of the largest (S_i + S_j)
    / ‖c_i − c_j‖, S the mean distance to the centroid."""
    lab, k = _encode(labels, x.device)
    counts = torch.bincount(lab, minlength=k).double()
    centroids = (torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
                 .index_add_(0, lab, x) / counts[:, None])
    dist = torch.linalg.vector_norm(x - centroids[lab], dim=1)
    intra = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
        0, lab, dist) / counts
    cdist = torch.cdist(centroids, centroids,
                        compute_mode="donot_use_mm_for_euclid_dist")
    if bool((intra.abs() <= 1e-8).all()) or bool((cdist.abs() <= 1e-8).all()):
        return 0.0
    cdist = torch.where(cdist == 0, torch.inf, cdist)
    return float(((intra[:, None] + intra[None, :]) / cdist)
                 .max(dim=1).values.mean())


def clustering_scores(
    graph: Graph,
    emb,
    k_range=range(2, 50),
    labels: Optional[np.ndarray] = None,
    seed: int = 0,
    device="cuda",
) -> Dict[str, float]:
    """KMeans sweep → best modularity (runnodeclassclust.py:311-331); if
    ground-truth ``labels`` given, also silhouette/DB of the embedding
    under them (runvisualization.py:185-188).  KMeans draws from one
    ``torch.Generator`` seeded with ``seed``."""
    x = as_tensor(emb, device, torch.float64)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    best_q, best_k = -1.0, 0
    for k in k_range:
        if k >= graph.n:
            break
        q = modularity(graph, kmeans(x, k, gen).cpu().numpy())
        if q > best_q:
            best_q, best_k = q, k
    out = {"best_modularity": best_q, "best_k": float(best_k)}

    if labels is not None:
        out["silhouette"] = silhouette_score(x, labels)
        out["davies_bouldin"] = davies_bouldin_score(x, labels)
    return out
