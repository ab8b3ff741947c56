"""Link prediction evaluation.

Protocol parity with the reference's ``performancescores/runlinkpredict.py``
(makeLinkPredictionData, :51-107; scoring loop, :127-140):

* positives: every edge (u, v) with v > u, featureized as an edge embedding
  of the endpoint rows (default Hadamard product; also l1 / l2 / average);
* negatives: per vertex u, **twice** the number of its positives drawn
  uniformly from non-neighbors (the reference's ``totalns += totalns``
  doubling), capped at (n − deg)/2 for near-complete rows;
* 50/50 train/test split after a shuffle, logistic regression, report
  Accuracy / F1-macro / F1-micro (plus ROC-AUC, which the reference paper
  reports but the script does not).

The dataset is drawn in numpy with the JAX package's draws
(``force2vec_tpu/eval/linkpred.py``), so it is bit for bit the same; the
features are built, and the regression fitted and scored, in torch on the
device (``eval/_fit.py``) where the JAX package calls scikit-learn.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from force2vec_tpu_torch.eval._fit import (accuracy, as_tensor, f1_scores,
                                           logistic_fit, roc_auc)
from force2vec_tpu_torch.graphs.csr import Graph


def _edge_keys(graph: Graph) -> np.ndarray:
    """Sorted composite keys ``u·n + v`` of all edges — build ONCE per
    dataset (the O(nnz) repeat + key array is ~2 GB of temporaries at
    com-Orkut scale, so it must not be rebuilt per rejection round)."""
    n = np.int64(graph.n)
    src = np.repeat(np.arange(graph.n, dtype=np.int64), graph.degrees)
    return src * n + graph.colids.astype(np.int64)


def _is_edge_keys(keys: np.ndarray, n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Vectorized CSR membership test against precomputed ``_edge_keys``:
    one ``searchsorted`` against the composite key ``u·n + v`` (monotone
    because the CSR is sorted by row then column)."""
    q = u.astype(np.int64) * np.int64(n) + v.astype(np.int64)
    pos = np.searchsorted(keys, q)
    pos = np.minimum(pos, len(keys) - 1) if len(keys) else pos
    return (len(keys) > 0) & (keys[pos] == q)


def _is_edge(graph: Graph, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """One-shot membership test (builds the key array; hoist via
    ``_edge_keys`` when calling repeatedly)."""
    return _is_edge_keys(_edge_keys(graph), graph.n, u, v)


def _edge_features(xu, xv, dist: str):
    """Edge features of endpoint rows, numpy arrays or tensors alike (the
    same IEEE operations either way)."""
    if dist == "hadamard":
        return xu * xv
    if dist == "l1":
        return abs(xu - xv)
    if dist == "l2":
        diff = xu - xv
        return diff * diff
    if dist == "average":
        return (xu + xv) / 2.0
    raise ValueError(f"unknown edge feature {dist!r}")


def link_prediction_pairs(graph: Graph, seed: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The dataset's (u, v, label) rows in their final shuffled order: 1
    positive per upper-triangle edge, ~2 negatives per positive
    (runlinkpredict.py:51-107), with the JAX package's draws."""
    rng = np.random.default_rng(seed)
    n = graph.n
    src = np.repeat(np.arange(n), graph.degrees)
    dst = graph.colids
    upper = dst > src
    pu, pv = src[upper], dst[upper]

    # negatives: 2x positives per vertex, rejected against adjacency
    deg = graph.degrees
    pos_per_u = np.bincount(pu, minlength=n)
    want = np.minimum(2 * pos_per_u, np.maximum((n - deg) // 2, 0))
    nu = np.repeat(np.arange(n), want)
    # rejection sampling in rounds: draw, drop hits on adjacency, redraw
    nv = rng.integers(0, n, size=nu.shape[0])
    keys = _edge_keys(graph)  # hoisted: one O(nnz) build for all rounds
    for _ in range(30):
        bad = _is_edge_keys(keys, n, nu, nv) | (nu == nv)
        if not bad.any():
            break
        nv[bad] = rng.integers(0, n, size=int(bad.sum()))

    u = np.concatenate([pu, nu])
    v = np.concatenate([pv.astype(np.int64), nv])
    y = np.concatenate([np.ones(len(pu), np.int64), np.zeros(len(nu), np.int64)])
    order = rng.permutation(len(y))
    return u[order], v[order], y[order]


def make_link_prediction_data(
    graph: Graph,
    emb: np.ndarray,
    dist: str = "hadamard",
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the (features, labels) dataset in numpy, bit for bit the JAX
    package's (the rows are featurized after the shuffle, so no second
    copy of the features is made)."""
    u, v, y = link_prediction_pairs(graph, seed)
    emb = np.asarray(emb)
    return _edge_features(emb[u], emb[v], dist), y


def link_prediction_dataset(
    graph: Graph,
    emb,
    dist: str = "hadamard",
    seed: int = 0,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``make_link_prediction_data``'s (X, y) as tensors on ``device``: the
    (u, v, label) rows are drawn on the host, the features built on the
    device from ``emb`` (an array or a tensor, in its own dtype)."""
    u, v, y = link_prediction_pairs(graph, seed)
    x = as_tensor(emb, device)
    X = _edge_features(x[as_tensor(u, device)], x[as_tensor(v, device)], dist)
    return X, as_tensor(y, device)


def fit_and_score(X: torch.Tensor, y: torch.Tensor,
                  train_frac: float = 0.5) -> Dict[str, float]:
    """Fit the logistic regression on the first ``train_frac`` of the rows
    and score the rest (runlinkpredict.py:127-140): predictions where the
    decision is > 0 (probability > 0.5), AUC of the probabilities."""
    cv = int(len(y) * train_frac)
    coef, intercept = logistic_fit(X[:cv], y[:cv])
    decision = X[cv:].double() @ coef[0] + intercept[0]
    pred = (decision > 0).long()
    f1_macro, f1_micro = f1_scores(y[cv:], pred)
    return {
        "accuracy": accuracy(y[cv:], pred),
        "f1_macro": f1_macro,
        "f1_micro": f1_micro,
        "auc": roc_auc(y[cv:], torch.sigmoid(decision)),
    }


def link_prediction_scores(
    graph: Graph,
    emb,
    dist: str = "hadamard",
    train_frac: float = 0.5,
    seed: int = 0,
    device="cuda",
) -> Dict[str, float]:
    """Logistic-regression link-prediction scores (runlinkpredict.py:127-140):
    ``link_prediction_dataset`` then ``fit_and_score``, on ``device``."""
    X, y = link_prediction_dataset(graph, emb, dist=dist, seed=seed,
                                   device=device)
    return fit_and_score(X, y, train_frac)
