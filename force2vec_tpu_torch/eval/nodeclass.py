"""Multilabel node classification, DeepWalk-style top-k protocol.

Parity with ``performancescores/runnodeclassclust.py``: labels file has
``node(1-based) label`` lines, possibly several per node
(makeNodeClassificationData, :173-190); training fractions
{5,10,15,20,25}% (:289); a one-vs-rest logistic regression predicts, for
each test node with k true labels, its top-k classes by probability
(MyClass.prediction, :162-171); F1 is computed on the multilabel
binarization (:304-309).  The one-vs-rest fit is one batched Newton solve
on the device (``eval/_fit.py``) where the JAX package calls scikit-learn.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from force2vec_tpu_torch.eval._fit import (as_tensor, logistic_fit,
                                           multilabel_f1_scores)


def read_node_labels(path: str, n: int) -> List[List[int]]:
    """Per-node label lists from a ``node label`` text file (1-based)."""
    labels: List[List[int]] = [[] for _ in range(n)]
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            node = int(toks[0]) - 1
            if 0 <= node < n:
                labels[node].append(int(toks[1]))
    return labels


def _topk_indicator(prob: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """[rows, K] 0/1: each row's ``ks[row]`` most probable classes
    (``nodeclass.py::_topk_predict`` of the JAX package, binarized)."""
    order = torch.argsort(prob, dim=1, descending=True, stable=True)
    take = (torch.arange(prob.shape[1], device=prob.device)[None, :]
            < ks.clamp(min=1)[:, None])
    return torch.zeros_like(order).scatter_(1, order, take.long())


def node_classification_scores(
    emb,
    labels: List[List[int]],
    train_fracs: Sequence[float] = (0.05, 0.10, 0.15, 0.20, 0.25),
    seed: int = 0,
    device="cuda",
) -> Dict[float, Dict[str, float]]:
    """F1 micro/macro per training fraction (runnodeclassclust.py:289-309),
    with the JAX package's permutation per fraction.  A class with no
    positive (or no negative) among the training rows gets probability 0
    (1), as scikit-learn's constant predictor gives it."""
    keep = [i for i, ls in enumerate(labels) if ls]
    classes = sorted({c for i in keep for c in labels[i]})
    col = {c: j for j, c in enumerate(classes)}
    Yb = np.zeros((len(keep), len(classes)), np.int64)
    for r, i in enumerate(keep):
        Yb[r, [col[c] for c in labels[i]]] = 1
    X = as_tensor(emb, device)[as_tensor(np.asarray(keep, np.int64), device)]
    Y = as_tensor(Yb, device)
    # k per node counts its label lines, as len(labels[i]) does
    ks = as_tensor(np.asarray([len(labels[i]) for i in keep], np.int64),
                   device)
    rng = np.random.default_rng(seed)

    results: Dict[float, Dict[str, float]] = {}
    for tf in train_fracs:
        order = rng.permutation(len(keep))
        cv = max(int(len(keep) * tf), 1)
        tr = as_tensor(order[:cv], device)
        te = as_tensor(order[cv:], device)
        coef, intercept = logistic_fit(X[tr], Y[tr])
        prob = torch.sigmoid(X[te].double() @ coef.T + intercept)
        f1_macro, f1_micro = multilabel_f1_scores(
            Y[te], _topk_indicator(prob, ks[te]))
        results[tf] = {"f1_macro": f1_macro, "f1_micro": f1_micro}
    return results
