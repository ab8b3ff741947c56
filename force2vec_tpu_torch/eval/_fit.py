"""The torch pieces the evaluation scores share: an L2-penalised logistic
regression fitted by Newton's method, and the metrics scikit-learn's
``accuracy_score``, ``f1_score`` and ``roc_auc_score`` compute.

Plain functions on tensors, on whatever device the tensors are on.  The
JAX package fits and scores with scikit-learn, which the card's host does
not have; ``tests/test_torch_eval.py`` holds these to scikit-learn.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# elements of the [K, rows, d] Hessian product formed at once (f64)
_HESS_ELEMS = 1 << 26
# Newton stops once every problem's decrement is at most this share of
# its objective; MAX_NEWTON bounds the steps (6–10 on the tests' data)
NEWTON_TOL = 1e-12
MAX_NEWTON = 50


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (an array or a tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _objective(Xa, Y, W, reg):
    """Σ_rows logloss + ½ Σ reg·w² per problem: [K]."""
    z = Xa @ W.T  # [n, K]
    # log(1 + e^z) - y·z, exact in f64 for every z
    loss = z.clamp(min=0) + torch.log1p(torch.exp(-z.abs())) - Y * z
    return loss.sum(dim=0) + 0.5 * (reg * W * W).sum(dim=1)


def logistic_fit(X, Y, C: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2-penalised logistic regression with an unpenalised intercept, for
    K binary problems on the same rows at once (one-vs-rest is one solve).

    Minimises ``Σ_i logloss(y_ik, x_i·w_k + b_k) + ‖w_k‖²/(2C)`` for each
    k, the objective of scikit-learn's ``LogisticRegression(C=C)``, by
    Newton's method with a backtracking line search in float64 on X's
    device.  Stops when every problem's Newton decrement ½·gᵀH⁻¹g is at
    most ``NEWTON_TOL`` times its objective (quadratic convergence: the
    next step would change the objective by less than that).

    X: [n, d]; Y: [n] or [n, K] of 0/1.  Returns (coef [K, d], intercept
    [K]) in float64.  A problem whose labels are all 0 (all 1) gets coef 0
    and intercept -inf (+inf), so its probability is exactly 0 (1), as
    scikit-learn's one-vs-rest constant predictor gives it.
    """
    X = X.double()
    Y = Y.double().reshape(Y.shape[0], -1)
    n, d = X.shape
    K = Y.shape[1]
    dev = X.device
    pos = Y.sum(dim=0)
    active = torch.nonzero((pos > 0) & (pos < n)).squeeze(1)
    coef = torch.zeros(K, d, dtype=torch.float64, device=dev)
    intercept = torch.where(pos > 0, torch.inf, -torch.inf).double()
    if active.numel():
        Xa = torch.cat([X, torch.ones(n, 1, dtype=X.dtype, device=dev)], 1)
        W = _newton(Xa, Y[:, active], 1.0 / C)
        coef[active] = W[:, :d]
        intercept[active] = W[:, d]
    return coef, intercept


def _newton(Xa, Y, inv_c):
    n, da = Xa.shape
    K = Y.shape[1]
    dev = Xa.device
    reg = torch.full((da,), inv_c, dtype=torch.float64, device=dev)
    reg[-1] = 0.0  # the intercept is not penalised
    W = torch.zeros(K, da, dtype=torch.float64, device=dev)
    f = _objective(Xa, Y, W, reg)
    rows = max(1, _HESS_ELEMS // (K * da))
    for _ in range(MAX_NEWTON):
        P = torch.sigmoid(Xa @ W.T)  # [n, K]
        G = (P - Y).T @ Xa + reg * W  # [K, da]
        S = P * (1.0 - P)
        H = torch.diag_embed(reg.expand(K, da)).clone()
        for i in range(0, n, rows):
            xa = Xa[i:i + rows]
            H += (S[i:i + rows].T[:, :, None] * xa[None]).transpose(1, 2) @ xa
        step = torch.linalg.solve(H, G)  # [K, da]
        dec = (G * step).sum(dim=1)  # gᵀH⁻¹g ≥ 0
        if bool((0.5 * dec <= NEWTON_TOL * f.abs()).all()):
            break
        # Armijo backtracking, per problem
        t = torch.ones(K, dtype=torch.float64, device=dev)
        todo = torch.ones(K, dtype=torch.bool, device=dev)
        W_new, f_new = W, f
        for _ in range(40):
            trial = W - t[:, None] * step
            f_trial = _objective(Xa, Y, trial, reg)
            ok = todo & (f_trial <= f - 1e-4 * t * dec)
            W_new = torch.where(ok[:, None], trial, W_new)
            f_new = torch.where(ok, f_trial, f_new)
            todo &= ~ok
            if not bool(todo.any()):
                break
            t = torch.where(todo, 0.5 * t, t)
        W, f = W_new, f_new
    return W


# -- metrics ------------------------------------------------------------------


def accuracy(y_true: torch.Tensor, y_pred: torch.Tensor) -> float:
    """``accuracy_score``: the share of equal labels."""
    return float((y_true == y_pred).double().mean())


def _f1(tp, fp, fn) -> torch.Tensor:
    """2tp / (2tp + fp + fn), 0 where that is 0/0 (``zero_division=0``)."""
    num = 2.0 * tp.double()
    den = num + fp.double() + fn.double()
    return torch.where(den > 0, num / den.clamp(min=1), 0.0)


def f1_scores(y_true: torch.Tensor, y_pred: torch.Tensor) -> Tuple[float, float]:
    """(macro, micro) ``f1_score`` of single-label predictions, over the
    labels present in either (scikit-learn's ``unique_labels``)."""
    labels = torch.unique(torch.cat([y_true, y_pred]))
    t = y_true[None, :] == labels[:, None]
    p = y_pred[None, :] == labels[:, None]
    tp, fp, fn = (t & p).sum(1), (~t & p).sum(1), (t & ~p).sum(1)
    return (float(_f1(tp, fp, fn).mean()),
            float(_f1(tp.sum(), fp.sum(), fn.sum())))


def multilabel_f1_scores(Y_true: torch.Tensor,
                         Y_pred: torch.Tensor) -> Tuple[float, float]:
    """(macro, micro) ``f1_score(..., zero_division=0)`` of [n, K] 0/1
    indicator matrices, the macro mean over all K columns."""
    t, p = Y_true.bool(), Y_pred.bool()
    tp, fp, fn = (t & p).sum(0), (~t & p).sum(0), (t & ~p).sum(0)
    return (float(_f1(tp, fp, fn).mean()),
            float(_f1(tp.sum(), fp.sum(), fn.sum())))


def roc_auc(y_true: torch.Tensor, score: torch.Tensor) -> float:
    """``roc_auc_score`` of 0/1 labels, by the Mann–Whitney statistic with
    tied scores given their average rank (which is how the ROC curve's
    trapezoids count ties)."""
    s, order = torch.sort(score.double())
    _, inv, counts = torch.unique_consecutive(s, return_inverse=True,
                                              return_counts=True)
    end = torch.cumsum(counts, 0).double()  # 1-based last rank of each tie
    rank = (end - (counts.double() - 1.0) / 2.0)[inv]
    pos = y_true[order] == 1
    n_pos = int(pos.sum())
    n_neg = pos.numel() - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC AUC needs both classes in y_true")
    u = float(rank[pos].sum()) - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg)
