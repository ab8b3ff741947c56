"""Embedding visualization: 2-D scatter colored by community.

Parity with ``performancescores/runvisualization.py`` (drawGraphc,
:101-125): project the embedding to 2-D (PCA by default; the reference's
t-SNE path, :177-182, is available via ``method="tsne"``), scatter one
color per ground-truth community, save as PDF.

PCA runs in torch on the device.  t-SNE and the plot import scikit-learn
and matplotlib inside the functions, as the JAX package does: they are
CPU-side tools on no card path, and need both installed where they run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from force2vec_tpu_torch.eval._fit import as_tensor


def project_2d(emb, method: str = "pca", seed: int = 0,
               device="cuda") -> np.ndarray:
    """[n, 2] projection of ``emb`` as a numpy array.  ``"pca"``: the first
    two principal components, an SVD of the centred embedding in float64
    on ``device`` (signs as the SVD gives them); ``"tsne"``:
    scikit-learn's TSNE on the host (needs scikit-learn)."""
    if emb.shape[1] == 2:
        return np.asarray(emb.cpu() if isinstance(emb, torch.Tensor) else emb)
    if method == "pca":
        x = as_tensor(emb, device, torch.float64)
        u, s, _ = torch.linalg.svd(x - x.mean(dim=0), full_matrices=False)
        return (u[:, :2] * s[:2]).cpu().numpy()
    if method == "tsne":
        from sklearn.manifold import TSNE

        x = emb.cpu().numpy() if isinstance(emb, torch.Tensor) else emb
        return TSNE(n_components=2, random_state=seed).fit_transform(x)
    raise ValueError(f"unknown projection {method!r}")


def draw_communities(
    emb,
    labels: Optional[np.ndarray],
    out_path: str,
    method: str = "pca",
    seed: int = 0,
    device="cuda",
) -> None:
    """Scatter the (projected) embedding, one color per community, → PDF/PNG
    (drawGraphc, runvisualization.py:101-125).  Needs matplotlib, which
    is imported here, on the host."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xy = project_2d(emb, method=method, seed=seed, device=device)
    fig, ax = plt.subplots(figsize=(6, 6))
    if labels is None:
        ax.scatter(xy[:, 0], xy[:, 1], s=3, alpha=0.6)
    else:
        labels = np.asarray(labels)
        for c in np.unique(labels):
            sel = labels == c
            ax.scatter(xy[sel, 0], xy[sel, 1], s=3, alpha=0.7, label=str(c))
        if len(np.unique(labels)) <= 12:
            ax.legend(markerscale=3, fontsize=7)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
