"""Carry the embedding between the JAX package and this one.

X in relabeled, padded ``[n_pad, D]`` order is the sync trainer's only
state.  Both packages build the same layout from the same graph (pinned by
``tests/test_torch_layout.py``), so an X from one package continues
training in the other exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def embedding_from_jax(x_pad: np.ndarray, device) -> torch.Tensor:
    """A JAX package ``[n_pad, D]`` X (as numpy) → an f32 tensor on device."""
    x = np.asarray(x_pad, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError(f"expected [n_pad, D], got shape {x.shape}")
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def embedding_to_numpy(x: torch.Tensor) -> np.ndarray:
    """A ``[n_pad, D]`` X → numpy on the host, for the JAX package."""
    return x.detach().to("cpu").numpy()
