"""Carry the embedding between the JAX package and this one.

X in relabeled, padded ``[n_pad, dim]`` order is the sync trainer's only
state.  Both packages build the same layout from the same graph (pinned by
``tests/test_torch_layout.py``), so an X from one package continues
training in the other exactly.  This package holds X at ``row_width =
padded_dim(dim)`` columns (the kernels' row alignment, the padding columns
0); the JAX package at ``dim``: the two functions add and drop the
padding.  A bf16 X crosses as the JAX package holds it, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from force2vec_tpu_torch.ops.force_kernels import padded_dim


def is_bf16_words(a: np.ndarray) -> bool:
    """True for a bf16 array as the JAX package hands it: ml_dtypes'
    ``bfloat16`` or the raw 2-byte ``|V2`` words ``np.load`` returns for
    one.  (Read through ``np.uint16``: this package does not import
    ml_dtypes.)"""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def bf16_words_to_f32(a: np.ndarray) -> np.ndarray:
    """The f32 values of bf16 words (``is_bf16_words``): an exact
    widening, each word the top half of its f32."""
    return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
            << 16).view(np.float32)


def bf16_words_to_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU ``torch.bfloat16`` tensor of bf16 words, bit for bit."""
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)


def tensor_to_bf16_words(t: torch.Tensor) -> np.ndarray:
    """The ``|V2`` words of a bf16 tensor, as the JAX package's
    ``save_checkpoint`` writes a bf16 X."""
    return t.detach().to("cpu").contiguous().view(torch.int16).numpy().view(
        np.dtype("V2"))


def embedding_from_jax(x_pad: np.ndarray, device) -> torch.Tensor:
    """A JAX package ``[n_pad, dim]`` X (as numpy) → the ``[n_pad,
    padded_dim(dim)]`` X this package's trainers hold, on device, in the
    same dtype bit for bit: bf16 for a bf16 X (``is_bf16_words``), else
    f32."""
    x = np.asarray(x_pad)
    if x.ndim != 2:
        raise ValueError(f"expected [n_pad, dim], got shape {x.shape}")
    t = (bf16_words_to_tensor(x) if is_bf16_words(x)
         else torch.from_numpy(np.asarray(x, dtype=np.float32)))
    out = torch.zeros((x.shape[0], padded_dim(x.shape[1])), dtype=t.dtype)
    out[:, : x.shape[1]] = t
    return out.to(device)


def embedding_to_numpy(x: torch.Tensor, dim: int) -> np.ndarray:
    """A ``[n_pad, padded_dim(dim)]`` X → the JAX package's ``[n_pad,
    dim]``, numpy on the host: f32, a bf16 X widened exactly."""
    if x.ndim != 2 or x.shape[1] != padded_dim(dim):
        raise ValueError(f"expected [n_pad, {padded_dim(dim)}] for dim {dim}, "
                         f"got shape {tuple(x.shape)}")
    x = x[:, :dim].detach().to("cpu")
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
