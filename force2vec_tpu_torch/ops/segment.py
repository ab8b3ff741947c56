"""Sum per-edge forces into their batch rows, in a fixed order.

The port of ``force2vec_tpu/ops/segment.py``.  The reference accumulates
each edge's force into its source row of a batch-local buffer
(``prevCoordinates[bindex-baseindex+d] += …``, sample/algorithms.cpp:
603-612).  The JAX package sums by a one-hot matmul on the MXU because a
TPU scatter is slow; that workaround is not copied.

A batch's CSR edges are sorted by source row, so row r owns the contiguous
run of ``lengths[r]`` edges after those of rows < r.  The sum is
``torch.segment_reduce`` over those runs: one thread per (row, column)
adds its run in edge order, so the result is the same bits on every run.
``index_add_`` would add with float atomics on the card, in an order that
changes from run to run, and the batch trainer is deterministic given a
seed.  ``unsafe=True`` skips the operator's checks that the lengths are
non-negative and sum to the edge count: they would read the lengths back
to the host once per batch.  The caller builds them from the CSR row
pointers, which guarantees both.

The sync and vertex schedules' hub rows are summed the same way.  A hub
vertex's CSR row is cut into virtual rows of a fixed width, whose partial
sums the edge kernel writes past the update's rows; an owner's virtual
rows are consecutive (``graphs/csr.py``, ``graphs/partition.py``), so its
partials are one run, and ``hub_owner_sum`` stores each run's sum, in
row order, into the owner's row (the JAX package's
``jax.ops.segment_sum``).  The runs' offsets are static, built once with
the layout (``owner_offsets``), so the sum is one ``segment_reduce``
launch and a copy (none where the sync trainer's fused launch reads the
sums themselves, ``owner_sums``): given lengths, the operator would make
the offsets anew at every call (a fill, a scan and a concatenation).
"""

from __future__ import annotations

import numpy as np
import torch

SEGMENT_MODES = ("matmul", "scatter")


def segment_sum_into_batch(forces: torch.Tensor, lengths: torch.Tensor,
                           mode: str = "matmul") -> torch.Tensor:
    """``[B, D]``: row r is the sum of ``forces``' rows
    ``[Σ_{q<r} lengths[q], Σ_{q≤r} lengths[q])`` in order, 0 where
    ``lengths[r]`` is 0.

    forces ``[E, D]``; lengths ``[B]`` int64, non-negative, summing to E.
    ``mode`` is the JAX package's ``segment_mode``: both of its values name
    the same sum here."""
    if mode not in SEGMENT_MODES:
        raise ValueError(f"unknown segment mode {mode!r}")
    return torch.segment_reduce(forces, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def owner_offsets(owners: np.ndarray, deg: np.ndarray,
                  n_owners: int) -> np.ndarray:
    """``[n_owners + 1]`` int64: where each owner offset's run of a hub's
    virtual rows starts (``owners``: offsets from the first owner row),
    then the end of the last, which is the count of real virtual rows
    (``deg > 0``).  They come first; the alignment padding rows past them
    have no edge and are left out of the sum.  Raises ``ValueError`` unless each
    owner's real virtual rows form one run, in owner order."""
    real = int(np.count_nonzero(deg > 0))
    own = np.asarray(owners[:real], dtype=np.int64)
    if (np.any(deg[real:] > 0) or np.any(np.diff(own) < 0)
            or (real and (own[0] < 0 or own[-1] >= n_owners))):
        raise ValueError("a hub owner's virtual rows must be one run, in "
                         "owner order, before the padding rows")
    return np.concatenate([[0], np.cumsum(np.bincount(
        own, minlength=n_owners))]).astype(np.int64)


def owner_sums(src: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``[R, D]`` f32: row r the sum of ``src``'s rows ``[offsets[r],
    offsets[r + 1])``, added in row order, 0 where the run is empty.

    src ``[offsets[R], D]``; offsets ``[R + 1]`` int64 on the device, from
    0, non-decreasing (``owner_offsets``: not checked, which would read
    them back).  The sum is taken in f32 (a bf16 or f16 ``src`` widened)."""
    if src.dtype != torch.float32:
        src = src.float()
    return torch.segment_reduce(src, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def hub_owner_sum(dst: torch.Tensor, src: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """``owner_sums(src, offsets)`` stored into ``dst`` ``[R, D]`` in place,
    rounded once into its dtype (a bf16 or f16 X); each owner row's earlier
    value is replaced, so the caller's owner rows need not be 0.  Returns
    ``dst``."""
    return dst.copy_(owner_sums(src, offsets))
