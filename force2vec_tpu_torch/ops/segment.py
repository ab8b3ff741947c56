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

``add_rows`` adds rows into rows by an index (the sync and vertex
schedules' hub partial sums into their owner rows): ``index_add_``, with
a bf16 destination's sums taken in f32 and rounded once.
"""

from __future__ import annotations

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


def add_rows(dst: torch.Tensor, index: torch.Tensor,
             src: torch.Tensor) -> torch.Tensor:
    """``dst.index_add_(0, index, src)``, in place; returns ``dst``.  A
    bf16 ``dst`` (X held in bf16) gets each row's sum taken in f32 and
    rounded once: bf16 atomics would round at every add, in an order that
    changes from run to run, and a hub owner sums tens of partial rows."""
    if dst.dtype == torch.float32:
        return dst.index_add_(0, index, src)
    return dst.copy_(dst.float().index_add_(0, index, src.float()))
