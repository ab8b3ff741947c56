"""What one iteration of a cell has to do, counted from its configuration's
sizes, and the chip's peaks.

The counts belong to the work and not to the kernels that do it, so that a
kernel fused, split or renamed leaves them as they are:

* updates: every edge force and every negative's force, ``nnz + n·ns``
  (``bench.py:158-161``'s count);
* least bytes: X read once and written once in its element type (the
  traffic's ``x_dtype``, float32 where it names none), the graph's column
  ids and row offsets once and the iteration's negative ids once, all as
  int32; padding rows, gather replicas and re-reads are the
  implementation's and are not counted;
* operations: an edge's force and a negative's as the model's reference
  counts them (``reference/models/<model>.py``: ``edge_ops``,
  ``sample_ops``; a model with no file there is refused), X's update
  ``dim`` a row.

The least time of an iteration is the larger of the bytes at the memory's
peak and the operations at float32's (no tensor core computes these
forces).
"""

from __future__ import annotations

from portbench.reference import force2vec

# Published peaks (NVIDIA's data sheet, SXM part, dense; at a 700 W power
# limit), keyed by torch.cuda.get_device_name(); a card not listed has no
# roofline.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flops": 67e12,
                              "memory_bytes": 80e9},
}

_ID = 4  # bytes of a vertex id or row offset (int32)
# bytes of an element of X, by its type
X_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def updates_per_iter(n: int, nnz: int, ns: int) -> int:
    return nnz + n * ns


def negatives_per_iter(n: int, ns: int, batch: int, per_vertex: bool) -> int:
    """Negative ids an iteration draws: a set of ``ns`` for every row, or
    one for every ``batch`` rows."""
    return n * ns if per_vertex else -(-n // batch) * ns


def bytes_per_iter(n: int, nnz: int, dim: int, ns: int, batch: int,
                   per_vertex: bool, x_dtype: str = "float32") -> int:
    return (2 * n * dim * X_BYTES[x_dtype] + (nnz + n + 1) * _ID
            + negatives_per_iter(n, ns, batch, per_vertex) * _ID)


def flops_per_iter(model: str, n: int, nnz: int, dim: int, ns: int) -> int:
    m = force2vec.model(model)
    return nnz * m.edge_ops(dim) + n * ns * m.sample_ops(dim) + n * dim


def least_seconds_per_iter(model: str, n: int, nnz: int, dim: int, ns: int,
                           batch: int, per_vertex: bool, x_dtype: str,
                           peak: dict) -> float:
    """The iteration at the chip's peak: bytes or operations, whichever
    binds."""
    return max(
        bytes_per_iter(n, nnz, dim, ns, batch, per_vertex, x_dtype)
        / peak["bytes_per_s"],
        flops_per_iter(model, n, nnz, dim, ns) / peak["f32_flops"])
