"""CSR graph container and the sync schedule's degree-sorted ELL layout.

A numpy copy of the host code in ``force2vec_tpu/graphs/csr.py``: that
package's ``__init__`` imports JAX, which the GPU host does not have, so
the port carries its own copy and ``tests/test_torch_layout.py`` pins its
arrays equal to the JAX package's.

``Graph`` has all of the JAX ``Graph``'s methods.  Left out on purpose: the
hot/cold gather split (``hot_rows > 0``), whose
only justification was a TPU gather-tier measurement, and the batch
trainer's ``DeviceGraph``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Host-side CSR adjacency: ``rowptr``/``colids``/optional ``values``
    over ``n`` vertices, column ids sorted within each row (the reference's
    ``CSR<IT,NT>``, sample/CSR.h:89-96)."""

    n: int
    rowptr: np.ndarray  # [n+1] int64
    colids: np.ndarray  # [nnz] int32
    values: Optional[np.ndarray] = None  # [nnz] float32 (unused by training)

    @property
    def nnz(self) -> int:
        return int(self.colids.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.rowptr)

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: Optional[np.ndarray],
        n: int,
        sum_duplicates: bool = False,
    ) -> "Graph":
        """Build CSR from COO by sorting (rows then cols ascending).
        Duplicates stay distinct nonzeros unless ``sum_duplicates``, as in
        the reference (sample/CSC.h:147-190)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        if vals is not None:
            vals = np.asarray(vals, dtype=np.float32)[order]
        if sum_duplicates and rows.size:
            keep = np.ones(rows.size, dtype=bool)
            keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            if vals is not None:
                group = np.cumsum(keep) - 1
                vals = np.bincount(group, weights=vals).astype(np.float32)
            rows, cols = rows[keep], cols[keep]
        rowptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(rowptr, rows + 1, 1)
        np.cumsum(rowptr, out=rowptr)
        return Graph(n=n, rowptr=rowptr, colids=cols.astype(np.int32),
                     values=vals)

    def shuffled_ids(self, seed: int = 0) -> "Graph":
        """Per-row shuffle of colids (CSR::shuffleIds,
        sample/CSR.h:430-447): a random sort key within each row, which
        the stable lexsort on rows turns into an independent shuffle."""
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        order = np.lexsort((rng.random(self.nnz), rows))
        values = self.values[order] if self.values is not None else None
        return Graph(self.n, self.rowptr.copy(), self.colids[order], values)

    def induced_subgraph(self, nodes: np.ndarray) -> "Graph":
        """CSR of the subgraph induced by ``nodes`` (relabeled 0..k-1).
        ``np.arange(size)`` gives the first-``size``-vertices subsample of
        the reference's big-graph link prediction
        (performancescores/biglinkprediction.py)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        remap = np.full(self.n, -1, dtype=np.int64)
        remap[nodes] = np.arange(len(nodes))
        src = np.repeat(np.arange(self.n), self.degrees)
        keep = (remap[src] >= 0) & (remap[self.colids] >= 0)
        rows = remap[src[keep]]
        cols = remap[self.colids[keep]]
        vals = self.values[keep] if self.values is not None else None
        return Graph.from_coo(rows, cols, vals, n=len(nodes))

    def is_sorted(self) -> bool:
        """Row-wise sortedness (CSR::Sorted, Test/Force2Vec.cpp:123): a
        decrease in colids is allowed only at a row's first edge."""
        if self.nnz < 2:
            return True
        dec = np.flatnonzero(self.colids[1:].astype(np.int64)
                             < self.colids[:-1].astype(np.int64)) + 1
        if not len(dec):
            return True
        return bool(np.all(np.isin(dec, self.rowptr[1:-1])))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class EllBucket:
    """One degree bucket: ``count`` rows of ELL width ``width`` starting at
    relabeled row ``start``.  For the hub bucket (``owners is not None``)
    the rows are virtual — partial rows of at most ``width`` neighbours
    owned by the real rows ``owners`` — and their partial force sums are
    added into the owner rows."""

    width: int
    start: int  # first relabeled real row (the hub range's start for the hub)
    count: int  # number of (virtual) rows, padded to a multiple of row_align
    nbr: np.ndarray  # [count, width] int32 relabeled neighbour ids (0-padded)
    deg: np.ndarray  # [count] int32 valid neighbours per row
    owners: Optional[np.ndarray] = None  # [count] int32 relabeled owner rows


@dataclasses.dataclass
class SyncLayout:
    """Degree-sorted ELL layout for the epoch-synchronous schedule.

    Vertices are relabeled by ascending degree, so each width bucket is a
    contiguous row range of the relabeled table and the buckets tile
    ``[0, n)`` in order, the hub bucket last.  Rows with degree above
    ``hub_width`` are split into virtual rows (the force is a sum over
    edges, so the split is exact)."""

    n: int
    n_pad: int
    perm: np.ndarray  # [n] original id of relabeled row i
    inv_perm: np.ndarray  # [n] relabeled row of original id
    deg: np.ndarray  # [n_pad] int32 degree per relabeled row (0 for padding)
    buckets: list  # list[EllBucket]
    padded_edges: int  # Σ count·width: ELL slots per iteration

    @staticmethod
    def widths_for(min_width: int, hub_width: int, scheme: str = "pow2"):
        """Bucket width ladder from ``min_width`` up to ``hub_width``:
        ``pow2`` doubles each step, ``mult8``/``mult4`` take quarter-octave
        steps kept to multiples of 8 / 4."""
        step_of = {"pow2": None, "mult8": 8, "mult4": 4}[scheme]
        widths = []
        w = min_width
        while w < hub_width:
            widths.append(w)
            if step_of is None:
                w *= 2
            else:
                w += max(step_of, (w // 4 // step_of) * step_of)
        widths.append(hub_width)
        return widths

    @staticmethod
    def build(
        graph: Graph,
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        widths: Optional[list] = None,
        hot_rows: int = 0,
    ) -> "SyncLayout":
        if hot_rows > 0:
            raise NotImplementedError(
                "the hot/cold gather split is not ported; build with hot_rows=0")
        n = graph.n
        deg_orig = graph.degrees.astype(np.int64)
        perm = np.argsort(deg_orig, kind="stable").astype(np.int32)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(n, dtype=np.int32)
        deg_sorted = deg_orig[perm]

        def fill_ell(rows: np.ndarray, width: int):
            """[len(rows), width] relabeled neighbour ids (0-padded) and
            per-row valid counts for relabeled rows of degree ≤ width."""
            lens = deg_sorted[rows]
            total = int(lens.sum())
            nbr = np.zeros((len(rows), width), dtype=np.int32)
            dg = lens.astype(np.int32)
            if total:
                it = np.int32 if total < 2**31 else np.int64
                cum = np.cumsum(lens, dtype=np.int64)
                row_of = np.repeat(np.arange(len(rows), dtype=it), lens)
                within = (np.arange(total, dtype=it)
                          - np.repeat((cum - lens).astype(it), lens))
                flat = graph.rowptr[perm[rows]][row_of] + within
                nbr[row_of, within] = inv_perm[graph.colids[flat]]
            return nbr, dg

        if widths is None:
            widths = SyncLayout.widths_for(min_width, hub_width, "pow2")
        else:
            widths = sorted(set(int(w) for w in widths))
            if widths[-1] != hub_width:
                raise ValueError("width ladder must end at hub_width")

        bounds = []
        i = 0
        for w in widths:
            j = int(np.searchsorted(deg_sorted, w, side="right"))
            if j > i:
                bounds.append((w, i, j))
                i = j
        hub_start_row = i

        buckets = []
        padded_edges = 0
        for w, i, j in bounds:
            count = _round_up(j - i, row_align)
            nbr_j, dg_j = fill_ell(np.arange(i, j), w)
            nbr = np.zeros((count, w), dtype=np.int32)
            dg = np.zeros(count, dtype=np.int32)
            nbr[: j - i] = nbr_j
            dg[: j - i] = dg_j
            buckets.append(EllBucket(width=w, start=i, count=count, nbr=nbr,
                                     deg=dg))
            padded_edges += count * w

        # hub bucket: rows with deg > hub_width, split into virtual rows
        i = hub_start_row
        if i < n:
            w = hub_width
            hub_rows = np.arange(i, n)
            lens = deg_sorted[hub_rows].astype(np.int64)
            vcounts = -(-lens // w)  # virtual rows per hub row
            nv = int(vcounts.sum())
            owners_v = np.repeat(hub_rows, vcounts).astype(np.int32)
            vidx = np.arange(nv) - np.repeat(np.cumsum(vcounts) - vcounts,
                                             vcounts)
            vdeg = np.minimum(
                lens[np.repeat(np.arange(len(hub_rows)), vcounts)] - vidx * w,
                w)
            total = int(vdeg.sum())
            row_of = np.repeat(np.arange(nv), vdeg)
            within = np.arange(total) - np.repeat(np.cumsum(vdeg) - vdeg, vdeg)
            flat = (graph.rowptr[perm[owners_v]][row_of] + vidx[row_of] * w
                    + within)
            count = _round_up(nv, row_align)
            nbr = np.zeros((count, w), dtype=np.int32)
            dg = np.zeros(count, dtype=np.int32)
            # pad rows own row i with deg 0, so they add nothing
            owners = np.full(count, i, dtype=np.int32)
            nbr[row_of, within] = inv_perm[graph.colids[flat]]
            dg[:nv] = vdeg
            owners[:nv] = owners_v
            buckets.append(EllBucket(width=w, start=i, count=count, nbr=nbr,
                                     deg=dg, owners=owners))
            padded_edges += count * w

        # the table covers every bucket's padded row range
        max_extent = max(
            [n] + [b.start + b.count for b in buckets if b.owners is None])
        n_pad = _round_up(max_extent, row_align)
        deg_pad = np.zeros(n_pad, dtype=np.int32)
        deg_pad[:n] = deg_sorted
        return SyncLayout(n=n, n_pad=n_pad, perm=perm, inv_perm=inv_perm,
                          deg=deg_pad, buckets=buckets,
                          padded_edges=padded_edges)
