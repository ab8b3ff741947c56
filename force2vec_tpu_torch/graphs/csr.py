"""CSR graph container and the sync schedule's degree-sorted ELL layout.

A numpy copy of the host code in ``force2vec_tpu/graphs/csr.py``: that
package's ``__init__`` imports JAX, which the GPU host does not have, so
the port carries its own copy and ``tests/test_torch_layout.py`` pins its
arrays equal to the JAX package's.

``Graph`` has all of the JAX ``Graph``'s methods, ``SyncLayout`` the JAX
layout's hot/cold gather split (``hot_rows > 0``: ``_split_hot``,
``HotSpan``), and ``DeviceGraph`` is the batch trainer's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from force2vec_tpu_torch.utils.profiling import span


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
    @span("graph.from_coo")
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


def _split_hot(nbr: np.ndarray, dg: np.ndarray, w: int, hot_start: int,
               align: int = 8):
    """Partition a filled ELL rectangle into per-run cold and hot
    rectangles (the JAX package's ``graphs/csr.py::_split_hot``, array for
    array).

    Runs are maximal row spans of equal (⌈hot/8⌉·8, ⌈cold/8⌉·8) width
    class, and both of a run's rectangles are tight.  Each rectangle is
    padded to whole ``align``-row blocks (pad rows: deg 0, ids 0).

    Returns ``(cold_flat, cdeg, hdeg, hot_flat, spans)``: the flats are 1-D
    int32 (hot ids local to the hot suffix, id − hot_start), the deg arrays
    are span-row-padded, and ``spans`` is a list of :class:`HotSpan`.
    """
    cnt_rows = len(dg)
    hotm = (nbr >= hot_start) & (np.arange(w)[None, :] < dg[:, None])
    hot_ct = hotm.sum(1).astype(np.int32)
    # a stable argsort of booleans packs each row as
    # [cold valid..., padding..., hot...]
    order = np.argsort(hotm, axis=1, kind="stable")
    packed = np.take_along_axis(nbr, order, axis=1)
    dg_cold = (dg - hot_ct).astype(np.int32)
    wh_row = ((hot_ct + 7) // 8) * 8
    wc_row = ((dg_cold + 7) // 8) * 8

    empty = np.zeros(0, dtype=np.int32)
    if cnt_rows == 0:
        return empty, empty, empty, empty, []

    change = np.flatnonzero(
        (wh_row[1:] != wh_row[:-1]) | (wc_row[1:] != wc_row[:-1])) + 1
    starts = np.concatenate([[0], change]).astype(np.int64)
    ends = np.concatenate([change, [cnt_rows]]).astype(np.int64)
    counts = ends - starts
    if align % 8:
        raise ValueError(f"span align {align} must be a multiple of 8")
    r8s = ((counts + align - 1) // align) * align
    whs = wh_row[starts].astype(np.int64)
    wcs = wc_row[starts].astype(np.int64)
    cold_offs = np.concatenate([[0], np.cumsum(r8s * wcs)])
    hot_offs = np.concatenate([[0], np.cumsum(r8s * whs)])
    deg_offs = np.concatenate([[0], np.cumsum(r8s)])

    run_id = np.repeat(np.arange(len(starts)), counts)
    local = np.arange(cnt_rows, dtype=np.int64) - starts[run_id]

    cdeg = np.zeros(int(deg_offs[-1]), dtype=np.int32)
    hdeg = np.zeros(int(deg_offs[-1]), dtype=np.int32)
    deg_pos = deg_offs[run_id] + local
    cdeg[deg_pos] = dg_cold
    hdeg[deg_pos] = hot_ct

    # int32 element positions wherever the flats fit them
    idt = (np.int32 if max(cold_offs[-1], hot_offs[-1], cnt_rows) < 2**31
           else np.int64)

    def elem_index(lens):
        """(row_rep, k): each element's row and rank within its row, for
        the ragged stream with ``lens[row]`` elements a row."""
        tot = int(lens.sum())
        cum = np.cumsum(lens, dtype=np.int64)
        row_rep = np.repeat(np.arange(cnt_rows, dtype=idt), lens)
        k = (np.arange(tot, dtype=idt)
             - np.repeat((cum - lens).astype(idt), lens))
        return row_rep, k

    cold_flat = np.zeros(int(cold_offs[-1]), dtype=np.int32)
    if int(dg_cold.sum()):
        row_rep, k = elem_index(dg_cold)
        base = (cold_offs[run_id] + local * wcs[run_id]).astype(idt)
        cold_flat[np.repeat(base, dg_cold) + k] = packed[row_rep, k]

    hot_flat = np.zeros(int(hot_offs[-1]), dtype=np.int32)
    if int(hot_ct.sum()):
        row_rep, k = elem_index(hot_ct)
        base = (hot_offs[run_id] + local * whs[run_id]).astype(idt)
        # hot slots sit in the last hot_ct columns of the packed row
        src_col = (w - np.repeat(hot_ct, hot_ct).astype(idt)) + k
        hot_flat[np.repeat(base, hot_ct) + k] = (
            packed[row_rep, src_col] - hot_start)

    spans = [
        HotSpan(row_off=int(s), count=int(c), cold_width=int(wc),
                cold_off=int(co), width=int(wh), flat_off=int(ho),
                deg_off=int(do), rows_pad=int(r8))
        for s, c, wc, co, wh, ho, do, r8 in zip(
            starts, counts, wcs, cold_offs[:-1], whs, hot_offs[:-1],
            deg_offs[:-1], r8s)
    ]
    return cold_flat, cdeg, hdeg, hot_flat, spans


@dataclasses.dataclass
class HotSpan:
    """A contiguous row run of one bucket stored as two tight rectangles:
    cold slots (``[rows_pad, cold_width]`` at ``cold_off`` of the bucket's
    flat ``nbr``, relabeled ids) and hot slots (``[rows_pad, width]`` at
    ``flat_off`` of ``hot_flat``, ids local to the hot suffix).  The run's
    rows of the span-padded deg arrays start at ``deg_off``."""

    row_off: int  # first row of the run, relative to the bucket
    count: int  # real rows; rectangles are stored with ``rows_pad`` rows
    cold_width: int  # ⌈cold/8⌉·8 of the run's rows (0: no cold slots)
    cold_off: int  # element offset into EllBucket.nbr (flat when split)
    width: int  # ⌈hot/8⌉·8 of the run's rows (0: no hot slots)
    flat_off: int  # element offset into EllBucket.hot_flat
    deg_off: int = 0  # row offset into the bucket's span-padded deg arrays
    rows_pad: int = 0  # stored rectangle rows: count rounded up to the align


@dataclasses.dataclass
class EllBucket:
    """One degree bucket: ``count`` rows of ELL width ``width`` starting at
    relabeled row ``start``.  For the hub bucket (``owners is not None``)
    the rows are virtual — partial rows of at most ``width`` neighbours
    owned by the real rows ``owners`` — and their partial force sums are
    added into the owner rows.

    With the hot/cold split (``SyncLayout.build(hot_rows=...)``) a non-hub
    bucket's ``nbr`` and ``deg`` hold only its cold slots, as the flat
    per-run rectangles of ``hot_spans``, and its hot slots lie in
    ``hot_flat`` with per-row counts ``hot_deg``.  A row's force is the sum
    of both parts: the split partitions each neighbour multiset."""

    width: int
    start: int  # first relabeled real row (the hub range's start for the hub)
    count: int  # number of (virtual) rows, padded to a multiple of row_align
    nbr: np.ndarray  # [count, width] int32 relabeled neighbour ids (0-padded)
    deg: np.ndarray  # [count] int32 valid neighbours per row
    owners: Optional[np.ndarray] = None  # [count] int32 relabeled owner rows
    hot_flat: Optional[np.ndarray] = None  # 1-D int32 hot-local ids
    hot_deg: Optional[np.ndarray] = None  # span-padded int32 hot slots a row
    hot_spans: Optional[list] = None  # list[HotSpan]


@dataclasses.dataclass
class SyncLayout:
    """Degree-sorted ELL layout for the epoch-synchronous schedule.

    Vertices are relabeled by ascending degree, so each width bucket is a
    contiguous row range of the relabeled table and the buckets tile
    ``[0, n)`` in order, the hub bucket last.  Rows with degree above
    ``hub_width`` are split into virtual rows (the force is a sum over
    edges, so the split is exact).

    ``hot_start``: with the hot/cold split, the relabeled row where the hot
    suffix ``[n - hot_rows, n)`` begins, else None."""

    n: int
    n_pad: int
    perm: np.ndarray  # [n] original id of relabeled row i
    inv_perm: np.ndarray  # [n] relabeled row of original id
    deg: np.ndarray  # [n_pad] int32 degree per relabeled row (0 for padding)
    buckets: list  # list[EllBucket]
    padded_edges: int  # Σ count·width: ELL slots per iteration
    hot_start: Optional[int] = None

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
    @span("trainer.layout")
    def build(
        graph: Graph,
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        widths: Optional[list] = None,
        hot_rows: int = 0,
        span_align: int = 8,
    ) -> "SyncLayout":
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

        # hot/cold split: the hot member set is the top ``hot_rows`` rows of
        # the degree order; the within-bucket reorder below puts members at
        # their bucket's tail, so the set stays the exact suffix
        # [n - hot_rows, n) of the final relabeling
        hot_start = n - hot_rows if 0 < hot_rows < n else None
        if hot_start is not None:
            hot_member = np.zeros(n, dtype=bool)  # per original id
            hot_member[perm[hot_start:]] = True
            cs = np.concatenate(
                [[0], np.cumsum(hot_member[graph.colids], dtype=np.int64)])
            hot_cnt_orig = cs[graph.rowptr[1:]] - cs[graph.rowptr[:-1]]
            for _, bi_, bj_ in bounds:
                h = hot_cnt_orig[perm[bi_:bj_]]
                c = deg_orig[perm[bi_:bj_]] - h
                # membership first (keeps the suffix exact), then the hot
                # width class, then the cold one: runs of equal (⌈hot/8⌉,
                # ⌈cold/8⌉) get both rectangles tight
                order = np.lexsort(
                    ((c + 7) // 8, (h + 7) // 8, hot_member[perm[bi_:bj_]]))
                perm[bi_:bj_] = perm[bi_:bj_][order]
            inv_perm[perm] = np.arange(n, dtype=np.int32)
            deg_sorted = deg_orig[perm]

        buckets = []
        padded_edges = 0
        for w, i, j in bounds:
            count = _round_up(j - i, row_align)
            nbr_j, dg_j = fill_ell(np.arange(i, j), w)
            nbr = np.zeros((count, w), dtype=np.int32)
            dg = np.zeros(count, dtype=np.int32)
            nbr[: j - i] = nbr_j
            dg[: j - i] = dg_j
            if hot_start is None:
                buckets.append(EllBucket(width=w, start=i, count=count,
                                         nbr=nbr, deg=dg))
                padded_edges += count * w
                continue
            cflat, cdeg, hdeg, hflat, spans = _split_hot(
                nbr, dg, w, hot_start, align=span_align)
            buckets.append(EllBucket(
                width=w, start=i, count=count, nbr=cflat, deg=cdeg,
                hot_flat=hflat, hot_deg=hdeg, hot_spans=spans))
            padded_edges += sum(sp.rows_pad * (sp.width + sp.cold_width)
                                for sp in spans)

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

        # the table covers every bucket's padded row range and every span's
        # padded rectangle
        max_extent = max(
            [n] + [b.start + b.count for b in buckets if b.owners is None]
            + [b.start + sp.row_off + sp.rows_pad
               for b in buckets if b.hot_spans for sp in b.hot_spans])
        n_pad = _round_up(max_extent, row_align)
        deg_pad = np.zeros(n_pad, dtype=np.int32)
        deg_pad[:n] = deg_sorted
        return SyncLayout(n=n, n_pad=n_pad, perm=perm, inv_perm=inv_perm,
                          deg=deg_pad, buckets=buckets,
                          padded_edges=padded_edges, hot_start=hot_start)


@dataclasses.dataclass
class DeviceGraph:
    """Static-shape layout of a :class:`Graph` for the batch trainer, at one
    batch size: the JAX package's ``DeviceGraph``, array for array.

    ``n_pad = num_batches * batch_size`` so each minibatch is a fixed
    ``[B, D]`` slice of the (padded) embedding table.  ``colids`` and
    ``edge_src`` are padded by at least one chunk with sentinel edges
    (dst=0, src=0), and ``rowptr[i] = nnz`` for the padding rows i ≥ n.
    ``batch_spans`` adds what the JAX trainer reads on the device: each
    batch's edge span, here on the host, so that the trainer slices it
    without a device-to-host read per batch.
    """

    n: int
    n_pad: int
    nnz: int
    batch_size: int
    num_batches: int
    edge_chunk: int
    rowptr: np.ndarray  # [n_pad+1] int32, rowptr[i]=nnz for i>=n
    colids: np.ndarray  # [nnz_pad] int32
    edge_src: np.ndarray  # [nnz_pad] int32
    deg: np.ndarray  # [n_pad] int32 (0 for padded rows)
    max_batch_edges: int

    @staticmethod
    @span("trainer.layout")
    def build(graph: Graph, batch_size: int,
              edge_chunk: int = 2048) -> "DeviceGraph":
        n = graph.n
        b = min(batch_size, n)
        num_batches = -(-n // b)
        n_pad = num_batches * b
        nnz = graph.nnz
        nnz_pad = _round_up(nnz, edge_chunk) + edge_chunk

        rowptr = np.full(n_pad + 1, nnz, dtype=np.int32)
        rowptr[: n + 1] = graph.rowptr.astype(np.int32)

        colids = np.zeros(nnz_pad, dtype=np.int32)
        colids[:nnz] = graph.colids

        edge_src = np.zeros(nnz_pad, dtype=np.int32)
        edge_src[:nnz] = np.repeat(
            np.arange(n, dtype=np.int32), graph.degrees.astype(np.int64))

        deg = np.zeros(n_pad, dtype=np.int32)
        deg[:n] = graph.degrees.astype(np.int32)

        starts = rowptr[0: n_pad: b].astype(np.int64)
        ends = rowptr[b: n_pad + 1: b].astype(np.int64)
        max_batch_edges = int((ends - starts).max()) if num_batches else 0

        return DeviceGraph(n=n, n_pad=n_pad, nnz=nnz, batch_size=b,
                           num_batches=num_batches, edge_chunk=edge_chunk,
                           rowptr=rowptr, colids=colids, edge_src=edge_src,
                           deg=deg, max_batch_edges=max_batch_edges)

    def batch_spans(self) -> list:
        """``[(e0, e1)]`` per batch: its rows' edges are ``colids[e0:e1]``
        (``rowptr[b·B]`` and ``rowptr[(b+1)·B]``), as Python ints."""
        b = self.batch_size
        return [(int(self.rowptr[k * b]), int(self.rowptr[(k + 1) * b]))
                for k in range(self.num_batches)]
