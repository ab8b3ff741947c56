"""Epoch-synchronous trainer: the sync schedule of ``force2vec_tpu``.

Semantically the reference's training loop at ``batch_size = n``: every
read in an iteration sees the iteration-start X and the update is applied
once at its end (sample/algorithms.cpp:569-639 with NUMSIZE = n).  One
iteration over the degree-sorted ELL layout (graphs/csr.py::SyncLayout):

1. ``xg``: the gather replica of X (bf16 when ``gather_dtype`` says so;
   X itself when X is bf16, ``TrainConfig(dtype="bfloat16")``: no cast);
2. attraction, by the edge kernel (``ell_edge_force``):

   * CSR models: one launch over the layout's work table
     (``edge_table``, every bucket, widest first), written straight into
     the update's rows; the hub bucket's virtual rows write partial sums to
     rows past ``n_pad``, which ``index_add_`` adds into their owner rows,
     and a width-0 entry zeroes the rows no bucket writes (the hub owners
     and padding; with a bf16 X the owners' sums are taken in f32,
     ``ops/segment.py::add_rows``);
   * with the hot/cold gather split (``hot_rows > 0``; the layout's hot
     suffix, the top ``hot_rows`` rows of the degree order, is the
     relabeled rows ``[n - hot_rows, n)``): that launch over the cold
     slots (``edge_table``), then a second over the hot slots
     (``hot_table``, a partial table of the rows with hot slots), which
     adds into the rows the first wrote.  The JAX package gathers the hot
     slots from a compact copy of the suffix; on the card the suffix is a
     range of the same replica, so the hot table holds ids of the whole
     table.  The split gives the unsplit sums up to their order.  It is
     off unless asked for: on the H100 it was slower at every replica
     size and hot share measured (``PERF.md`` §9.6);
   * walk models (``rwalk``): one launch over every table row, whose
     neighbours are the row's ``[walk_length]`` walk targets, drawn each
     iteration by the walk engine (``draw_walks``);

3. repulsion, added into the update:

   * group-shared negatives (the default): the ``[ng, ns, D]`` samples
     ``xg[negs]``, one ``grouped_rep_force`` launch and an ``add_``;
   * per-vertex negatives (``per_vertex_samples``, the CLI's ``-bs 1``):
     one ``ell_sample_force`` launch over every table row, with its
     ``[n_pad, ns]`` sample ids, gathered and added in the kernel;

4. ``X += update`` (or the energy-normalized update), in place.

X is f32 or bf16 (``config.dtype``; ``force_kernels.X_DTYPES``, the
constructor refuses any other, naming it).  The update, ``inv_deg`` and
the step are in X's dtype, as in the JAX package (its ``sync.py:133-138,
:661, :712-714``): the kernels sum in f32 and round each force once to
X's dtype, and the adds and the apply run in X's dtype.

Padding rows take part as in the JAX package: their update is computed and
applied, and no edge or sample of a real row reads them.  Everything runs
in relabeled (degree-sorted) vertex order; ``pad_embedding`` and
``unpad_embedding`` permute in and out.  X's rows are ``row_width`` =
``force_kernels.padded_dim(dim)`` wide (the dim rounded up to 8, the
kernels' row alignment), the padding columns 0: every force model keeps
them 0 (tdist's and the layout family's differences are 0 there, the
sigmoid family's force is ∝ x_j, and the energy update's row norm does
not change), so only the order of float sums can differ from an unpadded
X.  The public shape stays ``[n, dim]``: ``init_embedding`` draws
``[n_pad, dim]`` and pads, ``unpad_embedding`` drops the padding.

Under ``spmd`` (``dist/multihost.py::pod_mesh``, one process per
card), X is replicated over the dp ranks and its dim split over the tp
ranks:

* dp: each rank runs the edge kernel over a work table of its 1/dp slice
  of every bucket (the hub's virtual rows too; with the split, the hot
  slots of the same rows into the same local rows); one
  ``all_gather_into_tensor`` reassembles the slices, and a fixed
  permutation (``index_select``) puts them in row order.  The repulsion
  runs over the rank's 1/dp of the rows (``grouped_rep_force`` from the
  group boundary at or before the slice's first row, so that the
  kernel's groups are the layout's) and is gathered by a second
  ``all_gather_into_tensor``;
* tp: a pair's scalar is a sum over the tp ranks' columns, which the
  fused kernels cannot make; the forces run as the split-dim kernels
  instead, over the attraction's and the repulsion's work tables laid end
  to end (the split's cold and hot tables both; group-shared negatives
  as each row's own row of ns ids): one
  ``tp_pair_partial`` launch over both, one ``all_reduce`` of the scalars
  over tp (counted in ``tp_all_reduces``), then a ``tp_pair_force`` launch
  for each force on its slice of them (the hot table's adding into the
  cold's rows).  The JAX package runs that
  step in jnp ops (Pallas off at tp > 1).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.graphs.csr import Graph, SyncLayout
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels
from force2vec_tpu_torch.ops.segment import add_rows
from force2vec_tpu_torch.train.trainer import (TrainConfig, iteration_seed,
                                               round_to, step_at)


@dataclasses.dataclass
class DeviceBucket:
    """One ELL bucket's index arrays on the device, as the per-bucket edge
    kernel call takes them (``SyncForce2Vec.device_buckets``)."""

    start: int  # first relabeled row of the bucket's update
    nbr: torch.Tensor  # [rows, width] int32 (split: the cold slots)
    deg: torch.Tensor  # [rows] int32
    xi_row: torch.Tensor  # [rows] int32 table row of each bucket row
    owner_local: Optional[torch.Tensor] = None  # hub: [rows] int64, - start


def _split_bucket_rows(b, hot_start: int):
    """A split bucket's ``(cold_nbr, cold_deg, hot_nbr, hot_deg)``, int32
    with one row per bucket row (``b.count``): each run's (``HotSpan``'s)
    cold and hot rectangles put back in the bucket's row order, at the
    widest run's width (the kernel reads no slot past a row's deg, so the
    width costs no gather), hot ids made ids of the whole table
    (``hot_flat + hot_start``), padding slots 0."""
    cw = max(sp.cold_width for sp in b.hot_spans)
    hw = max(sp.width for sp in b.hot_spans)
    cn = np.zeros((b.count, cw), dtype=np.int32)
    hn = np.zeros((b.count, hw), dtype=np.int32)
    cd = np.zeros(b.count, dtype=np.int32)
    hd = np.zeros(b.count, dtype=np.int32)
    for sp in b.hot_spans:
        r = slice(sp.row_off, sp.row_off + sp.count)
        d = slice(sp.deg_off, sp.deg_off + sp.count)
        cd[r], hd[r] = b.deg[d], b.hot_deg[d]
        if sp.cold_width:
            cn[r, :sp.cold_width] = b.nbr[
                sp.cold_off: sp.cold_off + sp.count * sp.cold_width].reshape(
                    sp.count, sp.cold_width)
        if sp.width:
            ids = b.hot_flat[sp.flat_off: sp.flat_off + sp.count * sp.width]
            real = np.arange(sp.width)[None, :] < hd[r][:, None]
            hn[r, :sp.width] = np.where(
                real, ids.reshape(sp.count, sp.width) + hot_start, 0)
    return cn, cd, hn, hd


def _runs(mask: np.ndarray) -> list:
    """``[(r0, r1)]``: the maximal runs of consecutive True rows."""
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], mask.astype(np.int8), [0]])))
    return list(zip(edges[::2].tolist(), edges[1::2].tolist()))


def build_walk_tables(lay: SyncLayout):
    """(pool, base) int32: the flat neighbour pool (every bucket's ELL
    rectangle, concatenated) and each relabeled row's offset into it, so a
    walk step's (vertex, slot) → neighbour lookup is ``pool[base[v] +
    slot]``.  Exact for hubs too: an owner's virtual rows are consecutive
    and each holds ``width`` slots, so the pool linearizes the whole CSR
    row.  The JAX package's ``sync.py::_build_walk_tables``, with a check
    that the offsets fit int32."""
    base = np.zeros(lay.n_pad, dtype=np.int64)
    pools = []
    off = 0
    for b in lay.buckets:
        pools.append(b.nbr.reshape(-1))
        if b.owners is None:
            rows = np.arange(b.count, dtype=np.int64)
            base[b.start + rows] = off + rows * b.width
        else:
            # first virtual row per owner (owners' vrows are consecutive)
            u, idx = np.unique(b.owners, return_index=True)
            base[u] = off + idx.astype(np.int64) * b.width
        off += b.nbr.size
    if off >= 2**31:
        raise ValueError(f"walk pool of {off} slots does not fit int32 offsets")
    pool = (np.concatenate(pools) if pools
            else np.zeros(1, dtype=np.int32)).astype(np.int32)
    return pool, base.astype(np.int32)


class SyncForce2Vec:
    """Train with the epoch-synchronous schedule on ``device``.

    Supports every sampled-repulsion model (tdist, sigmoid, rwalk, fr,
    linlog, forceatlas), with group-shared or per-vertex negatives, and
    the sigmoid family's lookup-table σ (``sm_table``).  On the card the
    kernels take dims 1 to ``force_kernels.KERNEL_MAX_DIM`` (under tp,
    this rank's columns); the constructor raises ``ValueError`` above.
    ``spmd``: the dp and tp groups this rank trains in (see the module's
    docstring); the rows then align to the least multiple of ``row_align``
    and dp.  ``hot_rows``: the hot/cold split's hot suffix, 0 (the
    default, no split: ``tools/profile_iter.py --hot-rows`` found it slower
    on the H100 at every replica size and hot share tried, ``PERF.md``
    §9.6); walk models take 0.
    """

    def __init__(
        self,
        graph: Graph,
        config: TrainConfig = TrainConfig(),
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        *,
        hot_rows: int = 0,
        spmd: SpmdAxes = SpmdAxes(),
        device="cuda",
    ):
        self.graph = graph
        self.config = config
        self.device = torch.device(device)
        self.spmd = spmd
        self._dtype = getattr(torch, config.dtype)
        # the kernels (and their plain versions) hold X in f32 or bf16
        force_kernels.check_x_dtype(self._dtype)
        self.model = get_model(config.model, sm_table=config.sm_table)
        if self.model.repulsion == "all":
            raise ValueError("tdist_exact uses the batch trainer, not sync mode")
        if config.dim % spmd.n_tp:
            raise ValueError(f"dim {config.dim} must divide over tp="
                             f"{spmd.n_tp}")
        # every dp rank takes a whole 1/dp of each bucket's padded rows
        row_align = math.lcm(row_align, spmd.n_dp)
        self._dim = config.dim // spmd.n_tp  # this rank's columns of X
        # X's row width: those columns and 0 columns up to the kernels' row
        # alignment (each tp rank pads its own)
        self.row_width = force_kernels.padded_dim(self._dim)
        # tp: the pairs' scalars need an all_reduce, so the forces run as
        # the split-dim kernels (tp_pair_partial, all_reduce, tp_pair_force
        # twice) over the tables _tp_tables lays end to end
        self._tp = spmd.n_tp > 1
        self.tp_all_reduces = 0  # the pair scalars' all_reduces so far
        self._rsum = spmd.make_rsum()  # the energy update's row norms
        if self.device.type == "cuda":
            if not self._tp:
                force_kernels.check_kernel_dim(config.dim)
            elif self._dim > force_kernels.KERNEL_MAX_DIM:
                raise ValueError(
                    f"the split-dim kernels take at most "
                    f"{force_kernels.KERNEL_MAX_DIM} columns a rank, got "
                    f"{self._dim} (dim {config.dim} over tp={spmd.n_tp}); "
                    "the batch schedule (--schedule batch) trains at any "
                    "dim")
        self._gdt = (None if config.gather_dtype is None
                     else getattr(torch, config.gather_dtype))
        if hot_rows > 0 and self.model.attraction == "walk":
            raise ValueError(f"{self.model.name} draws walks over the unsplit "
                             "layout; the hot/cold split takes hot_rows=0")
        self.hot_rows = int(hot_rows)
        # hot/cold split under dp: the JAX package aligns the span
        # rectangles to the dp row quantum, lcm(8, dp)
        self.layout = SyncLayout.build(
            graph, min_width=min_width, hub_width=hub_width,
            row_align=row_align,
            widths=SyncLayout.widths_for(min_width, hub_width, "mult8"),
            hot_rows=self.hot_rows,
            span_align=math.lcm(8, spmd.n_dp),
        )
        self.lr = config.resolve_lr(self.model)
        self._span_gen = torch.Generator(device=self.device)

        lay, dev = self.layout, self.device
        self.inv_deg = torch.as_tensor(
            1.0 / (lay.deg.astype(np.float64) + 1.0), dtype=self._dtype,
            device=dev)
        # the per-row launches (walk attraction, per-vertex repulsion) run
        # over every table row with a constant slot count
        self._all_rows = torch.arange(lay.n_pad, dtype=torch.int32, device=dev)
        self._neg_shape = ((lay.n_pad if config.per_vertex_samples
                            else -(-lay.n_pad // max(config.batch_size, 1))),
                           config.ns)
        self._ns_deg = torch.full((lay.n_pad,), config.ns, dtype=torch.int32,
                                  device=dev)
        # tp, group-shared negatives: each row's group, whose ns ids it takes
        self._gid = (torch.arange(lay.n_pad, device=dev)
                     // max(config.batch_size, 1))
        self.device_buckets = []
        self.edge_table = self.hot_table = self._hub = None
        if self.model.attraction == "walk":
            pool, base = build_walk_tables(lay)
            self.walk_pool = torch.as_tensor(pool, device=dev)
            # (deg, base) packed as one [n_pad, 2] table, so a walk step
            # fetches both with one row gather
            self.walk_db = torch.as_tensor(
                np.stack([lay.deg.astype(np.int32), base], axis=1), device=dev)
            self._walk_deg = torch.full((lay.n_pad,), config.walk_length,
                                        dtype=torch.int32, device=dev)
        else:  # walk attraction reads no bucket
            self._bucket_tables()
        if self._tp:
            self._tp_tables()

    def _host_rows(self, b):
        """A non-hub bucket's ``(nbr, deg, hot_nbr, hot_deg)`` on the host,
        one row per bucket row: the layout's arrays, or with the split its
        cold and hot slots (``_split_bucket_rows``; hot None unsplit)."""
        if b.hot_spans is None:
            return b.nbr, b.deg, None, None
        return _split_bucket_rows(b, self.layout.hot_start)

    def _bucket_tables(self) -> None:
        """``device_buckets``, the hub among them, and the attraction's
        work tables (``edge_table``, and with the split ``hot_table``;
        under dp this rank's slices of them)."""
        lay, dev = self.layout, self.device
        rows = [None if b.owners is not None else self._host_rows(b)
                for b in lay.buckets]
        hot = []  # (hot_nbr, hot_deg, xi_row, out_begin) of the real rows
        for bi, b in enumerate(lay.buckets):
            if b.owners is not None:
                self.device_buckets.append(DeviceBucket(
                    start=b.start,
                    nbr=torch.as_tensor(b.nbr, device=dev),
                    deg=torch.as_tensor(b.deg, device=dev),
                    xi_row=torch.as_tensor(b.owners, device=dev),
                    owner_local=torch.as_tensor(
                        b.owners.astype(np.int64) - b.start, device=dev)))
                continue
            # Only the bucket's real rows: its row_align padding overlaps
            # the next bucket's first rows.
            end = (lay.buckets[bi + 1].start if bi + 1 < len(lay.buckets)
                   else lay.n)
            real = end - b.start
            nbr, deg, hot_nbr, hot_deg = rows[bi]
            xi_row = torch.arange(b.start, end, dtype=torch.int32, device=dev)
            self.device_buckets.append(DeviceBucket(
                start=b.start, nbr=torch.as_tensor(nbr[:real], device=dev),
                deg=torch.as_tensor(deg[:real], device=dev), xi_row=xi_row))
            if hot_nbr is not None:
                hot.append((hot_nbr[:real], hot_deg[:real], xi_row, b.start))
        self._hub = next((b for b in self.device_buckets
                          if b.owner_local is not None), None)
        if self.spmd.n_dp > 1:
            self._dp_edge_table(rows)
        else:
            self.edge_table = self._edge_table()
            self.hot_table = self._hot_table(hot, self.edge_table.out_rows)

    def _hot_table(self, buckets, out_rows: int):
        """The split's hot work table: of each ``(hot_nbr, hot_deg, xi_row,
        out_begin)`` (host arrays; xi_row on the device), the runs of rows
        with hot slots, as entries of a ``partial`` table whose rows the
        cold table (``edge_table``, the same ``out_rows``) has written;
        None without hot slots."""
        dev, parts = self.device, []
        for nbr, deg, xi_row, ob in buckets:
            for r0, r1 in _runs(deg > 0):
                parts.append((torch.as_tensor(nbr[r0:r1], device=dev),
                              torch.as_tensor(deg[r0:r1], device=dev),
                              xi_row[r0:r1], ob + r0))
        if not parts:
            return None
        return force_kernels.edge_work_table(parts, self.layout.n_pad,
                                             out_rows, partial=True)

    def _tp_tables(self) -> None:
        """tp: the attraction's work tables (``edge_table`` and, with the
        split, ``hot_table``; or the walks of this rank's rows) and the
        repulsion's (each of this rank's rows with its ns sample ids) laid
        end to end (``force_kernels.concat_work_tables``) as ``_tp_cat``,
        so that an iteration makes one ``tp_pair_partial`` launch and one
        ``all_reduce``.  ``_tp_att``, ``_tp_hot`` (None unsplit) and
        ``_tp_rep`` are views of its parts, whose ids each iteration's walks
        and negatives overwrite."""
        fk, cfg = force_kernels, self.config
        r0, r1 = self._rank_rows()

        def per_row(width, deg):
            ids = torch.zeros((r1 - r0, width), dtype=torch.int32,
                              device=self.device)
            return fk.EdgeWorkTable.single(ids, deg[r0:r1],
                                           self._all_rows[r0:r1],
                                           self.layout.n_pad)

        att = ([per_row(cfg.walk_length, self._walk_deg)]
               if self.model.attraction == "walk" else
               [t for t in (self.edge_table, self.hot_table) if t is not None])
        self._tp_cat, views = fk.concat_work_tables(
            att + [per_row(cfg.ns, self._ns_deg)])
        self._tp_att, self._tp_rep = views[0], views[-1]
        self._tp_hot = views[1] if len(views) == 3 else None

    def _edge_table(self) -> force_kernels.EdgeWorkTable:
        """The work table of ``device_buckets``: a non-hub bucket writes its
        own rows of the update, the hub's virtual rows write rows ``n_pad +
        v`` of the attraction output, and a width-0 entry zeroes the rows
        no bucket writes (the hub's owner rows and the padding)."""
        n_pad, dev, hub = self.layout.n_pad, self.device, self._hub
        # the hub first: among equal widths its rows are the longest
        parts = [(b.nbr, b.deg, b.xi_row, n_pad if b is hub else b.start)
                 for b in ([hub] if hub else []) + [
                     b for b in self.device_buckets if b is not hub]]
        rest = hub.start if hub else self.layout.n
        parts.append((torch.zeros((n_pad - rest, 0), dtype=torch.int32,
                                  device=dev),
                      torch.zeros(n_pad - rest, dtype=torch.int32, device=dev),
                      torch.arange(rest, n_pad, dtype=torch.int32, device=dev),
                      rest))
        hub_rows = hub.nbr.shape[0] if hub else 0
        return force_kernels.edge_work_table(parts, n_pad, n_pad + hub_rows)

    def _dp_rows(self):
        """This dp rank's contiguous 1/dp of the table rows."""
        local = self.layout.n_pad // self.spmd.n_dp
        r0 = self.spmd.dp_index * local
        return r0, r0 + local

    def _rank_rows(self):
        """The table rows whose per-row forces this rank computes: all of
        them, or under dp its 1/dp (``_dp_rows``)."""
        if self.spmd.n_dp > 1:
            return self._dp_rows()
        return 0, self.layout.n_pad

    def _dp_edge_table(self, host_rows) -> None:
        """This dp rank's work tables: the rank's 1/dp slice of every
        bucket's padded rows (the hub's virtual rows too), written to
        consecutive rows of a local ``[L, D]`` output, with the split the
        hot slots of the same rows into the same local rows
        (``hot_table``); and the fixed permutation of the gathered ``[dp·L
        + 1, D]`` slices (row dp·L kept 0) into row order, ``_dp_src`` for
        the update's rows and ``_dp_hub_src`` for the hub's partial rows."""
        lay, dev, sp = self.layout, self.device, self.spmd
        dp, d = sp.n_dp, sp.dp_index
        parts, hot, spans, off = [], [], [], 0
        on_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        for b, hr in zip(lay.buckets, host_rows):
            per = b.count // dp
            rows = np.arange(d * per, (d + 1) * per)
            if b.owners is not None:
                nbr, deg, hot_nbr, hot_deg = b.nbr, b.deg, None, None
                xi = b.owners[rows]
            else:
                nbr, deg, hot_nbr, hot_deg = hr
                xi = np.minimum(b.start + rows, lay.n_pad - 1)
            xi = on_dev(xi.astype(np.int32))
            parts.append((on_dev(nbr[rows]), on_dev(deg[rows]), xi, off))
            if hot_nbr is not None:
                hot.append((hot_nbr[rows], hot_deg[rows], xi, off))
            spans.append((b, per, off))
            off += per
        local = off
        src = np.full(lay.n_pad, dp * local, dtype=np.int64)
        hub_src = None
        for bi, (b, per, o) in enumerate(spans):
            if b.owners is not None:
                v = np.arange(b.count)
                hub_src = (v // per) * local + o + v % per
                continue
            end = (lay.buckets[bi + 1].start if bi + 1 < len(lay.buckets)
                   else lay.n)
            i = np.arange(end - b.start)
            src[b.start + i] = (i // per) * local + o + i % per
        self.edge_table = force_kernels.edge_work_table(parts, lay.n_pad,
                                                        local)
        self.hot_table = self._hot_table(hot, local)
        self._dp_src = torch.as_tensor(src, device=dev)
        self._dp_hub_src = (None if hub_src is None
                            else torch.as_tensor(hub_src, device=dev))

    def split_stats(self) -> dict:
        """The hot/cold split's accounting (the JAX package's
        ``SyncForce2Vec.split_stats``): the padded slots of the layout's
        hot rectangles and of the rest per iteration, their hot fraction and
        the number of runs."""
        lay = self.layout
        hot = cold = rect = 0
        for b in lay.buckets:
            if b.hot_spans is None:
                rect += b.count * b.width
                continue
            for sp in b.hot_spans:
                hot += sp.rows_pad * sp.width
                cold += sp.rows_pad * sp.cold_width
        total = hot + cold + rect
        return {
            "hot_rows": self.hot_rows,
            "hot_start": lay.hot_start,
            "hot_slots_per_iter": hot,
            "cold_slots_per_iter": cold + rect,
            "hot_fraction": round(hot / total, 4) if total else 0.0,
            "spans": sum(len(b.hot_spans) for b in lay.buckets
                         if b.hot_spans),
        }

    # -- embedding layout ---------------------------------------------------

    def init_embedding(self, seed: int = 1) -> torch.Tensor:
        """[n_pad, row_width] uniform init ([0, 1) or [-1, 1) by the model):
        ``[n_pad, dim]`` drawn from a torch generator seeded with ``seed``,
        then padded with 0 columns, so a seed gives the same X at any row
        width.  Padding rows are random too, as in the JAX package; no
        edge or sample reads them."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = torch.rand((self.layout.n_pad, self.config.dim), generator=gen,
                       dtype=self._dtype, device=self.device)
        x = x if self.model.init == "uniform01" else x.mul_(2.0).sub_(1.0)
        return self._tp_columns(x)

    def _tp_columns(self, x: torch.Tensor) -> torch.Tensor:
        """This tp rank's columns of a full-width ``[n_pad, dim]`` X,
        padded with 0 columns to ``row_width``."""
        if self.spmd.n_tp > 1:
            c0 = self.spmd.tp_index * self._dim
            x = x[:, c0: c0 + self._dim]
        return F.pad(x, (0, self.row_width - self._dim))

    def pad_embedding(self, x) -> torch.Tensor:
        """[n, dim] in original id order → [n_pad, row_width] relabeled, on
        device (this tp rank's columns under tp)."""
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        if tuple(x.shape) != (self.graph.n, self.config.dim):
            raise ValueError(f"X {tuple(x.shape)} != "
                             f"{(self.graph.n, self.config.dim)}")
        out = torch.zeros((self.layout.n_pad, self.config.dim),
                          dtype=self._dtype, device=self.device)
        out[: self.graph.n] = x[torch.as_tensor(self.layout.perm,
                                                device=self.device).long()]
        return self._tp_columns(out)

    def unpad_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """[n_pad, row_width] relabeled → [n, dim] in original id order
        (under tp, the ranks' columns gathered: a collective over tp)."""
        x = x[:, : self._dim]
        if self.spmd.n_tp > 1:
            x = x.contiguous()
            cols = [torch.empty_like(x) for _ in range(self.spmd.n_tp)]
            dist.all_gather(cols, x, group=self.spmd.tp)
            x = torch.cat(cols, dim=1)
        inv = torch.as_tensor(self.layout.inv_perm, device=x.device).long()
        return x[: self.graph.n][inv]

    # -- the walk engine -------------------------------------------------------

    def draw_walks(self, gen: torch.Generator) -> torch.Tensor:
        """[n_pad, walk_length] int32 uniform walks over the relabeled graph,
        one from every table row (the JAX package's ``sync.py::_ell_walks``,
        in plain torch ops on the device).  Each step draws r in
        [0, 2**31 - 1) from ``gen``, fetches the current rows' (deg, base)
        with one row gather, and moves to ``pool[base + r % max(deg, 1)]``;
        rows of degree 0 (and padding rows) stay put."""
        cur = self._all_rows
        steps = []
        for _ in range(self.config.walk_length):
            r = torch.randint(0, 2**31 - 1, cur.shape, generator=gen,
                              dtype=torch.int32, device=self.device)
            db = self.walk_db.index_select(0, cur)
            d, base = db[:, 0], db[:, 1]
            nxt = self.walk_pool.index_select(0, base + r % d.clamp(min=1))
            cur = torch.where(d > 0, nxt, cur)
            steps.append(cur)
        return torch.stack(steps, dim=1)

    # -- the iteration ---------------------------------------------------------

    def _tp_forces(self, x, xg, negs, walks, step, plain):
        """tp: this rank's attraction and repulsion on its columns, shaped
        as ``_edge_table_launch`` (or ``_walk_launch``) and
        ``_rank_repulsion`` return them: the iteration's walks and
        negatives written into ``_tp_cat``'s ids, one ``tp_pair_partial``
        over it, one ``all_reduce`` of the scalars over tp, then
        ``tp_pair_force`` for each force on its slice of them."""
        fk, model = force_kernels, self.model
        r0, r1 = self._rank_rows()
        if walks is not None:
            self._tp_att.nbr.view(r1 - r0, -1).copy_(walks[r0:r1])
        rep_ids = self._tp_rep.nbr.view(r1 - r0, -1)
        if self.config.per_vertex_samples:
            rep_ids.copy_(negs[r0:r1])
        else:  # each row's group's ids as its own row of samples
            torch.index_select(negs, 0, self._gid[r0:r1], out=rep_ids)
        part = (fk.tp_pair_partial_plain if plain else fk.tp_pair_partial)(
            model, x, xg, self._tp_cat)
        dist.all_reduce(part, group=self.spmd.tp)
        self.tp_all_reduces += 1
        force = fk.tp_pair_force_plain if plain else fk.tp_pair_force
        n_att = self._tp_att.nbr.shape[0]
        att = force(model, "edge", x, xg, self._tp_att, part[:n_att],
                    self.inv_deg, step)
        if self._tp_hot is not None:  # the hot slots add into the cold's rows
            n_hot = self._tp_hot.nbr.shape[0]
            force(model, "edge", x, xg, self._tp_hot,
                  part[n_att: n_att + n_hot], self.inv_deg, step, out=att,
                  accumulate=True)
            n_att += n_hot
        return att, force(model, "sample", x, xg, self._tp_rep, part[n_att:],
                          self.inv_deg, step)

    def _edge_table_launch(self, x, xg, step, plain) -> torch.Tensor:
        """This rank's attraction over ``edge_table``: ``[n_pad + hub rows,
        D]``, or under dp its slices' ``[L, D]`` (``_place_attraction``).
        With the split, a second launch over ``hot_table`` adds the hot
        slots' sums into the rows the first wrote."""
        fk = force_kernels
        launch = fk.ell_edge_force_table_plain if plain else (
            fk.ell_edge_force_table)
        out = launch(self.model, x, xg, self.edge_table, self.inv_deg, step)
        if self.hot_table is not None:
            launch(self.model, x, xg, self.hot_table, self.inv_deg, step,
                   out=out, accumulate=True)
        return out

    def _dp_gather(self, local: torch.Tensor, rows: int) -> torch.Tensor:
        """``[rows, D]``: the dp ranks' ``local`` slices in rank order (one
        ``all_gather_into_tensor``)."""
        out = torch.empty((rows, local.shape[1]), dtype=local.dtype,
                          device=local.device)
        dist.all_gather_into_tensor(out, local.contiguous(),
                                    group=self.spmd.dp)
        return out

    def _place_rows(self, local: torch.Tensor) -> torch.Tensor:
        """``[n_pad, D]`` from a per-row force of this rank's rows
        (``_rank_rows``): ``local`` itself, or under dp the ranks' slices
        gathered."""
        if self.spmd.n_dp == 1:
            return local
        return self._dp_gather(local, self.layout.n_pad)

    def _dp_place(self, g: torch.Tensor) -> torch.Tensor:
        """``[n_pad, D]`` attraction from ``g`` ``[dp·L + 1, D]``: the dp
        ranks' ``_edge_table_launch`` slices in rank order, then a 0 row
        (for the rows no bucket writes: the hub's owners and the padding),
        put in row order by the fixed permutation, the hub's partial rows
        added into their owners."""
        upd = g.index_select(0, self._dp_src)
        if self._hub is not None:
            add_rows(upd[self._hub.start: self.layout.n],
                     self._hub.owner_local,
                     g.index_select(0, self._dp_hub_src))
        return upd

    def _place_attraction(self, out: torch.Tensor) -> torch.Tensor:
        """[n_pad, D] attraction of the CSR models from this rank's
        ``_edge_table_launch`` output: the hub's partial rows added into
        their owners, or under dp the ranks' slices gathered and put in
        place (``_dp_place``)."""
        n_pad = self.layout.n_pad
        if self.spmd.n_dp > 1:
            local = out.shape[0]
            g = torch.zeros((self.spmd.n_dp * local + 1, out.shape[1]),
                            dtype=out.dtype, device=out.device)
            dist.all_gather_into_tensor(g[:-1], out, group=self.spmd.dp)
            return self._dp_place(g)
        upd = out[:n_pad]
        if self._hub is not None:
            add_rows(upd[self._hub.start: self.layout.n],
                     self._hub.owner_local, out[n_pad:])
        return upd

    def _walk_launch(self, x, xg, walks, step, plain) -> torch.Tensor:
        """The walk attraction of this rank's rows (``_rank_rows``)."""
        fk = force_kernels
        r0, r1 = self._rank_rows()
        args = (self.model, x, xg, walks[r0:r1], self._walk_deg[r0:r1],
                self._all_rows[r0:r1], self.inv_deg, step)
        return (fk.ell_edge_force_plain(*args) if plain
                else fk.ell_edge_force(*args))

    def _rank_repulsion(self, x, xg, negs, step, plain) -> torch.Tensor:
        """The repulsion of this rank's rows: ``[n_pad, D]``, or under dp
        the ``[n_pad / dp, D]`` of its 1/dp (``_dp_rows``)."""
        fk, model = force_kernels, self.model
        r0, r1 = self._rank_rows()
        rows, deg = self._all_rows[r0:r1], self._ns_deg[r0:r1]
        if self.config.per_vertex_samples:
            # ns samples of each row's own (-bs 1, the JAX package's
            # [n_pad, ns] branch, sync.py:604-621)
            args = (model, x, xg, negs[r0:r1], deg, rows, step)
            return (fk.ell_sample_force_plain(*args) if plain
                    else fk.ell_sample_force(*args))
        # one ns-sample set per batch_size-row group — the reference's
        # option-5 sampling (sample/algorithms.cpp:577-586); a dp slice
        # starts from the group boundary at or before its first row, so the
        # kernel's groups are the layout's
        group = max(self.config.batch_size, 1)
        a0 = r0 // group * group
        sg = xg[negs[a0 // group: -(-r1 // group)].long()]  # [g, ns, D]
        return (fk.grouped_rep_force_plain if plain else fk.grouped_rep_force)(
            model, group, x[a0:r1], sg, step)[r0 - a0:]

    def _forces(self, x, xg, negs, walks, step, plain) -> torch.Tensor:
        """The iteration's update before the energy step: ``[n_pad, D]``
        attraction plus repulsion."""
        if self._tp:
            att, rep = self._tp_forces(x, xg, negs, walks, step, plain)
        elif walks is not None:
            att = self._walk_launch(x, xg, walks, step, plain)
        else:
            att = self._edge_table_launch(x, xg, step, plain)
        upd = (self._place_attraction(att) if walks is None
               else self._place_rows(att))
        if self._tp:
            return upd.add_(self._place_rows(rep))
        if self.config.per_vertex_samples and self.spmd.n_dp == 1:
            # path A: the kernel adds into the update
            args = (self.model, x, xg, negs, self._ns_deg, self._all_rows,
                    step)
            (force_kernels.ell_sample_force_plain if plain
             else force_kernels.ell_sample_force)(*args, out=upd,
                                                  accumulate=True)
            return upd
        return upd.add_(self._place_rows(
            self._rank_repulsion(x, xg, negs, step, plain)))

    def _iteration(self, x: torch.Tensor, negs: torch.Tensor,
                   walks: Optional[torch.Tensor], step: float,
                   plain: bool) -> torch.Tensor:
        # a bf16 X is its own replica: with gather_dtype f32 the JAX package
        # casts it up and straight back (sync.py:325-326), the same values
        xg = (x if self._gdt is None or x.dtype == torch.bfloat16
              else x.to(self._gdt))
        upd = self._forces(x, xg, negs, walks, step, plain)
        if self.model.update == "energy":
            fnorm = self._rsum(upd * upd)
            safe = torch.where(fnorm > 0, fnorm, 1.0)
            upd.mul_(torch.where(fnorm > 0, step / torch.sqrt(safe), 0.0))
        return x.add_(upd)

    def _step(self, it: int) -> float:
        return step_at(self.model, self.lr, it, self._dtype)

    # -- public API ----------------------------------------------------------

    def run_iteration(self, x: torch.Tensor, neg_ids, walks=None,
                      step: Optional[float] = None,
                      plain: bool = False) -> torch.Tensor:
        """One iteration on the padded X (``[n_pad, row_width]``) with
        injected negatives and, for walk models, injected walks, all
        relabeled ids.  The negatives are ``[n_pad,
        ns]``, one set per row, with ``per_vertex_samples``; else ``[ng,
        ns]``, one set per ``batch_size``-row group.  The walks are
        ``[n_pad, walk_length]``.  Updates ``x`` in place and returns it;
        raises on any other shape.

        ``plain=True`` computes the same iteration with the plain PyTorch
        versions of the kernels on ``x``'s device: the reference the
        kernels are checked against on the card.  The step is rounded to
        X's dtype first, as the JAX package rounds it.
        """
        want = (self.layout.n_pad, self.row_width)
        if tuple(x.shape) != want:
            raise ValueError(f"X {tuple(x.shape)} != {want} (the padded X of "
                             "init_embedding or pad_embedding)")
        negs = torch.as_tensor(neg_ids, device=self.device)
        if tuple(negs.shape) != self._neg_shape:
            raise ValueError(
                f"negatives {tuple(negs.shape)} != {self._neg_shape}")
        is_walk = self.model.attraction == "walk"
        if (walks is not None) != is_walk:
            raise ValueError(f"{self.model.name} takes "
                             f"{'walks' if is_walk else 'no walks'}")
        if walks is not None:
            walks = torch.as_tensor(walks, device=self.device)
            want = (self.layout.n_pad, self.config.walk_length)
            if tuple(walks.shape) != want:
                raise ValueError(f"walks {tuple(walks.shape)} != {want}")
            walks = walks.to(torch.int32).contiguous()
        step = round_to(self.lr if step is None else step, self._dtype)
        return self._iteration(x, negs.to(torch.int32).contiguous(), walks,
                               step, plain)

    def run_span(self, x: torch.Tensor, seed: int, num_iters: int,
                 iter_offset: int = 0) -> torch.Tensor:
        """Iterations ``[iter_offset, iter_offset + num_iters)`` of a run
        seeded with ``seed``, on the padded X in place; returns it.  Each
        iteration draws its negatives (``run_iteration``'s shape, ids in
        ``[0, n-1)``, the JAX package's range), then, for walk models, its
        walks (``draw_walks``), from one reused generator re-seeded from
        ``(seed, absolute iteration)``: spans compose into the straight
        run."""
        gen = self._span_gen
        hi = max(self.layout.n - 1, 1)
        is_walk = self.model.attraction == "walk"
        for it in range(iter_offset, iter_offset + num_iters):
            gen.manual_seed(iteration_seed(seed, it))
            negs = torch.randint(0, hi, self._neg_shape, generator=gen,
                                 dtype=torch.int32, device=self.device)
            walks = self.draw_walks(gen) if is_walk else None
            self._iteration(x, negs, walks, self._step(it), plain=False)
        return x

    def train(self, iters: int = 1200, seed: int = 1,
              x0: Optional[np.ndarray] = None) -> torch.Tensor:
        """Train ``iters`` iterations; returns the [n, dim] embedding in
        original id order, on the device.  The initial X comes from
        ``seed`` alone (unless ``x0``), each iteration's draws from
        ``(seed, iteration)`` (``run_span``)."""
        x = self.pad_embedding(x0) if x0 is not None else self.init_embedding(
            seed)
        t0 = time.perf_counter()
        self.run_span(x, seed, iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_train_seconds = time.perf_counter() - t0
        return self.unpad_embedding(x)
