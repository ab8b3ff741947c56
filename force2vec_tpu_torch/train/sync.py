"""Epoch-synchronous trainer: the sync schedule of ``force2vec_tpu``.

Semantically the reference's training loop at ``batch_size = n``: every
read in an iteration sees the iteration-start X and the update is applied
once at its end (sample/algorithms.cpp:569-639 with NUMSIZE = n).  One
iteration over the degree-sorted ELL layout (graphs/csr.py::SyncLayout):

1. ``xg``: the gather replica of X (``_replica``: X cast to
   ``gather_dtype``, bf16 or f16, for an f32 X; X itself when X is bf16 or
   f16, ``TrainConfig(dtype="bfloat16" | "float16")``: no cast; in
   ``run_span``'s iterations with a carried replica, below, the one the
   previous iteration's launches wrote);
2. attraction, by the edge kernel (``ell_edge_force``):

   * CSR models: one launch over the layout's work table
     (``edge_table``, every bucket, widest first), written straight into
     the update's rows; the hub bucket's virtual rows write partial sums to
     rows past ``n_pad``, which ``ops/segment.py::hub_owner_sum`` sums in
     row order into their owner rows (in f32, rounded once to X's dtype:
     the same bits on every run), and a width-0 entry zeroes the rows no
     bucket writes (the hub owners and padding);
   * walk models (``rwalk``): one launch over every table row, whose
     neighbours are the row's ``[walk_length]`` walk targets, drawn each
     iteration by the walk engine (``draw_walks``: a torch draw a step,
     then one ``walk_steps`` launch);

3. repulsion, added into the update:

   * group-shared negatives (the default): the ``[ng, ns, D]`` samples
     ``xg[negs]`` and one ``grouped_rep_force`` launch, whose mode
     (``rep_mode``, set by the constructor) says where its sum goes: at
     one rank with an ``add`` update, ``apply``: the launch also makes
     step 4, ``X += update + repulsion`` in place, the iteration's last
     launch (no ``add_`` remains); with an energy update, ``add`` into
     the update; under dp, ``store``, gathered over the ranks, and an
     ``add_``;
   * per-vertex negatives (``per_vertex_samples``, the CLI's ``-bs 1``):
     one ``ell_sample_force`` launch over every table row, with its
     ``[n_pad, ns]`` sample ids, gathered and added in the kernel;

4. ``X += update`` (or the energy-normalized update), in place, unless
   the repulsion applied it.

Steps 2 to 4 are one pass (``fused_apply``, decided by the constructor)
where the launch may write X while it runs: at one rank, a CSR model
with an ``add`` update (tdist, sigmoid and its table σ), and a replica
of its own (an f32 X beside a bf16 or f16 ``gather_dtype``).
``ell_edge_apply`` runs the edge kernel's launch over ``apply_table``
(``edge_table``'s entries); each row then sums its ns samples' repulsion
(row i takes negatives ``i // batch_size``, or its own with per-vertex
negatives) and writes ``X += att + rep`` from registers, so the update
never goes through device memory.  The hub's virtual rows store their
partial sums; their owners, whose x those rows read while the first
launch runs, are applied by a second launch over ``owner_table`` from
their ordered sums (``ops/segment.py::owner_sums``).  Every other
configuration runs the passes above.

The carried replica (``replica_carry``, decided by the constructor):
where one launch writes every row of an f32 X beside a bf16 or f16
replica at one rank (the fused pass, or the grouped repulsion's
``apply``), it also writes each new row, rounded to the replica's dtype,
into the replica the next iteration gathers from (``xg_next``), and step
1's cast leaves the iterations of ``run_span``.  The fused pass gathers
from its replica while it writes, so there are two, iteration ``it``
gathering from ``_replicas[it % 2]`` and writing the other (one graph a
parity, ``train/graph.py``); the grouped ``apply`` reads only its
samples, gathered before it runs, so one replica serves.  A span's first
iteration gathers from a carried replica only where the last span left
it on this X: the same tensor, at the same ``_version``, no launch that
writes X run since (``force_kernels.launch_counts``) and the span
starting at the iteration after the last; else X is cast into it before
the span (``_start_span``).  The counters ``replica.carried``
(iterations whose replica the previous iteration wrote) and
``replica.casts`` count both.  ``run_iteration`` casts as before and
leaves no carried replica.

X is f32, bf16 or f16 (``config.dtype``; ``force_kernels.X_DTYPES``, the
constructor refuses any other, naming it).  The update, ``inv_deg`` and
the step are in X's dtype, as in the JAX package (its ``sync.py:133-138,
:661, :712-714``): the kernels sum in f32 and round each force once to
X's dtype, and the adds and the apply run in X's dtype.  So does the
energy update's row norm, as JAX forms it: in f16 a row whose ``Σ upd²``
passes 65,504 gets an infinite norm, a step of 0, and stays put, exactly
where JAX's rows do.

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
  of every bucket (the hub's virtual rows too); one
  ``all_gather_into_tensor`` reassembles the slices, and a fixed
  permutation (``index_select``) puts them in row order.  The repulsion
  runs over the rank's 1/dp of the rows (``grouped_rep_force`` from the
  group boundary at or before the slice's first row, so that the
  kernel's groups are the layout's) and is gathered by a second
  ``all_gather_into_tensor``;
* tp: a pair's scalar is a sum over the tp ranks' columns, which the
  fused kernels cannot make; the forces run as the split-dim kernels
  instead, over the attraction's and the repulsion's work tables laid end
  to end (group-shared negatives as each row's own row of ns ids): one
  ``tp_pair_partial`` launch over both, one ``all_reduce`` of the scalars
  over tp (counted in ``force_kernels.launch_counts["tp_all_reduce"]``),
  then a ``tp_pair_force`` launch for each force on its slice of them.
  The JAX package runs that step in jnp ops (Pallas off at tp > 1).

``run_span`` and ``train()`` run one iteration a CUDA graph replay on a
card (``train/graph.py``, the counterpart of the JAX package's one-program
run), at one rank and on every dp × tp rank alike, the NCCL collectives
captured with the kernels: the step comes from a device buffer, which the
kernels read through a pointer, and the draws from the trainer's
generator inside the graph.  On the CPU they run the eager loop; on a
card over a group that is not NCCL's they raise
(``graph.check_capturable``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.graphs.csr import Graph, SyncLayout
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels
from force2vec_tpu_torch.ops.segment import (hub_owner_sum, owner_offsets,
                                             owner_sums)
from force2vec_tpu_torch.train.graph import (IterationGraph, StepBuffer,
                                             check_capturable)
from force2vec_tpu_torch.train.trainer import (TrainConfig, iteration_seed,
                                               round_to, step_at)
from force2vec_tpu_torch.utils.profiling import counter, span


@dataclasses.dataclass
class DeviceBucket:
    """One ELL bucket's index arrays on the device, as the per-bucket edge
    kernel call takes them (``SyncForce2Vec.device_buckets``)."""

    start: int  # first relabeled row of the bucket's update
    nbr: torch.Tensor  # [rows, width] int32
    deg: torch.Tensor  # [rows] int32
    xi_row: torch.Tensor  # [rows] int32 table row of each bucket row
    # hub: where each owner row's run of real virtual rows starts, and the
    # end of the last (ops/segment.py::owner_offsets); how many there are
    owner_off: Optional[torch.Tensor] = None  # [n - start + 1] int64
    n_virtual: int = 0


def _next_kw(xg_next) -> dict:
    """The launch's ``xg_next`` argument where a replica is carried, and
    none where it is not: the call the uncarried iteration always made."""
    return {} if xg_next is None else {"xg_next": xg_next}


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
    and dp.
    """

    @span("trainer.init")
    def __init__(
        self,
        graph: Graph,
        config: TrainConfig = TrainConfig(),
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        *,
        spmd: SpmdAxes = SpmdAxes(),
        device="cuda",
    ):
        self.graph = graph
        self.config = config
        self.device = torch.device(device)
        self.spmd = spmd
        self._dtype = getattr(torch, config.dtype)
        # the kernels (and their plain versions) hold X in f32, bf16 or f16
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
        # the fused pass (ell_edge_apply: attraction, repulsion and X's
        # update in one launch), where it may write X while its rows
        # gather: one rank, a model it takes (a CSR attraction and an add
        # update), and a replica of its own, an f32 X beside a 2-byte
        # gather dtype; else the separate passes
        self.fused_apply = (
            spmd.n_dp == 1 and spmd.n_tp == 1
            and force_kernels.applies(self.model)
            and self._dtype == torch.float32
            and self._gdt in (torch.bfloat16, torch.float16))
        # the group-shared repulsion's grouped_rep_force mode (None where
        # no grouped launch runs: tp, per-vertex negatives, the fused
        # pass): under dp each rank stores its slice, gathered over the
        # ranks; at one rank an energy update adds into the update, which
        # it normalises before X takes it, and any other applies X +=
        # update + repulsion
        self.rep_mode = (
            None if self._tp or config.per_vertex_samples or self.fused_apply
            else "store" if spmd.n_dp > 1
            else "add" if self.model.update == "energy" else "apply")
        # the carried replica (see the module's docstring): the replicas an
        # iteration's launches write in turn, 2 on the fused pass, 1 for
        # the grouped apply, 0 (a cast each iteration) elsewhere
        carries = self.fused_apply or (
            self.rep_mode == "apply" and self._dtype == torch.float32
            and self._gdt in (torch.bfloat16, torch.float16))
        self.replica_carry = (2 if self.fused_apply else 1) if carries else 0
        self._replicas = None  # allocated by the first span
        # (weak reference to X, _carry_key) that the last span left valid
        self._carry_mark = None
        self._span_first, self._span_cast = 0, False
        self.layout = SyncLayout.build(
            graph, min_width=min_width, hub_width=hub_width,
            row_align=row_align,
            widths=SyncLayout.widths_for(min_width, hub_width, "mult8"),
        )
        self.lr = config.resolve_lr(self.model)
        self._span_gen = torch.Generator(device=self.device)
        # run_span on a card: the iteration as a CUDA graph
        # (train/graph.py) reading the step from this buffer
        self._step_buf = StepBuffer(self.device)
        k = self.replica_carry
        self.span_graph = IterationGraph(
            self._prepare_iteration,
            [functools.partial(self._static_iteration, parity=q)
             for q in range(k)] if k else self._static_iteration,
            (self._span_gen,), start=self._start_span if k else None,
            end=self._end_span if k else None)

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
        self.edge_table = self._hub = None
        self.apply_table = self.owner_table = None
        if self.model.attraction == "walk":
            with span("walk.tables"):
                pool, base = build_walk_tables(lay)
                self.walk_pool = torch.as_tensor(pool, device=dev)
                # (deg, base) packed as one [n_pad, 2] table, so a walk step
                # fetches both with one row gather
                self.walk_db = torch.as_tensor(
                    np.stack([lay.deg.astype(np.int32), base], axis=1),
                    device=dev)
            self._walk_deg = torch.full((lay.n_pad,), config.walk_length,
                                        dtype=torch.int32, device=dev)
        else:  # walk attraction reads no bucket
            self._bucket_tables()
        if self._tp:
            self._tp_tables()

    def _bucket_tables(self) -> None:
        """``device_buckets``, the hub among them, and the attraction's
        work table (``edge_table``; under dp this rank's slices of it)."""
        lay, dev = self.layout, self.device
        for bi, b in enumerate(lay.buckets):
            if b.owners is not None:
                off = owner_offsets(b.owners - b.start, b.deg,
                                    lay.n - b.start)
                self.device_buckets.append(DeviceBucket(
                    start=b.start,
                    nbr=torch.as_tensor(b.nbr, device=dev),
                    deg=torch.as_tensor(b.deg, device=dev),
                    xi_row=torch.as_tensor(b.owners, device=dev),
                    owner_off=torch.as_tensor(off, device=dev),
                    n_virtual=int(off[-1])))
                continue
            # Only the bucket's real rows: its row_align padding overlaps
            # the next bucket's first rows.
            end = (lay.buckets[bi + 1].start if bi + 1 < len(lay.buckets)
                   else lay.n)
            real = end - b.start
            self.device_buckets.append(DeviceBucket(
                start=b.start, nbr=torch.as_tensor(b.nbr[:real], device=dev),
                deg=torch.as_tensor(b.deg[:real], device=dev),
                xi_row=torch.arange(b.start, end, dtype=torch.int32,
                                    device=dev)))
        self._hub = next((b for b in self.device_buckets
                          if b.owner_off is not None), None)
        if self.spmd.n_dp > 1:
            self._dp_edge_table()
        else:
            self.edge_table = self._edge_table()
        if self.fused_apply:
            self._fused_tables()

    def _tp_tables(self) -> None:
        """tp: the attraction's work table (``edge_table``, or the walks of
        this rank's rows) and the repulsion's (each of this rank's rows
        with its ns sample ids) laid end to end
        (``force_kernels.concat_work_tables``) as ``_tp_cat``, so that an
        iteration makes one ``tp_pair_partial`` launch and one
        ``all_reduce``.  ``_tp_att`` and ``_tp_rep`` are views of its
        parts, whose ids each iteration's walks and negatives overwrite."""
        fk, cfg = force_kernels, self.config
        r0, r1 = self._rank_rows()

        def per_row(width, deg):
            ids = torch.zeros((r1 - r0, width), dtype=torch.int32,
                              device=self.device)
            return fk.EdgeWorkTable.single(ids, deg[r0:r1],
                                           self._all_rows[r0:r1],
                                           self.layout.n_pad)

        att = (per_row(cfg.walk_length, self._walk_deg)
               if self.model.attraction == "walk" else self.edge_table)
        self._tp_cat, (self._tp_att, self._tp_rep) = fk.concat_work_tables(
            [att, per_row(cfg.ns, self._ns_deg)])

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

    def _fused_tables(self) -> None:
        """The fused pass's tables (``ell_edge_apply``), each a ``(table,
        flags)`` pair of ``force_kernels.apply_table``: ``apply_table``,
        ``edge_table``'s entries over its arrays, every bucket's rows and
        the padding rows applying their update to X, the hub's virtual rows
        storing their partial sums in rows [0, hub rows) of the launch's
        output; and with a hub ``owner_table``, its owner rows [hub.start,
        n) (no slot), which a second launch applies from their ordered
        sums.  The first launch leaves the owners out: the hub's virtual
        rows read their x while it runs.  Checks that the two launches
        apply every row of X exactly once."""
        fk, lay, hub = force_kernels, self.layout, self._hub
        entries, apply = [], []
        for rb, nb, ob, rows, width in self.edge_table.entries.tolist():
            if hub is not None and ob == lay.n_pad:  # the virtual rows
                entries.append((rb, nb, 0, rows, width))
                apply.append(False)
                continue
            if width == 0 and ob < lay.n:  # the owners, then the padding
                rb, rows, ob = rb + lay.n - ob, rows - (lay.n - ob), lay.n
            if rows:
                entries.append((rb, nb, ob, rows, width))
                apply.append(True)
        self.apply_table = fk.apply_table(
            self.edge_table, apply, entries,
            out_rows=hub.nbr.shape[0] if hub else 0)
        if hub is not None:
            m, dev = lay.n - hub.start, self.device
            self.owner_table = fk.apply_table(fk.EdgeWorkTable.single(
                torch.zeros((m, 0), dtype=torch.int32, device=dev),
                torch.zeros(m, dtype=torch.int32, device=dev),
                torch.arange(hub.start, lay.n, dtype=torch.int32,
                             device=dev), lay.n_pad), [True], out_rows=0)
        tables = [t for t in (self.apply_table, self.owner_table) if t]
        applied = torch.bincount(
            torch.cat([fk.applied_rows(*t) for t in tables]),
            minlength=lay.n_pad)
        if not bool((applied == 1).all()):
            raise ValueError(
                "the fused pass must apply every row of X once, but "
                f"{int((applied != 1).sum())} of {lay.n_pad} rows are "
                "applied another number of times")

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

    def _dp_edge_table(self) -> None:
        """This dp rank's work table: the rank's 1/dp slice of every
        bucket's padded rows (the hub's virtual rows too), written to
        consecutive rows of a local ``[L, D]`` output; and the fixed
        permutation of the gathered ``[dp·L + 1, D]`` slices (row dp·L kept
        0) into row order, ``_dp_src`` for the update's rows and
        ``_dp_hub_src`` for the hub's partial rows."""
        lay, dev, sp = self.layout, self.device, self.spmd
        dp, d = sp.n_dp, sp.dp_index
        parts, spans, off = [], [], 0
        on_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        for b in lay.buckets:
            per = b.count // dp
            rows = np.arange(d * per, (d + 1) * per)
            xi = (b.owners[rows] if b.owners is not None
                  else np.minimum(b.start + rows, lay.n_pad - 1))
            parts.append((on_dev(b.nbr[rows]), on_dev(b.deg[rows]),
                          on_dev(xi.astype(np.int32)), off))
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
        self._dp_src = torch.as_tensor(src, device=dev)
        # the hub's real virtual rows, in order (the padding rows add 0)
        self._dp_hub_src = (None if hub_src is None else torch.as_tensor(
            hub_src[: self._hub.n_virtual], device=dev))

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
        one from every table row (the JAX package's ``sync.py::_ell_walks``).
        Each step's r in [0, 2**31 - 1) is one ``[n_pad]`` draw from
        ``gen``, all drawn first, in step order; one ``walk_steps`` launch
        then walks them: from row i, step k moves to ``pool[base + r[k, i] %
        deg]`` of the current row's (deg, base), and rows of degree 0 (and
        padding rows) stay put."""
        n_pad = self.layout.n_pad
        r = torch.empty((self.config.walk_length, n_pad), dtype=torch.int32,
                        device=self.device)
        for rk in r:
            torch.randint(0, 2**31 - 1, (n_pad,), generator=gen, out=rk)
        return force_kernels.walk_steps(r, self.walk_db, self.walk_pool)

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
        fk.launch_counts["tp_all_reduce"] += 1
        force = fk.tp_pair_force_plain if plain else fk.tp_pair_force
        n_att = self._tp_att.nbr.shape[0]
        att = force(model, "edge", x, xg, self._tp_att, part[:n_att],
                    self.inv_deg, step)
        return att, force(model, "sample", x, xg, self._tp_rep, part[n_att:],
                          self.inv_deg, step)

    def _edge_table_launch(self, x, xg, step, plain) -> torch.Tensor:
        """This rank's attraction over ``edge_table``: ``[n_pad + hub rows,
        D]``, or under dp its slices' ``[L, D]`` (``_place_attraction``)."""
        fk = force_kernels
        launch = fk.ell_edge_force_table_plain if plain else (
            fk.ell_edge_force_table)
        return launch(self.model, x, xg, self.edge_table, self.inv_deg, step)

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
        summed into their owners (``hub_owner_sum``)."""
        upd = g.index_select(0, self._dp_src)
        hub = self._hub
        if hub is not None:
            hub_owner_sum(upd[hub.start: self.layout.n],
                          g.index_select(0, self._dp_hub_src), hub.owner_off)
        return upd

    def _place_attraction(self, out: torch.Tensor) -> torch.Tensor:
        """[n_pad, D] attraction of the CSR models from this rank's
        ``_edge_table_launch`` output: the hub's partial rows summed into
        their owners (``hub_owner_sum``), or under dp the ranks' slices
        gathered and put in place (``_dp_place``)."""
        n_pad = self.layout.n_pad
        if self.spmd.n_dp > 1:
            local = out.shape[0]
            g = torch.zeros((self.spmd.n_dp * local + 1, out.shape[1]),
                            dtype=out.dtype, device=out.device)
            dist.all_gather_into_tensor(g[:-1], out, group=self.spmd.dp)
            return self._dp_place(g)
        upd, hub = out[:n_pad], self._hub
        if hub is not None:
            hub_owner_sum(upd[hub.start: self.layout.n],
                          out[n_pad: n_pad + hub.n_virtual], hub.owner_off)
        return upd

    def _walk_launch(self, x, xg, walks, step, plain) -> torch.Tensor:
        """The walk attraction of this rank's rows (``_rank_rows``)."""
        fk = force_kernels
        r0, r1 = self._rank_rows()
        args = (self.model, x, xg, walks[r0:r1], self._walk_deg[r0:r1],
                self._all_rows[r0:r1], self.inv_deg, step)
        return (fk.ell_edge_force_plain(*args) if plain
                else fk.ell_edge_force(*args))

    def _rank_repulsion(self, x, xg, negs, step, plain, upd=None,
                        xg_next=None):
        """The repulsion of this rank's rows: ``[n_pad, D]``, or under dp
        the ``[n_pad / dp, D]`` of its 1/dp (``_dp_rows``).  Given
        ``upd`` (group-shared negatives at one rank, ``rep_mode`` ``add``
        or ``apply``), the launch adds it into ``upd`` or applies ``X +=
        upd + rep`` instead (and writes X's new rows into ``xg_next``,
        where given), and returns what it wrote."""
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
        rep = fk.grouped_rep_force_plain if plain else fk.grouped_rep_force
        if upd is None:
            return rep(model, group, x[a0:r1], sg, step)[r0 - a0:]
        if self.rep_mode == "add":
            return rep(model, group, x, sg, step, mode="add", out=upd)
        return rep(model, group, x, sg, step, mode="apply", upd=upd,
                   **_next_kw(xg_next))

    def _forces(self, x, xg, negs, walks, step, plain,
                xg_next=None) -> torch.Tensor:
        """The iteration's update before the energy step: ``[n_pad, D]``
        attraction plus repulsion; with ``rep_mode`` ``apply`` X has taken
        it already (the returned update is the attraction alone), and
        ``xg_next``, where given, X's new rows."""
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
        if self.rep_mode in ("add", "apply"):  # in the launch
            self._rank_repulsion(x, xg, negs, step, plain, upd=upd,
                                 xg_next=xg_next)
            return upd
        return upd.add_(self._place_rows(
            self._rank_repulsion(x, xg, negs, step, plain)))

    def _fused_iteration(self, x, xg, negs, step, plain,
                         xg_next=None) -> torch.Tensor:
        """The iteration as the fused pass (``fused_apply``): one
        ``ell_edge_apply`` launch over ``apply_table``, then with a hub one
        over ``owner_table``, its attraction the owners' ordered sums of
        the first launch's partial rows.  Returns X, updated in place (and
        ``xg_next``, where given, its replica: the two launches apply every
        row once)."""
        fk, hub = force_kernels, self._hub
        launch = fk.ell_edge_apply_plain if plain else fk.ell_edge_apply
        group = (1 if self.config.per_vertex_samples
                 else max(self.config.batch_size, 1))
        part = launch(self.model, x, xg, *self.apply_table, self.inv_deg,
                      negs, group, step, **_next_kw(xg_next))
        if hub is not None:
            launch(self.model, x, xg, *self.owner_table, self.inv_deg, negs,
                   group, step,
                   upd=owner_sums(part[: hub.n_virtual], hub.owner_off),
                   **_next_kw(xg_next))
        return x

    def _replica(self, x: torch.Tensor) -> torch.Tensor:
        """The iteration's gather table: an f32 X cast to ``gather_dtype``
        (X itself without one); a bf16 or f16 X itself, also beside an f32
        ``gather_dtype`` (the JAX package casts it up and straight back,
        ``sync.py:325-326``: the same values); beside the other 2-byte
        dtype, X's values rounded through it, held in X's dtype (JAX
        gathers those and casts them to X's dtype)."""
        gdt = self._gdt
        if gdt is None or gdt == x.dtype or (
                x.dtype != torch.float32 and gdt == torch.float32):
            return x
        if x.dtype == torch.float32:
            return x.to(gdt)
        return x.to(gdt).to(x.dtype)

    def _iteration(self, x: torch.Tensor, negs: torch.Tensor,
                   walks: Optional[torch.Tensor], step, plain: bool,
                   it: Optional[int] = None) -> torch.Tensor:
        """One iteration on X in place; ``step`` a float or the 0-d f32
        step buffer (the same bits either way).  ``it``: the iteration of
        a span with the carried replica, which gathers from
        ``_replicas[it % k]`` and writes ``_replicas[(it + 1) % k]``; None
        casts X (``_replica``)."""
        if it is None:
            xg, xg_next = self._replica(x), None
        else:
            k = self.replica_carry
            xg, xg_next = self._replicas[it % k], self._replicas[(it + 1) % k]
        if self.fused_apply:
            return self._fused_iteration(x, xg, negs, step, plain, xg_next)
        upd = self._forces(x, xg, negs, walks, step, plain, xg_next)
        if self.rep_mode == "apply":  # the repulsion launch applied X
            return x
        if self.model.update == "energy":
            fnorm = self._rsum(upd * upd)
            safe = torch.where(fnorm > 0, fnorm, 1.0)
            # step / √fnorm, rounded as torch rounds a float step over a
            # tensor, which a tensor step (the graph's) rounds the same way
            upd.mul_(torch.where(fnorm > 0,
                                 torch.sqrt(safe).reciprocal() * step, 0.0))
        return x.add_(upd)

    def _step(self, it: int) -> float:
        return step_at(self.model, self.lr, it, self._dtype)

    def _draw(self, gen: torch.Generator):
        """An iteration's negatives (``run_iteration``'s shape, ids in
        ``[0, n-1)``, the JAX package's range) and, for walk models, its
        walks (``draw_walks``), drawn from ``gen``."""
        negs = torch.randint(0, max(self.layout.n - 1, 1), self._neg_shape,
                             generator=gen, dtype=torch.int32,
                             device=self.device)
        walks = (self.draw_walks(gen) if self.model.attraction == "walk"
                 else None)
        return negs, walks

    def _prepare_iteration(self, seed: int, it: int) -> None:
        """The host's part of iteration ``it`` of a graph span: its step
        into the step buffer, the generator re-seeded for its draws."""
        self._step_buf.write(self._step(it))
        self._span_gen.manual_seed(iteration_seed(seed, it))

    def _static_iteration(self, x: torch.Tensor,
                          parity: Optional[int] = None) -> None:
        """The iteration a graph span captures: the draws from the
        re-seeded generator, the step from the step buffer; with the
        carried replica, one body a ``parity`` (the iteration mod
        ``replica_carry``)."""
        negs, walks = self._draw(self._span_gen)
        self._iteration(x, negs, walks, self._step_buf.tensor, plain=False,
                        it=parity)

    def _carry_key(self, x: torch.Tensor, it: int):
        """What a carried replica holds true at iteration ``it``: X's
        version and the launches that write X so far; None for a tensor
        that keeps no version (made under ``torch.inference_mode``)."""
        try:
            version = x._version
        except RuntimeError:
            return None
        counts = force_kernels.launch_counts
        return (version, it, counts["ell_edge_apply"],
                counts["grouped_rep_force"])

    def _start_span(self, x: torch.Tensor, it: int) -> None:
        """Before a span from iteration ``it`` with the carried replica:
        the replicas allocated (once: a graph holds their addresses), and
        the one iteration ``it`` gathers from made ``x.to(gather_dtype)``
        here, on the stream, unless the last span left it so on this X
        (``_carry_key``; counter ``replica.casts``)."""
        if self._replicas is None:
            self._replicas = [
                torch.empty((self.layout.n_pad, self.row_width),
                            dtype=self._gdt, device=self.device)
                for _ in range(self.replica_carry)]
        # a span that raises leaves no carried replica
        mark, self._carry_mark = self._carry_mark, None
        key = self._carry_key(x, it)
        self._span_cast = (mark is None or mark[0]() is not x or key is None
                           or key != mark[1])
        self._span_first = it
        if self._span_cast:
            self._replicas[it % self.replica_carry].copy_(x)
            counter("replica.casts", 1)

    def _end_span(self, x: torch.Tensor, it: int) -> None:
        """After a span whose next iteration is ``it``: its iterations
        but a first that ``_start_span`` cast for counted as carried
        (``replica.carried``), and what the replica ``it`` gathers from
        holds true."""
        counter("replica.carried", it - self._span_first - self._span_cast)
        self._carry_mark = (weakref.ref(x), self._carry_key(x, it))

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
        X's dtype first, as the JAX package rounds it.  The iteration
        gathers from a fresh cast of X, and the next ``run_span`` casts
        again (no carried replica outlives it).
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
        self._carry_mark = None  # X changes uncarried
        # in the step buffer: the kernels read the step from device memory
        step = self._step_buf.write(
            round_to(self.lr if step is None else step, self._dtype))
        return self._iteration(x, negs.to(torch.int32).contiguous(), walks,
                               step, plain)

    def run_span(self, x: torch.Tensor, seed: int, num_iters: int,
                 iter_offset: int = 0) -> torch.Tensor:
        """Iterations ``[iter_offset, iter_offset + num_iters)`` of a run
        seeded with ``seed``, on the padded X in place; returns it.  Each
        iteration draws its negatives, then, for walk models, its walks
        (``_draw``), from one reused generator re-seeded from ``(seed,
        absolute iteration)``: spans compose into the straight run.

        On a card the iteration is a CUDA graph (``span_graph``,
        ``train/graph.py``), captured once per X and replayed once per
        iteration, its dp and tp collectives with it (every rank captures
        the same iteration); on the CPU, the eager loop
        (``_run_span_eager``).  Raises ``RuntimeError`` on a card under a
        group that is not NCCL's (``graph.check_capturable``)."""
        if self.device.type != "cuda":
            return self._run_span_eager(x, seed, num_iters, iter_offset)
        sp = self.spmd
        check_capturable(sp.dp if sp.n_dp > 1 else None,
                         sp.tp if sp.n_tp > 1 else None)
        return self.span_graph.run(x, seed, num_iters, iter_offset)

    def _run_span_eager(self, x: torch.Tensor, seed: int, num_iters: int,
                        iter_offset: int = 0) -> torch.Tensor:
        """``run_span`` as a Python loop of eager launches, each step a
        float: the reference the graph is held against (with the carried
        replica where the graph carries it)."""
        gen, carry = self._span_gen, self.replica_carry and num_iters > 0
        if carry:
            self._start_span(x, iter_offset)
        for it in range(iter_offset, iter_offset + num_iters):
            gen.manual_seed(iteration_seed(seed, it))
            negs, walks = self._draw(gen)
            self._iteration(x, negs, walks, self._step(it), plain=False,
                            it=it if carry else None)
        if carry:
            self._end_span(x, iter_offset + num_iters)
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
