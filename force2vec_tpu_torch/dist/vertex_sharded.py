"""Vertex-sharded training: X partitioned over P ranks, one per card, with
a static halo exchange — the schedule for graphs whose embedding table
outgrows one card.

The port of ``force2vec_tpu/dist/vertex_sharded.py``, on
``torch.distributed`` (NCCL on the card, gloo on the CPU).  Rank p holds
the ``n_loc`` rows the layout (``graphs/partition.py``) deals it and, per
iteration:

1. issues the exchange of the rows other ranks read, from ``x_loc``: the
   cold tier as one ``all_to_all_single`` of ``[P·H, D]`` (send buffer
   ``x_loc[send_idx]``) and the hot tier as one
   ``all_gather_into_tensor`` of ``[P·Hh, D]``, both asynchronous, into
   the tail of the ``[x_loc | hot | halo]`` table;
2. while they fly: the halo-free slabs, one ``ell_edge_force`` work-table
   launch gathering from ``x_loc``, and the repulsion against a global
   pool of sample rows: ``grouped_rep_force`` with one group of ``n_loc``
   rows (``shared``) or ``ell_sample_force`` over each row's ``ns``
   choices among ``neg_pool`` rows (``pool``);
3. waits for the exchange, then the halo-dependent slabs: one work-table
   launch gathering from ``[x_loc | hot | halo]``; the hub's partial rows
   are summed in row order into their owners
   (``ops/segment.py::hub_owner_sum``);
4. applies the update to its own rows: no collective.

The pool rows are a masked gather of the rows each rank owns and one
``all_reduce``; their ids come from a generator seeded alike on every
rank.  At P = 1 no collective runs.  X, the ``[x_loc | hot | halo]``
table, the exchange's buffers, the pool rows and the update are in X's
dtype (``config.dtype``: f32, bf16 or f16, ``force_kernels.X_DTYPES``),
as in the JAX package: ``gather_dtype`` is ignored.

For ``rwalk`` the walk engine runs distributed (per step an
``all_gather_into_tensor`` of the int32 frontier and an ``all_reduce`` of
the answers), and the walk targets' rows are fetched by a ring of P−1
``batch_isend_irecv`` rotations of ``x_loc`` or by a request/response
``all_to_all_single`` pair at a static per-peer cap C (``walk_fetch``);
the attraction is one ``ell_edge_force`` launch over the fetched table.

``halo_stale`` pipelines the exchange by an iteration: iteration i issues
its exchange and consumes the one issued at i−1, so nothing in the
iteration waits on the collective in flight (the reference's own
cross-batch staleness, sample/algorithms.cpp:629-639).  Each ``run_span``
primes it with its first X's exchange, so a span's first iteration is
exact, as each call of the JAX package's loop primes its carry; a run in
spans equals the eager loop (``_run_span_eager``) in the same spans.

``run_span`` and ``train()`` run one iteration a CUDA graph replay on a
card (``train/graph.py::IterationGraph``, the counterpart of the JAX
package's ``shard_map`` jitted once per trip count), at P = 1 and at any
P on an NCCL group, whose collectives the graph captures with the
kernels; the step comes from a device buffer (``StepBuffer``) and the
draws from the runner's two generators, re-seeded before each replay.  A
graph cannot swap host references, so ``halo_stale`` holds two static
``[x_loc | hot | halo]`` tables and one graph per parity: iteration i
issues its exchange into table i mod 2 and reads table (i − 1) mod 2, and
the exchange it issues ends within its replay (the overlap across
iterations goes; what each iteration reads stays).  On the CPU they run
the eager loop; on a card over a gloo group they raise
(``graph.check_capturable``).

X's rows, the ``[x_loc | hot | halo]`` table and the exchange's buffers
are ``row_width`` = ``padded_dim(dim)`` wide, the padding columns 0, as
the sync schedule holds X (``train/sync.py``); the public shape stays
``[n, dim]``.

Semantics in ``shared`` mode are the sync schedule's with every row
sharing the pool (``SyncForce2Vec`` with the same negatives for every
group); the tests hold this module to the JAX package's
``VertexShardedForce2Vec`` on injected draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from force2vec_tpu_torch.graphs.csr import Graph
from force2vec_tpu_torch.graphs.partition import VertexShardLayout
from force2vec_tpu_torch.models.forces import ForceModel, get_model
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.ops.segment import hub_owner_sum, owner_offsets
from force2vec_tpu_torch.train.graph import (IterationGraph, StepBuffer,
                                             check_capturable)
from force2vec_tpu_torch.train.trainer import (TrainConfig, iteration_seed,
                                               round_to, step_at)
from force2vec_tpu_torch.utils.profiling import span

_INT32_MAX = 2**31 - 1
_INIT_CHUNK = 1 << 20  # rows of the initial X drawn at a time


def build_walk_tables(lay: VertexShardLayout, p: int):
    """Shard p's flat walk tables, int32: ``pool``, every bucket's
    ``[count, width]`` neighbour rectangle concatenated, and ``base``,
    each local row's offset into it, so that a walk step's (row, slot) →
    neighbour lookup is ``pool[base[row] + slot]`` (exact for hubs: an
    owner's virtual rows are consecutive); and ``first``, each hub owner
    offset's first virtual row.  Raises ``ValueError`` when the pool
    holds 2³¹ slots or more, which int32 offsets cannot address."""
    total = sum(b.count * b.width for b in lay.buckets)
    if total >= 2**31:
        raise ValueError(f"walk pool of {total} slots does not fit int32 "
                         "offsets")
    hub = lay.buckets[-1] if lay.buckets and lay.buckets[-1].owners is not None \
        else None
    first = None
    if hub is not None:
        first = np.zeros(max(hub.real_count, 1), dtype=np.int64)
        u, idx = np.unique(hub.owners[p], return_index=True)
        first[u] = idx
    base = np.zeros(lay.n_loc, dtype=np.int64)
    off = 0
    for b in lay.buckets:
        if b.owners is None:
            rows = np.arange(b.count, dtype=np.int64)
            base[b.start_local + rows] = off + rows * b.width
        else:
            rc = max(b.real_count, 1)
            cols = np.minimum(b.start_local + np.arange(rc), lay.n_loc - 1)
            base[cols] = off + first[:rc] * b.width
        off += b.count * b.width
    pool = (np.concatenate([b.nbr[p].reshape(-1) for b in lay.buckets])
            if lay.buckets else np.zeros(1, dtype=np.int32))
    return pool.astype(np.int32), base.astype(np.int32), first


@dataclasses.dataclass
class ShardTables:
    """One shard's device arrays for the local update (``ShardTables.build``):
    its two work tables and the indices of its rows in the exchange."""

    n_loc: int
    table_rows: int  # rows of [x_loc | hot | halo]: n_loc + P·Hh + P·H
    free: Optional[fk.EdgeWorkTable]  # halo-free slabs + zero rows, on x_loc
    dep: Optional[fk.EdgeWorkTable]  # halo-dependent slabs + hub, on the table
    out_rows: int  # n_loc + the hub's virtual rows
    inv_deg: torch.Tensor  # [n_loc] 1 / (deg + 1), in X's dtype
    send_idx: torch.Tensor  # [P·H] int32 local rows sent, peer by peer
    hot_send: torch.Tensor  # [Hh] int32 local rows of the hot tier
    rows: torch.Tensor  # [n_loc] int32 0..n_loc-1
    hub_start: int = 0
    # where each owner row's run of the hub's real virtual rows starts, from
    # hub_start on, and the end of the last (ops/segment.py::owner_offsets);
    # how many there are
    hub_off: Optional[torch.Tensor] = None  # [n_loc - hub_start + 1] int64
    hub_virtual: int = 0

    @staticmethod
    def build(lay: VertexShardLayout, p: int, device,
              dtype: torch.dtype = torch.float32) -> "ShardTables":
        """Shard p's tables, ``inv_deg`` in X's ``dtype``.  The free table
        writes the free slabs' rows of the update and zeroes the rows no
        slab writes (the hub's owner rows and the padding); the dep table
        writes the dep slabs' rows and the hub's virtual rows, past
        ``n_loc``.  Both are checked once (``edge_work_table``): x_loc's
        rows for every slab row, and the gather table's rows for every
        real neighbour slot."""
        dev = torch.device(device)
        P, n_loc = lay.n_shards, lay.n_loc
        T = n_loc + P * lay.hot_width + P * lay.halo_width

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        free, dep = [], []
        hub = None
        for b in lay.buckets:
            if b.owners is not None:
                hub = b
                continue
            rows = np.arange(b.start_local, b.start_local + b.count,
                             dtype=np.int32)
            (free if b.phase == "free" else dep).append(
                (t(b.nbr[p]), t(b.deg[p]), t(rows), b.start_local))
        hub_rows = 0
        zero_from = n_loc
        hub_off, hub_virtual = None, 0
        if hub is not None:
            off = owner_offsets(hub.owners[p], hub.deg[p],
                                n_loc - hub.start_local)
            hub_off, hub_virtual = t(off), int(off[-1])
            hub_rows = hub.count
            zero_from = hub.start_local
            dep.append((t(hub.nbr[p]), t(hub.deg[p]),
                        t(hub.owners[p] + hub.start_local, torch.int32),
                        n_loc))
        else:
            zero_from = max([b.start_local + b.count for b in lay.buckets]
                            + [0])
        if zero_from < n_loc:
            z = n_loc - zero_from
            free.append((torch.zeros((z, 0), dtype=torch.int32, device=dev),
                         torch.zeros(z, dtype=torch.int32, device=dev),
                         torch.arange(zero_from, n_loc, dtype=torch.int32,
                                      device=dev), zero_from))
        out_rows = n_loc + hub_rows

        def table(parts, n_gather):
            return (fk.edge_work_table(parts, n_loc, out_rows,
                                       n_gather=n_gather, partial=True)
                    if parts else None)

        return ShardTables(
            n_loc=n_loc, table_rows=T, free=table(free, n_loc),
            dep=table(dep, T), out_rows=out_rows,
            inv_deg=t(1.0 / (lay.deg_loc[p].astype(np.float64) + 1.0),
                      dtype),
            send_idx=t(lay.send_idx[p].reshape(-1)),
            hot_send=t(lay.hot_send[p]),
            rows=torch.arange(n_loc, dtype=torch.int32, device=dev),
            hub_start=hub.start_local if hub is not None else 0,
            hub_off=hub_off, hub_virtual=hub_virtual)


def _in_range(ids: torch.Tensor, hi: int) -> bool:
    """Every id in [0, hi) (a read back to the host)."""
    return ids.numel() == 0 or (int(ids.min()) >= 0 and int(ids.max()) < hi)


def _repulsion(model: ForceModel, t: ShardTables, x, pool_rows, step,
               choice, plain: bool) -> torch.Tensor:
    """[n_loc, D]: every row against the S pool rows (``choice`` None:
    one group of n_loc rows, ``grouped_rep_force``) or against its ns
    choices among them (``ell_sample_force``)."""
    if choice is None:
        sg = pool_rows[None]  # [1, S, D]
        return (fk.grouped_rep_force_plain if plain
                else fk.grouped_rep_force)(model, t.n_loc, x, sg, step)
    ns_deg = torch.full((t.n_loc,), choice.shape[1], dtype=torch.int32,
                        device=x.device)
    if plain:
        return fk.ell_sample_force_plain(model, x, pool_rows, choice, ns_deg,
                                         t.rows, step)
    return fk.ell_sample_force(model, x, pool_rows, choice, ns_deg, t.rows,
                               step)


def shard_free_part(model: ForceModel, t: ShardTables, x, pool_rows, step,
                    choice=None, plain: bool = False):
    """What a shard computes before its halo arrives: the free slabs and
    the zero rows into a new ``[out_rows, D]`` update, and the
    repulsion.  Returns ``(upd, rep)``.  ``plain``: the plain PyTorch
    versions of the kernels, on x's device."""
    upd = torch.empty((t.out_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    if t.free is not None:
        if plain:
            fk.ell_edge_force_table_plain(model, x, x, t.free, t.inv_deg,
                                          step, out=upd)
        else:
            fk.ell_edge_force_table(model, x, x, t.free, t.inv_deg, step,
                                    out=upd)
    rep = _repulsion(model, t, x, pool_rows, step, choice, plain)
    return upd, rep


def shard_dep_part(model: ForceModel, t: ShardTables, x, xtab, upd, rep,
                   step, plain: bool = False) -> torch.Tensor:
    """What a shard computes once its halo is in ``xtab`` (``[x_loc | hot |
    halo]``): the dep slabs and the hub's virtual rows, the hub partials
    summed into their owners (``hub_owner_sum``, which stores the sums),
    plus the repulsion.  Returns the ``[n_loc, D]`` update (a view of
    ``upd``)."""
    if t.dep is not None:
        if plain:
            fk.ell_edge_force_table_plain(model, x, xtab, t.dep, t.inv_deg,
                                          step, out=upd)
        else:
            fk.ell_edge_force_table(model, x, xtab, t.dep, t.inv_deg, step,
                                    out=upd)
    loc = upd[: t.n_loc]
    if t.hub_off is not None:
        hub_owner_sum(loc[t.hub_start:],
                      upd[t.n_loc: t.n_loc + t.hub_virtual], t.hub_off)
    return loc.add_(rep)


def apply_update(model: ForceModel, x, upd, step) -> torch.Tensor:
    """``x += upd``, or the energy-normalised update (per row,
    sample/algorithms.cpp:224-239), in place.  ``step``: a float or the
    0-d f32 step buffer."""
    if model.update == "energy":
        fnorm = torch.sum(upd * upd, dim=-1, keepdim=True)
        safe = torch.where(fnorm > 0, fnorm, 1.0)
        # step / √fnorm, rounded as torch rounds a float step over a
        # tensor, which a tensor step (the graph's) rounds the same way
        upd.mul_(torch.where(fnorm > 0,
                             torch.sqrt(safe).reciprocal() * step, 0.0))
    return x.add_(upd)


class VertexShardedForce2Vec:
    """Train with X vertex-sharded over the ranks of ``group`` (default:
    the default process group, or this process alone), one card each.

    Every rank builds the runner with the same arguments and calls the same
    methods in the same order: most of them run collectives.
    """

    @span("trainer.init")
    def __init__(
        self,
        graph: Graph,
        config: TrainConfig = TrainConfig(),
        group=None,
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        sampling: str = "shared",
        neg_pool: int = 128,
        walk_fetch: str = "auto",
        walk_fetch_cap: Optional[int] = None,
        walk_fetch_slack: float = 1.5,
        halo_stale: bool = False,
        *,
        device="cuda",
    ):
        self.graph = graph
        self.config = config
        self.device = dev = torch.device(device)
        self._dtype = getattr(torch, config.dtype)
        # the kernels (and their plain versions) hold X in f32, bf16 or f16
        fk.check_x_dtype(self._dtype)
        self.model = get_model(config.model, sm_table=config.sm_table)
        if self.model.repulsion == "all":
            raise ValueError("tdist_exact runs the batch trainer, not "
                             "vertex-sharded")
        if sampling not in ("shared", "pool"):
            raise ValueError(f"sampling must be 'shared' or 'pool', got "
                             f"{sampling!r}")
        if dev.type == "cuda":
            fk.check_kernel_dim(config.dim)
        # X's row width: the dim and 0 columns up to the kernels' alignment
        self.row_width = fk.padded_dim(config.dim)
        self.group = group
        in_group = dist.is_initialized()
        self.P = dist.get_world_size(group) if in_group else 1
        self.rank = dist.get_rank(group) if in_group else 0
        self._ranks = ([dist.get_global_rank(group, r) if group is not None
                        else r for r in range(self.P)] if in_group else [0])
        self.sampling = sampling
        self.neg_pool = int(neg_pool)
        # walk models have no standing halo: the flag is ignored there
        self.halo_stale = bool(halo_stale) and self.model.attraction != "walk"
        self.lr = config.resolve_lr(self.model)

        self.layout = lay = VertexShardLayout.build(
            graph, self.P, min_width=min_width, hub_width=hub_width,
            row_align=row_align)
        p, n_loc = self.rank, lay.n_loc
        self.tables = ShardTables.build(lay, p, dev, self._dtype)
        self._shard_of = torch.as_tensor(lay.shard_of, device=dev)
        self._lrow_of = torch.as_tensor(lay.lrow_of, device=dev)
        own_g = np.flatnonzero(lay.shard_of == p)
        self._own_ids = torch.as_tensor(lay.perm[own_g].astype(np.int64),
                                        device=dev)
        self._own_lrows = torch.as_tensor(lay.lrow_of[own_g].astype(np.int64),
                                          device=dev)
        self._gmap_loc = torch.as_tensor(lay.gmap[p, :n_loc], device=dev)
        self._span_gen = torch.Generator(device=dev)
        self._choice_gen = torch.Generator(device=dev)
        self._dropped = torch.zeros((), dtype=torch.int64, device=dev)
        # run_span on a card: the iteration as a CUDA graph (train/graph.py)
        # reading the step from this buffer; halo_stale: one graph per
        # parity over the two static tables of _stale_tables
        self._step_buf = StepBuffer(dev)
        self._stale_tabs = None
        self._meter = None
        self.span_graph = IterationGraph(
            self._prepare_iteration,
            ((functools.partial(self._static_iteration, parity=0),
              functools.partial(self._static_iteration, parity=1))
             if self.halo_stale else self._static_iteration),
            (self._span_gen, self._choice_gen), start=self._start_span)
        self.walk_fetch, self.walk_cap = "ring", 0
        if self.model.attraction == "walk":
            pool, base, _ = build_walk_tables(lay, p)
            self._walk_pool = torch.as_tensor(pool, device=dev)
            self._walk_base = torch.as_tensor(base, device=dev)
            self._gmap = torch.as_tensor(lay.gmap[p], device=dev)
            self._deg_loc = torch.as_tensor(lay.deg_loc[p], device=dev)
            if walk_fetch not in ("ring", "a2a", "auto"):
                raise ValueError(f"walk_fetch must be ring/a2a/auto, got "
                                 f"{walk_fetch!r}")
            cap = walk_fetch_cap
            if walk_fetch != "ring" and self.P > 1:
                if cap is None:
                    cap = self._preflight_walk_cap(slack=walk_fetch_slack)
                if walk_fetch == "auto":
                    walk_fetch = "a2a" if cap < n_loc else "ring"
            else:
                walk_fetch = "ring"
            self.walk_fetch = walk_fetch
            self.walk_cap = int(cap) if walk_fetch == "a2a" else 0

    # -- observability ---------------------------------------------------------

    @property
    def meter(self):
        """A ``utils.profiling.Meter`` that times the iteration's phases
        (pool, exchange, free, dep, apply), or None.  Setting it drops the
        captured graph: the next span captures its phases' events, and
        every replay adds their times."""
        return self._meter

    @meter.setter
    def meter(self, meter) -> None:
        self._meter = meter
        self.span_graph.meter = meter
        self.span_graph.reset()

    def _phase(self, name: str):
        return (self._meter.phase(name) if self._meter is not None
                else contextlib.nullcontext())

    def walk_overflow_dropped(self) -> int:
        """Total a2a walk-fetch slots dropped past the cap over every
        iteration so far, over all ranks (a collective: every rank calls
        it)."""
        d = self._dropped.clone()
        if self.P > 1:
            dist.all_reduce(d, group=self.group)
        return int(d)

    def _preflight_walk_cap(self, iters: int = 4, slack: float = 1.5) -> int:
        """Host-side sizing of the a2a walk-fetch cap: ``iters`` rounds of
        uniform-neighbour walks (the engine's semantics), the worst
        per-(shard, peer) deduplicated remote-row need, times ``slack``,
        rounded up to 8.  The cap holds for every iteration, so the worst
        case, not the mean, sizes it."""
        lay, g = self.layout, self.graph
        wl = self.config.walk_length
        rng = np.random.default_rng(97)
        rowptr, colids = g.rowptr, g.colids
        deg = (rowptr[1:] - rowptr[:-1]).astype(np.int64)
        owner_v = lay.shard_of[lay.inv_perm]  # owner of original id v
        n, P = g.n, self.P
        worst = 0
        for _ in range(iters):
            cur = np.arange(n, dtype=np.int64)
            tgts = []
            for _s in range(wl):
                d = deg[cur]
                slot = rng.integers(0, 1 << 31, size=n) % np.maximum(d, 1)
                nxt = colids[rowptr[cur] + np.minimum(slot,
                                                      np.maximum(d - 1, 0))]
                cur = np.where(d > 0, nxt, cur)
                tgts.append(cur)
            tgt = np.stack(tgts, axis=1)  # [n, wl] original ids
            t_owner = owner_v[tgt]
            w_owner = np.broadcast_to(owner_v[:, None], tgt.shape)
            rem = t_owner != w_owner
            enc = ((w_owner[rem].astype(np.int64) * P + t_owner[rem]) * n
                   + tgt[rem])
            pairs = np.unique(enc) // n  # one entry per (walker, owner, row)
            if pairs.size:
                worst = max(worst, int(np.bincount(pairs,
                                                   minlength=P * P).max()))
        cap = int(-(-int(worst * slack) // 8) * 8)
        return max(8, min(cap, lay.n_loc))

    def comm_stats(self) -> dict:
        """Per-iteration communication of one rank (rows are
        ``[row_width]``-wide embedding rows of X's dtype unless the key says
        id words, 4 bytes each)."""
        lay, cfg = self.layout, self.config
        P = lay.n_shards
        rows = {
            # cold tier: all_to_all sends (P-1) of its P H-row slabs
            "cold_alltoall_rows_sent": (P - 1) * lay.halo_width,
            # hot tier: contribute Hh rows, receive (P-1)·Hh
            "hot_allgather_rows_recv": (P - 1) * lay.hot_width,
            # the pool: one [S, D] all_reduce
            "pool_psum_rows": (cfg.ns if self.sampling == "shared"
                               else self.neg_pool),
        }
        if self.model.attraction == "walk":
            ids = 2 * cfg.walk_length * (P - 1) * lay.n_loc
            if self.walk_fetch == "a2a":
                rows["rwalk_a2a_rows_sent"] = (P - 1) * self.walk_cap
                rows["rwalk_id_words_sent"] = (P - 1) * self.walk_cap + ids
            else:
                rows["rwalk_ring_rows_sent"] = (P - 1) * lay.n_loc
                rows["rwalk_id_words_sent"] = ids
        emb_rows = sum(v for k, v in rows.items()
                       if k.endswith(("_rows_sent", "_rows_recv", "_rows")))
        return {**rows,
                "bytes_per_iter_per_shard":
                emb_rows * self.row_width * self._dtype.itemsize
                + rows.get("rwalk_id_words_sent", 0) * 4,
                "layout": dict(lay.stats)}

    # -- embedding layout ----------------------------------------------------

    def init_embedding(self, seed: int = 1) -> torch.Tensor:
        """This rank's ``[n_loc, row_width]`` rows of an ``[n, dim]``
        uniform init in original id order ([0, 1) or [-1, 1) by the model),
        drawn in f32 in chunks of rows from one generator seeded with
        ``seed`` on every rank, then rounded once to X's dtype: the same X
        for any P and row width.  Padding rows are 0
        (-1 with the [-1, 1) init); padding columns 0."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n, dim = self.graph.n, self.config.dim
        x = torch.zeros((self.layout.n_loc, self.row_width),
                        device=self.device)
        ids, lrows = self._own_ids, self._own_lrows
        for c0 in range(0, n, _INIT_CHUNK):
            c1 = min(n, c0 + _INIT_CHUNK)
            chunk = torch.rand((c1 - c0, dim), generator=gen,
                               device=self.device)
            sel = (ids >= c0) & (ids < c1)
            x[lrows[sel], :dim] = chunk[ids[sel] - c0]
        if self.model.init != "uniform01":
            x[:, :dim].mul_(2.0).sub_(1.0)
        return x.to(self._dtype)

    def pad_embedding(self, x) -> torch.Tensor:
        """Host or device ``[n, dim]`` in original id order → this rank's
        ``[n_loc, row_width]`` rows (padding rows and columns 0)."""
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        if tuple(x.shape) != (self.graph.n, self.config.dim):
            raise ValueError(f"X {tuple(x.shape)} != "
                             f"{(self.graph.n, self.config.dim)}")
        out = torch.zeros((self.layout.n_loc, self.row_width),
                          dtype=self._dtype, device=self.device)
        out[self._own_lrows, : self.config.dim] = x[self._own_ids]
        return out

    def unpad_embedding(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The ranks' ``[n_loc, row_width]`` rows → ``[n, dim]`` in original
        id order, gathered to rank 0 (a collective); None on the other
        ranks."""
        lay = self.layout
        x = x[:, : self.config.dim].contiguous()
        if self.P > 1:
            parts = ([torch.empty_like(x) for _ in range(self.P)]
                     if self.rank == 0 else None)
            dist.gather(x, parts, dst=self._ranks[0], group=self.group)
            if self.rank != 0:
                return None
            x = torch.cat(parts)
        g = lay.inv_perm[np.arange(lay.n)]
        src = lay.shard_of[g].astype(np.int64) * lay.n_loc + lay.lrow_of[g]
        return x[torch.as_tensor(src, device=x.device)]

    # -- the exchange ------------------------------------------------------------

    def _issue_exchange(self, x, tab) -> list:
        """Issue both tiers from ``x``'s rows into ``tab``'s hot and halo
        rows; returns the pending works, each with its send buffer, which
        must live until the work is waited on.  At P = 1 the rows are
        copied and nothing is pending."""
        t, P, lay = self.tables, self.P, self.layout
        a = t.n_loc + P * lay.hot_width
        send = x.index_select(0, t.send_idx)  # [P·H, D]
        hot_mine = x.index_select(0, t.hot_send)  # [Hh, D]
        if P == 1:
            tab[t.n_loc: a].copy_(hot_mine)
            tab[a:].copy_(send)
            return []
        return [(dist.all_to_all_single(tab[a:], send, group=self.group,
                                        async_op=True), send),
                (dist.all_gather_into_tensor(tab[t.n_loc: a], hot_mine,
                                             group=self.group,
                                             async_op=True), hot_mine)]

    @staticmethod
    def _wait(pending: list) -> None:
        for work, _ in pending:
            work.wait()
        pending.clear()

    def _new_table(self, x) -> torch.Tensor:
        return torch.empty((self.tables.table_rows, x.shape[1]),
                           dtype=x.dtype, device=x.device)

    # -- the walk engine and the walk fetch -----------------------------------

    def draw_walks(self, gen: torch.Generator) -> torch.Tensor:
        """``[n_loc, walk_length]`` int32 uniform walks from this rank's
        rows, as global (degree-sorted) ids, -1 on padding rows.  Per
        step, the frontier of every rank is all-gathered (int32 ids),
        each rank answers the queries for the rows it owns from its own
        tables, and one ``all_reduce`` merges the answers.  ``gen`` must
        be seeded alike on every rank: each step draws ``P·n_loc`` slots
        from it."""
        lay, P, p = self.layout, self.P, self.rank
        n_loc, n = lay.n_loc, lay.n
        f = self._gmap_loc.clamp(0, n - 1)
        valid = self._gmap_loc >= 0
        frontier = torch.empty(P * n_loc, dtype=torch.int32,
                               device=self.device)
        steps = []
        for _ in range(self.config.walk_length):
            r = torch.randint(0, _INT32_MAX, (P * n_loc,), generator=gen,
                              dtype=torch.int32, device=self.device)
            if P > 1:
                dist.all_gather_into_tensor(frontier, f, group=self.group)
                F = frontier
            else:
                F = f
            mine = self._shard_of.index_select(0, F) == p
            lr = self._lrow_of.index_select(0, F).clamp(0, n_loc - 1)
            d = self._deg_loc.index_select(0, lr)
            pos = self._walk_base.index_select(0, lr) + r % d.clamp(min=1)
            nxt = self._gmap.index_select(0, self._walk_pool.index_select(
                0, pos.clamp(0, self._walk_pool.shape[0] - 1)))
            ans = torch.where(mine, torch.where(d > 0, nxt, F), 0)
            if P > 1:
                dist.all_reduce(ans, group=self.group)
            f = ans[p * n_loc: (p + 1) * n_loc].contiguous()
            steps.append(torch.where(valid, f, -1))
        return torch.stack(steps, dim=1)

    def _ring_fetch(self, x, walks):
        """The whole table by P−1 ring rotations of ``x_loc``: block r of
        the result holds the rows of rank (p − r) mod P.  Returns (table,
        neighbour ids into it)."""
        P, p, n_loc = self.P, self.rank, self.layout.n_loc
        tc = walks.long().clamp(min=0)
        owner = self._shard_of[tc]
        lr = self._lrow_of[tc]
        nbr = ((p - owner) % P) * n_loc + lr
        if P == 1:
            return x, nbr.to(torch.int32)
        tab = torch.empty((P * n_loc, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        tab[:n_loc].copy_(x)
        nxt, prv = self._ranks[(p + 1) % P], self._ranks[(p - 1) % P]
        for r in range(1, P):
            send, recv = tab[(r - 1) * n_loc: r * n_loc], \
                tab[r * n_loc: (r + 1) * n_loc]
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, send, nxt, self.group),
                    dist.P2POp(dist.irecv, recv, prv, self.group)]):
                req.wait()
        return tab, nbr.to(torch.int32)

    def _a2a_fetch(self, x, walks):
        """Only the needed rows, at a static cap C per peer: this rank's
        remote walk targets, deduplicated per owner, go out as ≤ C
        local-row requests per peer (``all_to_all_single``), the owners
        answer with one gather, and the rows come back by a second
        ``all_to_all_single``.  Slots past the cap are dropped from this
        iteration's attraction and counted.  Returns (table ``[x_loc |
        responses]``, neighbour ids into it, slot mask)."""
        P, p, C = self.P, self.rank, self.walk_cap
        n_loc, n = self.layout.n_loc, self.layout.n
        dev = x.device
        t = walks.reshape(-1).long()
        m = t.shape[0]
        valid = t >= 0
        tc = t.clamp(0, n - 1)
        owner = self._shard_of[tc].long()
        lr = self._lrow_of[tc].long()
        is_local = owner == p
        # group: remote slots by owner; local → P, invalid → P + 1
        grp = torch.where(valid, torch.where(is_local, P, owner), P + 1)
        key = grp * n_loc + torch.where(grp < P, lr, 0)
        order = torch.argsort(key, stable=True)
        ks = key[order]
        lrs = lr[order]
        os_ = ks // n_loc
        uniq = torch.ones(m, dtype=torch.int64, device=dev)
        uniq[1:] = (ks[1:] != ks[:-1]).long()
        uidx = torch.cumsum(uniq, 0) - 1
        ucount = torch.zeros(P + 2, dtype=torch.int64,
                             device=dev).index_add_(0, os_, uniq)
        ubase = torch.cumsum(ucount, 0) - ucount
        upos = uidx - ubase[os_]  # rank within the owner's group
        sel = (uniq > 0) & (os_ < P) & (upos < C)
        slot = torch.where(sel, os_ * C + upos.clamp(max=C - 1), P * C)
        # unselected slots all land in the spare last entry, dropped
        req = torch.zeros(P * C + 1, dtype=torch.int32, device=dev)
        req[slot] = torch.where(sel, lrs, 0).to(torch.int32)
        req = req[: P * C]
        got = torch.empty_like(req)
        dist.all_to_all_single(got, req, group=self.group)
        ans = x.index_select(0, got)  # [P·C, D]
        resp = torch.empty_like(ans)
        dist.all_to_all_single(resp, ans, group=self.group)
        upos_slot = torch.empty_like(upos)
        upos_slot[order] = upos
        remote_ok = (grp < P) & (upos_slot < C)
        fetch = torch.where(remote_ok, grp * C + upos_slot.clamp(max=C - 1), 0)
        self._dropped += ((grp < P) & (upos_slot >= C)).sum()
        nbr = torch.where(is_local, lr, n_loc + fetch)
        ok = valid & (is_local | remote_ok)
        return torch.cat([x, resp]), nbr, ok

    def _walk_attraction(self, x, walks, step) -> torch.Tensor:
        """[n_loc, D]: each row's edge force against its walk targets'
        rows, fetched by the ring or the a2a pair; one ``ell_edge_force``
        launch with each row's fetched slots first."""
        t, wl = self.tables, self.config.walk_length
        if self.walk_fetch == "a2a" and self.P > 1:
            tab, nbr, ok = self._a2a_fetch(x, walks)
        else:
            tab, nbr = self._ring_fetch(x, walks)
            ok = walks.reshape(-1) >= 0
        nbr, ok = nbr.view(-1, wl), ok.view(-1, wl)
        # the kernel sums a row's first deg slots: fetched slots first, in
        # order (a stable sort of the dropped ones to the end)
        keep = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)
        nbr = torch.gather(nbr, 1, keep).to(torch.int32).contiguous()
        deg = ok.sum(dim=1, dtype=torch.int32)
        return fk.ell_edge_force(self.model, x, tab, nbr, deg, t.rows,
                                 t.inv_deg, step)

    # -- the iteration -------------------------------------------------------------

    def pool_rows(self, x, pool_g) -> torch.Tensor:
        """``[S, D]`` rows of the global (degree-sorted) ids ``pool_g`` on
        every rank: each rank's owned rows, 0 elsewhere, summed by one
        ``all_reduce``.  ``pool_g`` must be the same on every rank."""
        pool_g = pool_g.long()
        mine = (self._shard_of[pool_g] == self.rank)[:, None]
        rows = x[self._lrow_of[pool_g].long()] * mine
        if self.P > 1:
            dist.all_reduce(rows, group=self.group)
        return rows

    def _iteration(self, x, pool_g, choice, walks, step, state=None,
                   pair=None) -> torch.Tensor:
        """One iteration on this rank's rows, in place; ``step`` a float or
        the 0-d f32 step buffer.  ``state`` (the eager loop's stale mode):
        ``[table, pending]`` of the exchange issued last iteration,
        replaced by this iteration's.  ``pair`` (the graph's stale mode):
        two static tables; this iteration's exchange goes into the first,
        and ends with the iteration, and the second, which holds the last
        iteration's, is read."""
        model, t = self.model, self.tables
        with self._phase("pool"):
            rows = self.pool_rows(x, pool_g)
        issued = []
        if model.attraction == "walk":
            with self._phase("free"):
                upd = _repulsion(model, t, x, rows, step, choice, False)
                upd.add_(self._walk_attraction(x, walks, step))
        else:
            with self._phase("exchange"):
                if pair is not None:
                    issued = self._issue_exchange(x, pair[0])
                    tab, pending = pair[1], []
                else:
                    tab = self._new_table(x)
                    pending = self._issue_exchange(x, tab)
                if state is not None:  # consume last iteration's exchange
                    fresh = [tab, pending]
                    tab, pending = state
                    state[:] = fresh
            with self._phase("free"):
                upd, rep = shard_free_part(model, t, x, rows, step, choice)
                tab[: t.n_loc].copy_(x)
            with self._phase("dep"):
                self._wait(pending)
                upd = shard_dep_part(model, t, x, tab, upd, rep, step)
        with self._phase("apply"):
            apply_update(model, x, upd, step)
            self._wait(issued)
        return x

    def _seed(self, seed: int, it: int) -> None:
        """Iteration ``it``'s generators: the pool's and the walks' (seeded
        alike on every rank) and, in ``pool`` mode, this rank's
        choices'."""
        s = iteration_seed(seed, it)
        self._span_gen.manual_seed(s)
        if self.sampling == "pool":
            self._choice_gen.manual_seed(iteration_seed(s, self.rank + 1))

    def _draws(self):
        """An iteration's pool ids (the same on every rank), then its walks
        (from the same generator), and in ``pool`` mode this rank's
        choices (its own generator), from the seeded generators."""
        cfg = self.config
        S = cfg.ns if self.sampling == "shared" else self.neg_pool
        pool_g = torch.randint(0, max(self.layout.n - 1, 1), (S,),
                               generator=self._span_gen, dtype=torch.int32,
                               device=self.device)
        walks = (self.draw_walks(self._span_gen)
                 if self.model.attraction == "walk" else None)
        choice = None
        if self.sampling == "pool":
            choice = torch.randint(0, S, (self.layout.n_loc, cfg.ns),
                                   generator=self._choice_gen,
                                   dtype=torch.int32, device=self.device)
        return pool_g, choice, walks

    def _draw(self, seed: int, it: int):
        """Iteration ``it``'s draws (``_draws``)."""
        self._seed(seed, it)
        return self._draws()

    def _step(self, it: int) -> float:
        return step_at(self.model, self.lr, it, self._dtype)

    def _stale_tables(self, x) -> list:
        """``halo_stale``'s two static ``[x_loc | hot | halo]`` tables, made
        once (a graph reads them)."""
        if self._stale_tabs is None:
            self._stale_tabs = [self._new_table(x), self._new_table(x)]
            self.span_graph.reset()
        return self._stale_tabs

    def _start_span(self, x, it: int) -> None:
        """The host's work at the start of a graph span from iteration
        ``it``: with ``halo_stale``, X's exchange into the table the span's
        first iteration reads, (it − 1) mod 2, waited for."""
        if self.halo_stale:
            self._wait(self._issue_exchange(
                x, self._stale_tables(x)[(it - 1) % 2]))

    def _prepare_iteration(self, seed: int, it: int) -> None:
        """The host's part of iteration ``it`` of a graph span: its step
        into the step buffer, the generators re-seeded for its draws."""
        self._step_buf.write(self._step(it))
        self._seed(seed, it)

    def _static_iteration(self, x, parity: int = 0) -> None:
        """The iteration a graph span captures: the draws from the
        re-seeded generators, the step from the step buffer; with
        ``halo_stale`` (one body per ``parity``) the exchange into table
        ``parity``, table ``1 - parity`` read."""
        pool_g, choice, walks = self._draws()
        pair = None
        if self.halo_stale:
            tabs = self._stale_tabs
            pair = (tabs[parity], tabs[1 - parity])
        self._iteration(x, pool_g, choice, walks, self._step_buf.tensor,
                        pair=pair)

    # -- public API ------------------------------------------------------------

    def run_iteration(self, x, pool_ids, choice=None, step=None, walks=None):
        """One exact iteration on this rank's padded rows ``x`` (``[n_loc,
        row_width]``) with injected draws, in place: ``pool_ids``
        [S] global (degree-sorted) ids, the same on every rank; ``choice``
        ``[P·n_loc, ns]`` (the whole table's: this rank takes its rows) in
        ``pool`` mode; for walk models ``walks`` ``[n, walk_length]``
        global walk targets indexed by global row (the array the sync
        schedule takes), of which each rank takes its walkers' rows.  The
        kernels do not bounds-check ids, so this raises ``ValueError``
        unless the pool ids lie in [0, n) and the choices in [0, S)."""
        dev, lay, p = self.device, self.layout, self.rank
        if tuple(x.shape) != (lay.n_loc, self.row_width):
            raise ValueError(f"X {tuple(x.shape)} != "
                             f"{(lay.n_loc, self.row_width)} (the padded X "
                             "of init_embedding or pad_embedding)")
        pool_g = torch.as_tensor(pool_ids, device=dev).to(torch.int32)
        if not _in_range(pool_g, lay.n):
            raise ValueError(f"pool ids must lie in [0, {lay.n})")
        ch = None
        if choice is not None:
            ch = torch.as_tensor(choice, device=dev).to(torch.int32)[
                p * lay.n_loc: (p + 1) * lay.n_loc].contiguous()
            if (tuple(ch.shape) != (lay.n_loc, self.config.ns)
                    or not _in_range(ch, pool_g.shape[0])):
                raise ValueError(f"choice must be [{self.P * lay.n_loc}, "
                                 f"{self.config.ns}] ids in "
                                 f"[0, {pool_g.shape[0]})")
        w = None
        if walks is not None:
            wg = torch.as_tensor(walks, device=dev).to(torch.int32)
            rows = wg[self._gmap_loc.clamp(0, lay.n - 1).long()]
            w = torch.where((self._gmap_loc >= 0)[:, None], rows, -1)
        return self._iteration(x, pool_g, ch, w, round_to(
            self.lr if step is None else step, self._dtype))

    def run_span(self, x: torch.Tensor, seed: int, num_iters: int,
                 iter_offset: int = 0) -> torch.Tensor:
        """Iterations ``[iter_offset, iter_offset + num_iters)`` of a run
        seeded with ``seed``, on this rank's rows in place; returns them.
        Draws are keyed by ``(seed, absolute iteration)``, so spans compose
        into the straight run (in ``halo_stale`` mode each span primes the
        pipeline with its first X's exchange).

        On a card the iteration is a CUDA graph (``span_graph``,
        ``train/graph.py``), captured once per X and replayed once per
        iteration, with its collectives (every rank captures the same
        iteration); on the CPU, the eager loop (``_run_span_eager``).
        Raises ``RuntimeError`` on a card over a group that is not NCCL's
        (``graph.check_capturable``)."""
        if self.device.type != "cuda":
            return self._run_span_eager(x, seed, num_iters, iter_offset)
        if self.P > 1:
            check_capturable(self.group or dist.group.WORLD)
        return self.span_graph.run(x, seed, num_iters, iter_offset)

    def _run_span_eager(self, x: torch.Tensor, seed: int, num_iters: int,
                        iter_offset: int = 0) -> torch.Tensor:
        """``run_span`` as a Python loop of eager launches, each step a
        float, ``halo_stale``'s pending exchange carried on the host: the
        reference the graph is held against."""
        state = None
        if self.halo_stale and num_iters > 0:
            tab = self._new_table(x)
            state = [tab, self._issue_exchange(x, tab)]
        for it in range(iter_offset, iter_offset + num_iters):
            pool_g, choice, walks = self._draw(seed, it)
            self._iteration(x, pool_g, choice, walks, self._step(it), state)
        if state is not None:
            self._wait(state[1])  # the last exchange has no consumer
        return x

    def train(self, iters: int = 1200, seed: int = 1,
              x0: Optional[np.ndarray] = None,
              verbose: bool = False) -> Optional[torch.Tensor]:
        """Train ``iters`` iterations; returns the ``[n, dim]`` embedding in
        original id order on rank 0 (None on the others)."""
        if verbose and self.rank == 0:
            cs = self.comm_stats()
            print(f"vp={self.P} comm/iter/shard: "
                  f"{cs['bytes_per_iter_per_shard'] / 1e6:.2f} MB (cold "
                  f"{cs['cold_alltoall_rows_sent']} rows, hot "
                  f"{cs['hot_allgather_rows_recv']} rows)", flush=True)
        x = self.pad_embedding(x0) if x0 is not None else self.init_embedding(
            seed)
        t0 = time.perf_counter()
        self.run_span(x, seed, iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_train_seconds = time.perf_counter() - t0
        return self.unpad_embedding(x)
