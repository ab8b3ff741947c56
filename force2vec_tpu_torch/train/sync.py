"""Epoch-synchronous trainer: the sync schedule of ``force2vec_tpu``.

Semantically the reference's training loop at ``batch_size = n``: every
read in an iteration sees the iteration-start X and the update is applied
once at its end (sample/algorithms.cpp:569-639 with NUMSIZE = n).  One
iteration over the degree-sorted ELL layout (graphs/csr.py::SyncLayout):

1. ``xg``: the gather replica of X (bf16 when ``gather_dtype`` says so);
2. attraction, by the edge kernel (``ell_edge_force``):

   * CSR models: one launch over the layout's work table
     (``edge_table``, every bucket, widest first), written straight into
     the update's rows; the hub bucket's virtual rows write partial sums to
     rows past ``n_pad``, which ``index_add_`` adds into their owner rows,
     and a width-0 entry zeroes the rows no bucket writes (the hub owners
     and padding);
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

Padding rows take part as in the JAX package: their update is computed and
applied, and no edge or sample of a real row reads them.  Everything runs
in relabeled (degree-sorted) vertex order; ``pad_embedding`` and
``unpad_embedding`` permute in and out.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from force2vec_tpu_torch.graphs.csr import Graph, SyncLayout
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels
from force2vec_tpu_torch.train.trainer import TrainConfig


@dataclasses.dataclass
class DeviceBucket:
    """One ELL bucket's index arrays on the device, as the per-bucket edge
    kernel call takes them (``SyncForce2Vec.device_buckets``)."""

    start: int  # first relabeled row of the bucket's update
    nbr: torch.Tensor  # [rows, width] int32
    deg: torch.Tensor  # [rows] int32
    xi_row: torch.Tensor  # [rows] int32 table row of each bucket row
    owner_local: Optional[torch.Tensor] = None  # hub: [rows] int64, - start


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
    linlog, forceatlas), with group-shared or per-vertex negatives.
    """

    def __init__(
        self,
        graph: Graph,
        config: TrainConfig = TrainConfig(),
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        *,
        device="cuda",
    ):
        self.graph = graph
        self.config = config
        self.device = torch.device(device)
        self.model = get_model(config.model, sm_table=config.sm_table)
        if self.model.repulsion == "all":
            raise ValueError("tdist_exact uses the batch trainer, not sync mode")
        self.layout = SyncLayout.build(
            graph, min_width=min_width, hub_width=hub_width,
            row_align=row_align,
            widths=SyncLayout.widths_for(min_width, hub_width, "mult8"),
        )
        self.lr = config.resolve_lr(self.model)
        self._dtype = getattr(torch, config.dtype)
        self._gdt = (None if config.gather_dtype is None
                     else getattr(torch, config.gather_dtype))

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
        if config.per_vertex_samples:
            self._ns_deg = torch.full((lay.n_pad,), config.ns,
                                      dtype=torch.int32, device=dev)
        self.device_buckets = []
        self.edge_table = self._hub = None
        if self.model.attraction == "walk":
            pool, base = build_walk_tables(lay)
            self.walk_pool = torch.as_tensor(pool, device=dev)
            # (deg, base) packed as one [n_pad, 2] table, so a walk step
            # fetches both with one row gather
            self.walk_db = torch.as_tensor(
                np.stack([lay.deg.astype(np.int32), base], axis=1), device=dev)
            self._walk_deg = torch.full((lay.n_pad,), config.walk_length,
                                        dtype=torch.int32, device=dev)
            return  # walk attraction reads no bucket
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
            self.device_buckets.append(DeviceBucket(
                start=b.start,
                nbr=torch.as_tensor(b.nbr[:real], device=dev),
                deg=torch.as_tensor(b.deg[:real], device=dev),
                xi_row=torch.arange(b.start, end, dtype=torch.int32,
                                    device=dev)))
        self._hub = next((b for b in self.device_buckets
                          if b.owner_local is not None), None)
        self.edge_table = self._edge_table()

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

    # -- embedding layout ---------------------------------------------------

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _init(self, gen: torch.Generator) -> torch.Tensor:
        x = torch.rand((self.layout.n_pad, self.config.dim), generator=gen,
                       dtype=self._dtype, device=self.device)
        if self.model.init == "uniform01":
            return x
        return x.mul_(2.0).sub_(1.0)

    def init_embedding(self, seed: int = 1) -> torch.Tensor:
        """[n_pad, D] uniform init ([0, 1) or [-1, 1) by the model), from a
        torch generator seeded with ``seed``.  Padding rows are random too,
        as in the JAX package; no edge or sample reads them."""
        return self._init(self._generator(seed))

    def pad_embedding(self, x) -> torch.Tensor:
        """[n, D] in original id order → [n_pad, D] relabeled, on device."""
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        out = torch.zeros((self.layout.n_pad, self.config.dim),
                          dtype=self._dtype, device=self.device)
        out[: self.graph.n] = x[torch.as_tensor(self.layout.perm,
                                                device=self.device).long()]
        return out

    def unpad_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """[n_pad, D] relabeled → [n, D] in original id order."""
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

    def _attraction(self, x, xg, step, plain) -> torch.Tensor:
        """[n_pad, D] attraction of the CSR models: one launch over
        ``edge_table``, then the hub's partial rows into their owners."""
        fk, n_pad = force_kernels, self.layout.n_pad
        out = (fk.ell_edge_force_table_plain if plain
               else fk.ell_edge_force_table)(self.model, x, xg,
                                             self.edge_table, self.inv_deg,
                                             step)
        upd = out[:n_pad]
        if self._hub is not None:
            upd[self._hub.start: self.layout.n].index_add_(
                0, self._hub.owner_local, out[n_pad:])
        return upd

    def _walk_attraction(self, x, xg, walks, step, plain) -> torch.Tensor:
        fk = force_kernels
        args = (self.model, x, xg, walks, self._walk_deg, self._all_rows,
                self.inv_deg, step)
        return (fk.ell_edge_force_plain if plain
                else fk.ell_edge_force)(*args)

    def _add_repulsion(self, upd, x, xg, negs, step, plain) -> None:
        fk, model = force_kernels, self.model
        if self.config.per_vertex_samples:
            # ns samples of each row's own (-bs 1, the JAX package's
            # [n_pad, ns] branch, sync.py:604-621), added in the kernel
            (fk.ell_sample_force_plain if plain
             else fk.ell_sample_force)(model, x, xg, negs, self._ns_deg,
                                       self._all_rows, step, out=upd,
                                       accumulate=True)
            return
        # one ns-sample set per batch_size-row group — the reference's
        # option-5 sampling (sample/algorithms.cpp:577-586)
        sg = xg[negs.long()]  # [ng, ns, D]
        group = max(self.config.batch_size, 1)
        upd.add_((fk.grouped_rep_force_plain if plain
                  else fk.grouped_rep_force)(model, group, x, sg, step))

    def _iteration(self, x: torch.Tensor, negs: torch.Tensor,
                   walks: Optional[torch.Tensor], step: float,
                   plain: bool) -> torch.Tensor:
        xg = x if self._gdt is None else x.to(self._gdt)
        upd = (self._attraction(x, xg, step, plain) if walks is None
               else self._walk_attraction(x, xg, walks, step, plain))
        self._add_repulsion(upd, x, xg, negs, step, plain)
        if self.model.update == "energy":
            fnorm = torch.sum(upd * upd, dim=-1, keepdim=True)
            safe = torch.where(fnorm > 0, fnorm, 1.0)
            upd.mul_(torch.where(fnorm > 0, step / torch.sqrt(safe), 0.0))
        return x.add_(upd)

    def _step(self, it: int) -> float:
        if self.model.lr_schedule == "decay999":
            return self.lr * 0.999 ** it
        return self.lr

    # -- public API ----------------------------------------------------------

    def run_iteration(self, x: torch.Tensor, neg_ids, walks=None,
                      step: Optional[float] = None,
                      plain: bool = False) -> torch.Tensor:
        """One iteration with injected negatives and, for walk models,
        injected walks, all relabeled ids.  The negatives are ``[n_pad,
        ns]``, one set per row, with ``per_vertex_samples``; else ``[ng,
        ns]``, one set per ``batch_size``-row group.  The walks are
        ``[n_pad, walk_length]``.  Updates ``x`` in place and returns it;
        raises on any other shape.

        ``plain=True`` computes the same iteration with the plain PyTorch
        versions of the kernels on ``x``'s device: the reference the
        kernels are checked against on the card.
        """
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
        return self._iteration(x, negs.to(torch.int32).contiguous(), walks,
                               self.lr if step is None else step, plain)

    def train(self, iters: int = 1200, seed: int = 1,
              x0: Optional[np.ndarray] = None) -> torch.Tensor:
        """Train ``iters`` iterations; returns the [n, D] embedding in
        original id order, on the device.  The initial X (unless ``x0``)
        and every iteration's draws come from one generator seeded with
        ``seed``: the negatives (``run_iteration``'s shape, ids in
        ``[0, n-1)``, the JAX package's range), then, for walk models, the
        walks (``draw_walks``)."""
        gen = self._generator(seed)
        x = self.pad_embedding(x0) if x0 is not None else self._init(gen)
        hi = max(self.layout.n - 1, 1)
        is_walk = self.model.attraction == "walk"
        t0 = time.perf_counter()
        for it in range(iters):
            negs = torch.randint(0, hi, self._neg_shape, generator=gen,
                                 dtype=torch.int32, device=self.device)
            walks = self.draw_walks(gen) if is_walk else None
            self._iteration(x, negs, walks, self._step(it), plain=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_train_seconds = time.perf_counter() - t0
        return self.unpad_embedding(x)
