"""Training hyperparameters and the batch-sequential trainer, ``Force2Vec``.

The port of ``force2vec_tpu/train/trainer.py``, the CLI's default
schedule.  Batch-update semantics match the reference exactly: every read
within a batch sees the pre-batch embedding, updates apply at batch end,
and batch b+1 observes them (sample/algorithms.cpp:569-639).

One iteration is a Python loop over the batches, each a fixed, short
sequence of torch operations on the device and no read back to the host
(every batch's edge span is computed on the host when the trainer is
built, ``DeviceGraph.batch_spans``):

* the batch's rows are a view ``[B, D]`` of X;
* attraction over the batch's CSR edges (one contiguous ``colids`` span):
  gather both ends, the model's edge force, and the fixed-order segment
  sum into the batch rows (``ops/segment.py``); or, for walk models, over
  each row's ``walk_length`` walk targets;
* repulsion from the ``ns`` negatives the batch shares, or each row's
  window of its per-vertex buffer, gathered at batch start; or, for
  ``tdist_exact``, from every vertex (O(n²)), over column tiles sized by
  bytes;
* ``X[batch] += update`` (or the energy-normalised update of the layout
  family), in place.

The JAX package computes this loop in XLA with no Pallas kernel, so its
port is plain torch operations, in X's dtype (``TrainConfig.dtype``, f32
or bf16 on the card; the step rounded to it, as the JAX package rounds
it).  ``gather_dtype`` is the sync schedule's and is ignored here, as in
the JAX package.

Under ``spmd`` (``dist/multihost.py::pod_mesh``, one process per
card) each dp rank computes its contiguous 1/dp of every batch's rows
(their CSR edges are one contiguous span) and an ``all_reduce`` over dp
merges the disjoint row updates: every other rank adds exact zeros to a
row, so the merge is exact and the trainer stays deterministic.  The
embedding dim splits over tp, with the per-pair scalars completed by an
``all_reduce`` over tp (the force functions' ``rsum``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.graphs.csr import DeviceGraph, Graph
from force2vec_tpu_torch.models.forces import ForceModel, get_model
from force2vec_tpu_torch.ops.segment import (SEGMENT_MODES,
                                             segment_sum_into_batch)
from force2vec_tpu_torch.sampling.negative import (per_vertex_windows,
                                                   sample_negative_ids)
from force2vec_tpu_torch.sampling.walks import sample_walks

# Bytes of one [B, T, D] f32 temporary of the exact repulsion's column tile
_REP_TILE_BYTES = 32 << 20


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (CLI-flag parity noted per field)."""

    dim: int = 128  # -dim
    batch_size: int = 384  # -batch
    model: str = "tdist"  # -option (see models.forces.OPTION_TO_MODEL)
    ns: int = 5  # -nsamples
    lr: Optional[float] = None  # -lr (None → model default)
    per_vertex_samples: bool = False  # -bs 1
    walk_length: int = 5  # WALKLENGTH (sample/algorithms.cpp:1073)
    edge_chunk: Optional[int] = None  # DeviceGraph's edge padding unit
    rep_chunk: int = 512  # most columns in an exact-repulsion tile
    segment_mode: str = "matmul"  # accepted; both modes are one sum here
    dtype: str = "float32"
    # Low-precision replica of X for the sync schedule's neighbour and
    # sample gathers ('bfloat16' halves the gather bytes); the force math
    # and the apply stay in ``dtype``.  None gathers from X itself.
    gather_dtype: Optional[str] = None
    sm_table: bool = False  # sigmoid family: σ from the 2048-entry table

    def resolve_lr(self, model: ForceModel) -> float:
        return model.default_lr if self.lr is None else self.lr


def iteration_seed(seed: int, it: int) -> int:
    """The seed of iteration ``it``'s draws in a run seeded with ``seed``:
    keyed by the absolute iteration, so a run split into spans, or resumed
    from a checkpoint, draws what a straight run draws."""
    state = np.random.SeedSequence((seed % 2**64, it)).generate_state(
        2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


def round_to(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (X's), as a Python float: the step the
    JAX package holds (``jnp.asarray(step, dtype=x.dtype)``).  On the host,
    with no torch operation, through f32 as torch converts a Python float:
    bf16 as the top half of the f32, rounded to nearest even."""
    if dtype == torch.float64:
        return float(v)
    if dtype != torch.bfloat16:
        return float(np.dtype(str(dtype).split(".")[1]).type(np.float32(v)))
    bits = int(np.array(v, dtype=np.float32).view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return float(np.array(bits, dtype=np.uint32).view(np.float32))


def step_at(model: ForceModel, lr: float, it: int,
            dtype: torch.dtype = torch.float32) -> float:
    """The step of iteration ``it`` in X's ``dtype``: ``lr``, decayed by
    0.999 an iteration for the ``decay999`` schedule
    (sample/algorithms.cpp:436), each rounded to ``dtype`` as the JAX
    package rounds them (force2vec_tpu/train/trainer.py:361-363: the decay
    factor, then the product)."""
    if model.lr_schedule != "decay999":
        return round_to(lr, dtype)
    return round_to(lr * round_to(0.999 ** it, dtype), dtype)


def _auto_edge_chunk(graph: Graph, num_batches: int) -> int:
    mean_batch_edges = max(1, graph.nnz // max(num_batches, 1))
    chunk = ((mean_batch_edges + 511) // 512) * 512
    return int(min(8192, max(512, chunk)))


class Force2Vec:
    """Train with the reference's batch-sequential schedule on ``device``.

    Example::

        fv = Force2Vec(graph, TrainConfig(dim=128, batch_size=256,
                                          model="tdist"), device="cuda")
        emb = fv.train(iters=1200, seed=1)  # [n, 128] tensor on the card
    """

    def __init__(self, graph: Graph, config: TrainConfig = TrainConfig(), *,
                 spmd: SpmdAxes = SpmdAxes(), device="cuda"):
        if config.segment_mode not in SEGMENT_MODES:
            raise ValueError(f"unknown segment mode {config.segment_mode!r}")
        self.graph = graph
        self.config = config
        self.device = torch.device(device)
        self.spmd = spmd
        self.model = get_model(config.model, sm_table=config.sm_table)
        b = min(config.batch_size, graph.n)
        nb = -(-graph.n // b)
        chunk = config.edge_chunk or _auto_edge_chunk(graph, nb)
        self.dg = dg = DeviceGraph.build(graph, config.batch_size,
                                         edge_chunk=chunk)
        if dg.batch_size % spmd.n_dp or config.dim % spmd.n_tp:
            raise ValueError(f"batch size {dg.batch_size} must divide over "
                             f"dp={spmd.n_dp} and dim {config.dim} over "
                             f"tp={spmd.n_tp}")
        self.lr = config.resolve_lr(self.model)
        self._dtype = getattr(torch, config.dtype)
        # this dp rank's rows of a batch, [_r0, _r0 + _b_local)
        self._b_local = dg.batch_size // spmd.n_dp
        self._r0 = spmd.dp_index * self._b_local
        self._rkw = ({"rsum": spmd.make_rsum()} if spmd.n_tp > 1 else {})
        self.spans = [(int(dg.rowptr[k * dg.batch_size + self._r0]),
                       int(dg.rowptr[k * dg.batch_size + self._r0
                                     + self._b_local]))
                      for k in range(dg.num_batches)]

        dev, bsz = self.device, dg.batch_size
        inv_deg = 1.0 / (dg.deg.astype(np.float64) + 1.0)
        self.inv_deg = torch.as_tensor(inv_deg, dtype=self._dtype, device=dev)
        self.rowptr = torch.as_tensor(dg.rowptr, device=dev)
        self.colids = torch.as_tensor(dg.colids, device=dev)
        # each edge's source row within its rank's slice of the batch, its
        # source's 1/(deg+1), and each row's edge count: the segment
        # lengths of the batch sum
        self.edge_row = torch.as_tensor(dg.edge_src % self._b_local,
                                        device=dev)
        self.edge_inv_deg = torch.as_tensor(
            inv_deg[dg.edge_src][:, None], dtype=self._dtype, device=dev)
        self.seg_len = torch.as_tensor(dg.deg, dtype=torch.int64, device=dev)
        self._windows = (per_vertex_windows(bsz, config.ns, dev)[
            self._r0: self._r0 + self._b_local].reshape(-1)
            if config.per_vertex_samples else None)
        self._ids = torch.arange(dg.n_pad, device=dev)
        self._rep_cols = max(1, min(
            dg.n_pad, config.rep_chunk,
            _REP_TILE_BYTES // (bsz * config.dim * 4)))
        self._gen = torch.Generator(device=dev)

    # -- embedding layout ---------------------------------------------------

    def init_embedding(self, seed: int = 1) -> torch.Tensor:
        """Random init on the padded table from a generator seeded with
        ``seed``: U(0,1) for sigmoid-family models (randInit,
        sample/algorithms.cpp:38-45), U(-1,1) otherwise (randInitF,
        sample/algorithms.cpp:47-53)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = torch.rand((self.dg.n_pad, self.config.dim), generator=gen,
                       dtype=self._dtype, device=self.device)
        x = x if self.model.init == "uniform01" else x.mul_(2.0).sub_(1.0)
        return self._tp_columns(x)

    def _tp_columns(self, x: torch.Tensor) -> torch.Tensor:
        """This tp rank's columns of a full-width X."""
        n_tp = self.spmd.n_tp
        if n_tp == 1:
            return x
        w = self.config.dim // n_tp
        return x[:, self.spmd.tp_index * w:
                 (self.spmd.tp_index + 1) * w].contiguous()

    def pad_embedding(self, x) -> torch.Tensor:
        """A host or device ``[n, D]`` embedding → ``[n_pad, D]`` on the
        device, padding rows 0 (this tp rank's columns under tp)."""
        out = torch.zeros((self.dg.n_pad, self.config.dim), dtype=self._dtype,
                          device=self.device)
        out[: self.graph.n] = torch.as_tensor(x, dtype=self._dtype,
                                              device=self.device)
        return self._tp_columns(out)

    def unpad_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """``[n_pad, D]`` → ``[n, D]``: the batch layout keeps the original
        vertex order, so this is a view of the first n rows (under tp, the
        ranks' columns gathered: a collective over tp)."""
        if self.spmd.n_tp > 1:
            cols = [torch.empty_like(x) for _ in range(self.spmd.n_tp)]
            dist.all_gather(cols, x.contiguous(), group=self.spmd.tp)
            x = torch.cat(cols, dim=1)
        return x[: self.graph.n]

    # -- the iteration ---------------------------------------------------------

    def _repulsion_all(self, x, xb, b0, step) -> torch.Tensor:
        """The exact O(n²) repulsion of the batch rows against every real
        vertex j != i (AlgoForce2Vec, sample/algorithms.cpp:399-422), over
        column tiles of ``_rep_cols`` rows.  The tiles cover every column
        (the JAX loop runs ``n_pad // rep_chunk`` tiles)."""
        rows = self._ids[b0: b0 + xb.shape[0], None]
        acc = torch.zeros_like(xb)
        for c0 in range(0, self.dg.n_pad, self._rep_cols):
            cols = self._ids[None, c0: c0 + self._rep_cols]
            valid = (cols < self.dg.n) & (cols != rows)
            f = self.model.sample_force(
                xb[:, None, :], x[c0: c0 + self._rep_cols][None], step,
                mask=valid[:, :, None], **self._rkw)
            acc.add_(f.sum(dim=1))
        return acc

    def _batch(self, x, b, negs, walks, step) -> None:
        """Batch ``b``: its update from the pre-batch X, applied in place.
        Under dp this rank computes its rows ``[r0, r0 + B/dp)`` of the
        batch, and the ranks' rows are merged by an ``all_reduce``."""
        cfg, model, bsz = self.config, self.model, self.dg.batch_size
        kw, bl = self._rkw, self._b_local
        b0 = b * bsz
        r0 = b0 + self._r0  # this rank's first row
        xb = x[b0: b0 + bsz]
        xr = x[r0: r0 + bl]
        if model.attraction == "walk":
            wb = walks[r0: r0 + bl].reshape(-1)
            xj = x.index_select(0, wb).view(bl, cfg.walk_length, -1)
            acc = model.edge_force(xr[:, None, :], xj,
                                   self.inv_deg[r0: r0 + bl, None, None],
                                   step, **kw).sum(dim=1)
        else:
            e0, e1 = self.spans[b]
            if e1 > e0:
                xi = xr.index_select(0, self.edge_row[e0:e1])
                xj = x.index_select(0, self.colids[e0:e1])
                f = model.edge_force(xi, xj, self.edge_inv_deg[e0:e1], step,
                                     **kw)
                acc = segment_sum_into_batch(f, self.seg_len[r0: r0 + bl],
                                             cfg.segment_mode)
            else:
                acc = torch.zeros_like(xr)

        if model.repulsion == "all":
            acc.add_(self._repulsion_all(x, xr, r0, step))
        else:
            s = x.index_select(0, negs[b])
            sv = (s.index_select(0, self._windows).view(bl, cfg.ns, -1)
                  if self._windows is not None else s[None])
            acc.add_(model.sample_force(xr[:, None, :], sv, step,
                                        **kw).sum(dim=1))

        if self.spmd.n_dp > 1:
            # merge the disjoint row slices: the other ranks add exact 0s
            full = torch.zeros_like(xb)
            full[self._r0: self._r0 + bl] = acc
            acc = self.spmd.psum_dp(full)
        if model.update == "energy":
            # energy-normalised apply (sample/algorithms.cpp:224-239)
            fnorm = (kw["rsum"](acc * acc) if kw
                     else torch.sum(acc * acc, dim=-1, keepdim=True))
            safe = torch.where(fnorm > 0, fnorm, 1.0)
            acc.mul_(torch.where(fnorm > 0, step / torch.sqrt(safe), 0.0))
        xb.add_(acc)

    def _iteration(self, x, negs, walks, step) -> torch.Tensor:
        # the JAX package's step, in X's dtype (trainer.py:310)
        step = round_to(step, self._dtype)
        for b in range(self.dg.num_batches):
            self._batch(x, b, negs, walks, step)
        return x

    def _draw(self, seed: int, it: int):
        """Iteration ``it``'s negatives and walks, from the reused generator
        re-seeded with ``iteration_seed(seed, it)``."""
        dg, cfg, model, gen = self.dg, self.config, self.model, self._gen
        gen.manual_seed(iteration_seed(seed, it))
        negs = None if model.repulsion == "all" else sample_negative_ids(
            gen, dg.num_batches, dg.batch_size, cfg.ns, dg.n,
            per_vertex=cfg.per_vertex_samples, neg_range=model.neg_range)
        walks = sample_walks(gen, self.rowptr, self.colids, dg.n_pad,
                             cfg.walk_length) if model.attraction == "walk" \
            else None
        return negs, walks

    # -- public API ----------------------------------------------------------

    def run_iteration(self, x: torch.Tensor, neg_ids=None, walks=None,
                      step: Optional[float] = None) -> torch.Tensor:
        """One iteration with injected negatives and walks — the parity-test
        entry point (SURVEY.md §4: parity is defined over injected samples).

        x ``[n_pad, D]`` on the device, updated in place and returned;
        neg_ids ``[num_batches, M]`` (M = ns, or ns·B with per-vertex
        negatives; none for ``tdist_exact``); walks ``[n_pad,
        walk_length]`` for walk models.  Raises on any other shape."""
        dg, cfg, model = self.dg, self.config, self.model
        takes_negs = model.repulsion != "all"
        if (neg_ids is not None) != takes_negs:
            raise ValueError(f"{model.name} takes "
                             f"{'negatives' if takes_negs else 'no negatives'}")
        negs = None
        if neg_ids is not None:
            negs = torch.as_tensor(neg_ids, device=self.device)
            m = cfg.ns * dg.batch_size if cfg.per_vertex_samples else cfg.ns
            if tuple(negs.shape) != (dg.num_batches, m):
                raise ValueError(f"negatives {tuple(negs.shape)} != "
                                 f"{(dg.num_batches, m)}")
            negs = negs.to(torch.int32)
        is_walk = model.attraction == "walk"
        if (walks is not None) != is_walk:
            raise ValueError(f"{model.name} takes "
                             f"{'walks' if is_walk else 'no walks'}")
        if walks is not None:
            walks = torch.as_tensor(walks, device=self.device)
            if tuple(walks.shape) != (dg.n_pad, cfg.walk_length):
                raise ValueError(f"walks {tuple(walks.shape)} != "
                                 f"{(dg.n_pad, cfg.walk_length)}")
            walks = walks.to(torch.int32)
        return self._iteration(x, negs, walks,
                               self.lr if step is None else step)

    def run_span(self, x: torch.Tensor, seed: int, num_iters: int,
                 iter_offset: int = 0) -> torch.Tensor:
        """Iterations ``[iter_offset, iter_offset + num_iters)`` of a run
        seeded with ``seed``, on the padded X in place; returns it.  Each
        iteration draws from a generator re-seeded from ``(seed, absolute
        iteration)``, so spans compose into the straight run."""
        for it in range(iter_offset, iter_offset + num_iters):
            negs, walks = self._draw(seed, it)
            self._iteration(x, negs, walks,
                            step_at(self.model, self.lr, it, self._dtype))
        return x

    def train(self, iters: int = 1200, seed: int = 1,
              x0: Optional[np.ndarray] = None, iters_per_call: int = 0,
              verbose: bool = False) -> torch.Tensor:
        """Run training and return the ``[n, D]`` embedding, on the device.

        The initial X comes from ``seed`` alone (unless ``x0``).
        ``iters_per_call`` > 0 splits the run into spans with a progress
        line after each (``verbose``); the result is the same."""
        x = (self.pad_embedding(x0) if x0 is not None
             else self.init_embedding(seed))
        span = iters_per_call if iters_per_call > 0 else iters
        done = 0
        t_start = time.perf_counter()
        while done < iters:
            k = min(span, iters - done)
            self.run_span(x, seed, k, done)
            done += k
            if verbose:
                self._sync()
                dt = time.perf_counter() - t_start
                eps = self.graph.nnz * done / max(dt, 1e-9)
                print(f"iter {done}/{iters}  {dt:.2f}s  {eps/1e6:.1f}M "
                      "edges/s")
        self._sync()
        self.last_train_seconds = time.perf_counter() - t_start
        return self.unpad_embedding(x)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
