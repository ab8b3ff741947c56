"""Epoch-synchronous trainer: the sync schedule of ``force2vec_tpu``.

Semantically the reference's training loop at ``batch_size = n``: every
read in an iteration sees the iteration-start X and the update is applied
once at its end (sample/algorithms.cpp:569-639 with NUMSIZE = n).  One
iteration over the degree-sorted ELL layout (graphs/csr.py::SyncLayout):

1. ``xg``: the gather replica of X (bf16 when ``gather_dtype`` says so);
2. one edge-kernel launch per non-hub bucket, written straight into that
   bucket's rows of the update;
3. one launch for the hub bucket's virtual rows, whose partial sums are
   added into their owner rows with ``index_add_``;
4. the ``[ng, ns, D]`` group-shared negative samples ``xg[negs]`` and one
   repulsion-kernel launch;
5. ``X += update`` (or the energy-normalized update), in place.

Everything runs in relabeled (degree-sorted) vertex order; ``pad_embedding``
and ``unpad_embedding`` permute in and out.  Not ported yet: walk models
(``rwalk``) and per-vertex negatives (``per_vertex_samples``, ``-bs 1``).
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
    """One ELL bucket's index arrays on the device, as the edge kernel
    takes them (``SyncForce2Vec.device_buckets``, one per launch)."""

    start: int  # first relabeled row of the bucket's update
    nbr: torch.Tensor  # [rows, width] int32
    deg: torch.Tensor  # [rows] int32
    xi_row: torch.Tensor  # [rows] int32 table row of each bucket row
    owner_local: Optional[torch.Tensor] = None  # hub: [rows] int64, - start


class SyncForce2Vec:
    """Train with the epoch-synchronous schedule on ``device``.

    Supports the sampled-repulsion models with a CSR attraction (tdist,
    sigmoid, fr, linlog, forceatlas) and group-shared negatives.
    """

    def __init__(
        self,
        graph: Graph,
        config: TrainConfig = TrainConfig(),
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        *,
        device,
    ):
        self.graph = graph
        self.config = config
        self.device = torch.device(device)
        self.model = get_model(config.model, sm_table=config.sm_table)
        if self.model.repulsion == "all":
            raise ValueError("tdist_exact uses the batch trainer, not sync mode")
        if self.model.attraction == "walk":
            raise NotImplementedError("walk models are not ported yet")
        if config.per_vertex_samples:
            raise NotImplementedError(
                "per-vertex negatives (-bs 1) are not ported yet")
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
        self.device_buckets = []
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
        # rows the non-hub buckets do not write: the hub range and padding
        self._zero_from = (lay.buckets[-1].start
                           if lay.buckets and lay.buckets[-1].owners is not None
                           else lay.n)

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

    # -- the iteration ---------------------------------------------------------

    def _iteration(self, x: torch.Tensor, negs: torch.Tensor, step: float,
                   plain: bool) -> torch.Tensor:
        fk = force_kernels
        model = self.model
        xg = x if self._gdt is None else x.to(self._gdt)
        upd = torch.empty_like(x)
        upd[self._zero_from:].zero_()
        for b in self.device_buckets:
            args = (model, x, xg, b.nbr, b.deg, b.xi_row, self.inv_deg, step)
            if b.owner_local is None:
                rows = upd[b.start: b.start + b.nbr.shape[0]]
                if plain:
                    rows.copy_(fk.ell_edge_force_plain(*args))
                else:
                    fk.ell_edge_force(*args, out=rows)
            else:
                part = (fk.ell_edge_force_plain(*args) if plain
                        else fk.ell_edge_force(*args))
                upd[b.start: self.layout.n].index_add_(0, b.owner_local, part)
        # one ns-sample set per batch_size-row group — the reference's
        # option-5 sampling (sample/algorithms.cpp:577-586)
        sg = xg[negs.long()]  # [ng, ns, D]
        group = max(self.config.batch_size, 1)
        rep = (fk.grouped_rep_force_plain if plain
               else fk.grouped_rep_force)(model, group, x, sg, step)
        upd.add_(rep)
        if model.update == "energy":
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
        """One iteration with injected ``[ng, ns]`` negatives (relabeled
        ids, one row per ``batch_size``-row group).  Updates ``x`` in place
        and returns it.

        ``plain=True`` computes the same iteration with the plain PyTorch
        versions of the kernels on ``x``'s device: the reference the
        kernels are checked against on the card.
        """
        if walks is not None:
            raise NotImplementedError("walk models are not ported yet")
        negs = torch.as_tensor(neg_ids, device=self.device)
        ng = -(-self.layout.n_pad // max(self.config.batch_size, 1))
        if tuple(negs.shape) != (ng, self.config.ns):
            raise ValueError(
                f"negatives {tuple(negs.shape)} != {(ng, self.config.ns)}")
        return self._iteration(x, negs, self.lr if step is None else step,
                               plain)

    def train(self, iters: int = 1200, seed: int = 1,
              x0: Optional[np.ndarray] = None) -> torch.Tensor:
        """Train ``iters`` iterations; returns the [n, D] embedding in
        original id order, on the device.  The initial X (unless ``x0``) and
        every iteration's negatives come from one generator seeded with
        ``seed``: ``[ceil(n_pad / batch_size), ns]`` ids in ``[0, n-1)``,
        the JAX package's range."""
        gen = self._generator(seed)
        x = self.pad_embedding(x0) if x0 is not None else self._init(gen)
        lay, cfg = self.layout, self.config
        ng = -(-lay.n_pad // max(cfg.batch_size, 1))
        t0 = time.perf_counter()
        for it in range(iters):
            negs = torch.randint(0, max(lay.n - 1, 1), (ng, cfg.ns),
                                 generator=gen, device=self.device)
            self._iteration(x, negs, self._step(it), plain=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_train_seconds = time.perf_counter() - t0
        return self.unpad_embedding(x)
