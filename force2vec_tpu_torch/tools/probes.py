"""The TPU rounds' kernel probes, on the card.

    python3 -m force2vec_tpu_torch.tools.probes [vmem_take] [sweepvar] [dg]
        [sweepfloor]                      # all four without arguments

Needs one CUDA card.  The port's counterparts of four experiments of the
JAX package, each driving one of the probe kernels
(``ops/probe_kernels.py``) at the shapes the JAX tool ran:

* ``vmem_take`` (``benchmarks/exp_r3.py:163-198``): ``take_sum``, the sum
  of 16 rows gathered from a [16384, 128] table per output row, against
  its plain version, then M gathered rows/s per dtype and the TB/s they
  read from L2, with the ring's filler and depth, beside
  ``F.embedding_bag(idx, tbl, mode="sum")`` (the same function; with a
  bf16 table it returns bf16);
* ``sweepvar`` (``benchmarks/exp_r3.py:591-725``): ms over the bench
  layout's 13 buckets for three ways to compute the tdist attraction:
  ``cuda`` (``ell_edge_force``, gather in the kernel; the JAX tool's
  ``pallas``), ``tc`` (13 ``index_select`` gathers into the buckets'
  tiles, then one ``tile_force_tc_table`` launch over all 13 with the D
  reduction on the tensor cores; ``mxu``) and ``plain`` (the plain
  versions; ``barrier``); then ``mxu_parity``, ``tile_force_tc`` against
  ``ell_edge_force`` on bucket 2;
* ``dg`` (``benchmarks/exp_r4.py:151-181``): ``resident_gather``, ~4 M
  rows from an [H, 128] table, H in {2048, 8192, 32768}, M rows/s per
  (dtype, H), beside ``torch.index_select(tbl, 0, idx)``;
* ``sweepfloor`` (``benchmarks/exp_r4.py:413-519``): the floor of a sweep
  over the bench layout's gathered tile, cut into the JAX package's take
  groups (40 of [4023, 16, 128] bf16, 659 MB): ``copy_rw`` (``tiles + 1``),
  ``read_sum`` (one launch per group; the JAX tool's ``pallas_read``,
  beside ``tile.sum((0, 1), dtype=torch.float32)``), ``read_sum_whole``
  (one launch over all 40 groups, the read floor without 40 launches'
  overhead) and ``take_static`` (one ``index_select`` per group).

Each prints one JSON line per case, ``{"exp": ..., ...}``, with the JAX
tools' field names (``ms``, ``m_rows_per_s``, ``gb_per_s``) and the card's
name and power limit.  Times are CUDA events over back-to-back calls
(``tools.cuda_ms``); where a case is a loop of 13 or 40 launches, whose
host enqueue can outlast the device's work, ``queued_ms`` is its time with
the calls queued ahead of the device (``tools.queued_device_ms``).  The JAX
tools' slope timing and ``(idx + i) % h`` index shifts only kept XLA from
hoisting work out of its loops.  Each
``exp_*`` takes the device and its sizes, so the tests drive it on the CPU
at a tiny size: there it returns its parity fields, and its time fields
are ``None``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.ops import probe_kernels as pk
from force2vec_tpu_torch.tools import (BENCH_CONFIG, HUB_WIDTH, MIN_WIDTH,
                                      card_name_and_power, cuda_ms,
                                      queued_device_ms)
from force2vec_tpu_torch.train.sync import SyncForce2Vec

EXPERIMENTS = ("vmem_take", "sweepvar", "dg", "sweepfloor")
# calls per timing: WARMUP + REPS for a kernel or a library call,
# WARMUP + PLAIN_REPS for a plain version, QUEUED_REPS queued
WARMUP, REPS, PLAIN_REPS, QUEUED_REPS = 2, 10, 3, 5
STEP = 0.02  # exp_sweepvar's step (exp_r3.py:614)
TILE_K = 16  # exp_sweepfloor's tile width (exp_r4.py:436)


def _ms(dev: torch.device, fn, reps: int = REPS) -> Optional[float]:
    """CUDA-event ms per call on a card; None (not measured) elsewhere."""
    if dev.type != "cuda":
        return None
    return cuda_ms(fn, reps=reps, warmup=WARMUP)


def _queued_ms(dev: torch.device, fn) -> Optional[float]:
    """Device ms per call with the calls queued ahead of the device, on a
    card; None elsewhere."""
    if dev.type != "cuda":
        return None
    return queued_device_ms(fn, reps=QUEUED_REPS)


def _per_s(count: float, ms: Optional[float], unit: float) -> Optional[float]:
    return None if ms is None else count / (ms * 1e-3) / unit


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# -- vmem_take: take_sum -------------------------------------------------------


def take_sum_inputs(dev, dtype, h=16384, d=128, c=65536, k=16, seed=5):
    """A [h, d] standard-normal table of ``dtype`` and [c, k] int32 ids in
    [0, h), from a numpy seed."""
    rng = np.random.default_rng(seed)
    tbl = torch.as_tensor(rng.standard_normal((h, d), dtype=np.float32))
    idx = torch.as_tensor(rng.integers(0, h, (c, k), dtype=np.int32))
    return tbl.to(device=dev, dtype=dtype), idx.to(dev)


def exp_vmem_take(device, h=16384, d=128, c=65536, k=16) -> list:
    dev = torch.device(device)
    out = []
    for dt in ("bfloat16", "float32"):
        tbl, idx = take_sum_inputs(dev, getattr(torch, dt), h, d, c, k)
        err = _max_err(pk.take_sum(tbl, idx), pk.take_sum_plain(tbl, idx))
        ms = _ms(dev, lambda: pk.take_sum(tbl, idx))
        lib_ms = _ms(dev, lambda: F.embedding_bag(idx, tbl, mode="sum"))
        out.append(dict(exp="vmem_take", dtype=dt, h=h, k=k, rows=c,
                        filler=pk.TAKE_FILLER,
                        stages=pk.TAKE_STAGES, max_abs_err=err, ms=ms,
                        m_rows_per_s=_per_s(c * k, ms, 1e6),
                        l2_tb_per_s=_per_s(c * k * d * tbl.element_size(),
                                           ms, 1e12),
                        library_ms=lib_ms, library_dtype=dt))
    return out


# -- dg: resident_gather ----------------------------------------------------------


def dg_inputs(dev, dtype, h, total=4_000_000, d=128, seed=0):
    """A [h, d] standard-normal table of ``dtype`` and ``n_chunks·h`` int32
    ids in [0, h), n_chunks = max(1, total // h) (exp_r4.py:157)."""
    rng = np.random.default_rng(seed)
    m = max(1, total // h) * h
    tbl = torch.as_tensor(rng.standard_normal((h, d), dtype=np.float32))
    idx = torch.as_tensor(rng.integers(0, h, m, dtype=np.int32))
    return tbl.to(device=dev, dtype=dtype), idx.to(dev)


def exp_dg(device, hs=(2048, 8192, 32768), total=4_000_000, d=128) -> list:
    dev = torch.device(device)
    out = []
    for dt in ("bfloat16", "float32"):
        for h in hs:
            tbl, idx = dg_inputs(dev, getattr(torch, dt), h, total, d)
            m = idx.shape[0]
            got = torch.empty((m, d), dtype=tbl.dtype, device=dev)
            pk.resident_gather(tbl, idx, out=got)
            exact = bool(torch.equal(got, pk.resident_gather_plain(tbl, idx)))
            ms = _ms(dev, lambda: pk.resident_gather(tbl, idx, out=got))
            lib = torch.empty_like(got)
            lib_ms = _ms(dev, lambda: torch.index_select(tbl, 0, idx, out=lib))
            out.append(dict(exp="dg", H=h, dtype=dt, rows=m, exact=exact,
                            ms=ms, m_rows_per_s=_per_s(m, ms, 1e6),
                            gb_per_s=_per_s(got.numel() * got.element_size(),
                                            ms, 1e9),
                            library_ms=lib_ms))
            del got, lib
    return out


# -- sweepfloor: read_sum over the take groups ----------------------------------


def take_group_shape(padded_slots: int, dim: int = 128, itemsize: int = 2,
                     k: int = TILE_K, group_bytes: Optional[int] = None):
    """(rows_per_group, groups, t_rows) of exp_sweepfloor's tile.  The
    group size is the JAX package's automatic take-group size
    (``force2vec_tpu/train/sync.py:122-130``: a 40th of the padded gather
    volume, within [8 MB, 32 MB]) unless ``group_bytes`` is given; the
    port has no take groups.  Then exp_r4.py:437-441."""
    if group_bytes is None:
        total = padded_slots * dim * itemsize
        group_bytes = max(8 * 1024 * 1024, min(32 * 1024 * 1024, total // 40))
    rows_per_group = (group_bytes // (dim * itemsize) // k) * k
    return rows_per_group, padded_slots // rows_per_group, rows_per_group // k


def sweepfloor_tiles(graph, dev, group_bytes=None, min_width=MIN_WIDTH,
                     hub_width=HUB_WIDTH):
    """(tiles [groups, t_rows, 16, D] bf16, ids [groups·rows_per_group]
    int32, xg): the bench layout's padded neighbour slots, in bucket order,
    gathered from the bf16 replica of X at its seed-1 init and cut into
    take groups (exp_r4.py:427-445)."""
    fv = SyncForce2Vec(graph, BENCH_CONFIG, min_width, hub_width, device=dev)
    lay = fv.layout
    xg = fv.init_embedding(seed=1).to(torch.bfloat16)
    dim = BENCH_CONFIG.dim
    rows_per_group, groups, t_rows = take_group_shape(
        lay.padded_edges, dim, xg.element_size(), TILE_K, group_bytes)
    flat = np.concatenate([b.nbr.reshape(-1) for b in lay.buckets])
    ids = torch.as_tensor(flat[:groups * rows_per_group].astype(np.int32),
                          device=dev)
    tiles = xg[ids.long()].reshape(groups, t_rows, TILE_K, dim)
    return tiles, ids, xg


def exp_sweepfloor(graph, device, group_bytes=None, min_width=MIN_WIDTH,
                   hub_width=HUB_WIDTH) -> list:
    dev = torch.device(device)
    tiles, ids, xg = sweepfloor_tiles(graph, dev, group_bytes, min_width,
                                      hub_width)
    groups, t_rows = tiles.shape[:2]
    rows_per_group = t_rows * TILE_K
    nbytes = tiles.numel() * tiles.element_size()
    shape = dict(groups=groups, rows_per_group=rows_per_group, t_rows=t_rows,
                 mb=nbytes / 1e6)

    ms = _ms(dev, lambda: tiles + 1)
    out = [dict(exp="sweepfloor", variant="copy_rw", ms=ms,
                gb_per_s=_per_s(2 * nbytes, ms, 1e9), **shape)]

    err = max(_max_err(pk.read_sum(t), pk.read_sum_plain(t)) for t in tiles)

    def read():
        for t in tiles:
            pk.read_sum(t)

    def library():
        for t in tiles:
            t.sum((0, 1), dtype=torch.float32)

    ms, q_ms = _ms(dev, read), _queued_ms(dev, read)
    out.append(dict(exp="sweepfloor", variant="read_sum", max_abs_err=err,
                    ms=ms, queued_ms=q_ms,
                    gb_per_s=_per_s(nbytes, q_ms, 1e9),
                    library_ms=_ms(dev, library),
                    library_queued_ms=_queued_ms(dev, library), **shape))

    whole = tiles.reshape(-1, TILE_K, tiles.shape[-1])
    ms = _ms(dev, lambda: pk.read_sum(whole))
    out.append(dict(exp="sweepfloor", variant="read_sum_whole",
                    max_abs_err=_max_err(pk.read_sum(whole),
                                         pk.read_sum_plain(whole)),
                    ms=ms, gb_per_s=_per_s(nbytes, ms, 1e9),
                    library_ms=_ms(dev, lambda: whole.sum(
                        (0, 1), dtype=torch.float32)), **shape))

    spans = ids.split(rows_per_group)

    def take():
        for s in spans:
            torch.index_select(xg, 0, s)

    ms, q_ms = _ms(dev, take), _queued_ms(dev, take)
    out.append(dict(exp="sweepfloor", variant="take_static", ms=ms,
                    queued_ms=q_ms,
                    m_rows_per_s=_per_s(ids.numel(), q_ms, 1e6), **shape))
    return out


# -- sweepvar: the tdist sweep three ways ------------------------------------------


def sweep_setup(graph, dev, min_width=MIN_WIDTH, hub_width=HUB_WIDTH):
    """(fv, x, xg, xis): the bench ``SyncForce2Vec`` on ``dev``, X at its
    seed-1 init, its bf16 replica, and each device bucket's xi rows (a view
    of X for a bucket, the owners' rows for the hub)."""
    fv = SyncForce2Vec(graph, BENCH_CONFIG, min_width, hub_width, device=dev)
    x = fv.init_embedding(seed=1)
    xis = [x[b.start: b.start + b.nbr.shape[0]] if b.owner_off is None
           else x[b.xi_row.long()] for b in fv.device_buckets]
    return fv, x, x.to(torch.bfloat16), xis


def exp_sweepvar(graph, device, min_width=MIN_WIDTH, hub_width=HUB_WIDTH,
                 parity_bucket=2) -> list:
    dev = torch.device(device)
    fv, x, xg, xis = sweep_setup(graph, dev, min_width, hub_width)
    model, buckets = fv.model, fv.device_buckets

    def edge_args(b):
        return (model, x, xg, b.nbr, b.deg, b.xi_row, fv.inv_deg, STEP)

    def cuda():
        for b in buckets:
            fk.ell_edge_force(*edge_args(b))

    # tc: the buckets' tiles gathered into buffers that one work table
    # launch sweeps
    tiles = [torch.empty((*b.nbr.shape, x.shape[1]), dtype=xg.dtype,
                         device=dev) for b in buckets]
    work = pk.tile_work_table([(xi, t, b.deg)
                               for b, xi, t in zip(buckets, xis, tiles)])

    def tc():
        for b, t in zip(buckets, tiles):
            torch.index_select(xg, 0, b.nbr.view(-1),
                               out=t.view(-1, t.shape[-1]))
        pk.tile_force_tc_table(work, STEP)

    def plain():
        for b in buckets:
            fk.ell_edge_force_plain(*edge_args(b))

    # The plain sweep is timed back to back only: five of them queued
    # behind the sleep kernel block the host until the sleep ends (seen on
    # an H100; one queues without blocking), so its queued_ms is None.
    out = [dict(exp="sweepvar", kind=kind, ms=_ms(dev, fn, reps),
                queued_ms=_queued_ms(dev, fn) if queued else None,
                buckets=len(buckets))
           for kind, fn, reps, queued in (("cuda", cuda, REPS, True),
                                          ("tc", tc, REPS, True),
                                          ("plain", plain, PLAIN_REPS, False))]
    b, xi = buckets[parity_bucket], xis[parity_bucket]
    got = pk.tile_force_tc(xi, xg[b.nbr.long()], b.deg, STEP)
    out.append(dict(exp="sweepvar", kind="mxu_parity", bucket=parity_bucket,
                    rows=int(b.nbr.shape[0]), width=int(b.nbr.shape[1]),
                    max_err=_max_err(got, fk.ell_edge_force(*edge_args(b)))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("exps", nargs="*", choices=EXPERIMENTS, default=None)
    args = ap.parse_args(argv)
    exps = args.exps or EXPERIMENTS
    if not torch.cuda.is_available():
        print("probes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power()
    print(card, flush=True)
    graph = (synth_powerlaw_graph()
             if {"sweepvar", "sweepfloor"} & set(exps) else None)
    run = {"vmem_take": lambda: exp_vmem_take(dev),
           "sweepvar": lambda: exp_sweepvar(graph, dev),
           "dg": lambda: exp_dg(dev),
           "sweepfloor": lambda: exp_sweepfloor(graph, dev)}
    for name in exps:
        for rec in run[name]():
            print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
