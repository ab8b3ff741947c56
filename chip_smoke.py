"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py        # from the repository root, one card

Drives ``force2vec_tpu_torch``'s three sync paths at full width, on
``bench.py``'s graph (131,072-vertex power-law graph, 2,097,122 edges) with
its configuration (dim 128, ns 5, bf16 gathers, min_width 8,
hub_width 128), the benchmark probes (``tools/probes.py``) at the
shapes the JAX tools ran, and the file path from a graph file to scores:

1. checks for a card and prints its name and power limit;
2. builds the CUDA kernels from ``force2vec_tpu_torch/ops/csrc`` with nvcc
   and checks that the main path's instances spill nothing;

the main path, tdist with 256-row group-shared negatives (``-option 5``):

3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the path gives it, elementwise and for every separable model, and
   times both: ``ell_edge_force`` as the path runs it, one launch over the
   layout's work table (every bucket, the hub included), back to back and
   queued ahead of the device, beside its per-bucket launches; then shows
   that the same bound rejects four planted faults;
4. runs one iteration through the kernels and through the plain versions
   from the same X and negatives, and times both;
5. trains 50 iterations through the kernels, checks the launch counts (one
   edge launch per iteration), that X is finite, and that edges end closer
   than random pairs;

path A, tdist with per-vertex negatives (``-option 5 -bs 1``):

6. holds ``ell_sample_force`` against its plain version at ``[n_pad, ns]``
   for the tdist, sigmoid and layout sample forces, shows that adding into
   ``out`` (``accumulate=True``, as the path runs it) equals ``out.add_``
   of its result bit for bit, times it, and shows that the bound rejects
   two planted faults;
7. one iteration both ways, timed, with one ``add_`` (X += update) and no
   other; 50 training iterations with exact launch counts, X finite, edges
   closer than random pairs;

path B, ``rwalk`` (``-option 7``, walk length 5, group-shared negatives):

8. draws walks on the card and checks that every step lands on a
   neighbour and that steps pick slots uniformly;
9. 50 training iterations with exact launch counts, X finite, and edges
   with a larger mean dot product than random pairs;
10. at the trained X, holds the walk attraction launch against its plain
    version, and runs one iteration with injected walks both ways, timed;

path C, the probes (``python3 -m force2vec_tpu_torch.tools.probes``):

11. runs the four experiments (vmem_take, sweepvar, dg, sweepfloor) with
    exact launch counts, and checks the take-group shape and each parity
    field;
12. holds ``take_sum``, ``tile_force_tc``, ``resident_gather`` and
    ``read_sum`` against their plain versions at the probes' shapes (each
    with its stated bound), shows that each bound rejects a planted fault
    (two for each ring kernel: ``take_sum`` with the last of K rows
    skipped and with each ring stage consumed one row short,
    ``tile_force_tc``'s one launch over the 13 bucket tiles with each
    row's last slot skipped and with its first entry skipped), and times
    kernel, plain version and library call; ``take_sum`` at each ring
    depth tried, with its gathered rows/s and TB/s from L2.

path D, the file path (a graph file in, an ``.embd`` out, scored), at the
main path's configuration:

13. writes the bench graph with ``write_mtx`` and reads it back with
    ``load_graph``: the native parser (built with g++ at first use), the
    same rowptr and colids;
14. trains 50 iterations on the loaded graph with exact launch counts, X
    finite, edges closer than random pairs;
15. writes the ``.embd`` with the native writer and reads it back, every
    value within the text's rounding;
16. scores the read-back X and a random-normal control X on the card:
    link prediction (``link_prediction_dataset`` then ``fit_and_score``,
    the two halves of ``link_prediction_scores``, timed apart) and
    reconstruction accuracy over 1,000 vertices; then the KMeans sweep of
    ``clustering_scores`` over k in [2, 9).

The quality margins are half of what the JAX package reaches on the CPU
with the same graph, configuration and iteration count
(``scripts/jax_quality_reference.py``).  Every phase raises on failure, so
any failure exits non-zero.  The line before the last is a JSON record of
the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from force2vec_tpu_torch.eval.clustering import clustering_scores
from force2vec_tpu_torch.eval.linkpred import (fit_and_score,
                                               link_prediction_dataset)
from force2vec_tpu_torch.eval.reconstruction import (
    graph_reconstruction_accuracy)
from force2vec_tpu_torch.graphs import io as gio
from force2vec_tpu_torch.graphs import (load_graph, native, read_embeddings,
                                        synth_powerlaw_graph)
from force2vec_tpu_torch.graphs.tools import write_mtx
from force2vec_tpu_torch.models.forces import MAXBOUND, get_model
from force2vec_tpu_torch.ops import _build, force_kernels as fk
from force2vec_tpu_torch.ops import probe_kernels as pk
from force2vec_tpu_torch.tools import (BENCH_CONFIG, HUB_WIDTH, MIN_WIDTH,
                                      card_name_and_power, cuda_ms, probes,
                                      queued_device_ms)
from force2vec_tpu_torch.train.sync import DeviceBucket, SyncForce2Vec

TRAIN_ITERS = 50
# Kernel and plain version see the same bf16 inputs and compute in f32; only
# the summation order differs.  Two bounds hold for every output element:
# max |err| (tdist, the main path) and, for every model, the elementwise
#   |got - Σ terms| ≤ SUM_RTOL · Σ |terms|
# over the per-slot or per-sample forces the plain version sums.  Reordering
# a sum of K f32 terms moves it by at most ~K · 2^-24 · Σ|terms| (7.6e-6 at
# K = 128); the reordered warp sum inside each term moves it by less.  The
# bound scales with each element's own terms, so the few large clamped
# self-samples do not loosen it for the rest, and a row with no terms must
# be exactly 0.  ``planted_fault_ratios`` and
# ``sample_planted_fault_ratios`` show it rejects 1%-size faults.
EDGE_TOL = 1e-4
REP_TOL = 1e-5
SUM_RTOL = 1e-5
# tile_force_tc rounds each squared difference to TF32 (2^-11 of itself),
# which moves each term by at most 2^-11 of itself
# (csrc/tile_force_tc.cu): the same bound, widened by that much.
TC_RTOL = SUM_RTOL + 2.0**-11
# read_sum is held to a float64 sum of the same tile: a sum whose every
# term passes through at most n f32 additions is off by at most
# γ_n = n·u/(1 − n·u) of Σ|terms|, u = 2^-24, and read_sum_plan counts n
# for the kernel's blocks (284 for a take group of 64,368 rows).
F32_UNIT = 2.0**-24
ITER_TOL = 1e-3  # bench.py's on-chip kernel-vs-plain bound
# Quality after 50 iterations: half of what the JAX package reaches on the
# CPU with the same configuration, graph and pair sample
# (scripts/jax_quality_reference.py, PERF.md §9.6).  Mean random-pair minus
# mean edge distance: tdist 0.8205 (group-shared) and 0.8213 (-bs 1).
# rwalk, a sigmoid model, is held to the statistic it optimises, mean
# x_i·x_j over edges minus over random pairs: 0.0273 with seed 1 (0.0241
# and 0.0244 with seeds 2 and 3), clearly positive.
QUALITY_MARGIN = 0.41
PV_QUALITY_MARGIN = 0.41
RWALK_DOT_MARGIN = 0.0136
QUALITY_PAIRS = 100_000
# Path D's scores, half of the JAX package's margins on the CPU for tdist
# after 50 iterations (scripts/jax_quality_reference.py, scikit-learn):
# link-prediction AUC 0.7356724519302614 (margin over 0.5: 0.2357);
# reconstruction accuracy over 1,000 vertices 0.02461148112908341 against
# 0.00012686330478908975 for the control X (margin 0.0245).  The control's
# AUC there: 0.5003783300419666.
JAX_LINKPRED_AUC = 0.7356724519302614
JAX_RECON = 0.02461148112908341
JAX_RECON_CONTROL = 0.00012686330478908975
AUC_MARGIN = 0.5 * (JAX_LINKPRED_AUC - 0.5)
RECON_MARGIN = 0.5 * (JAX_RECON - JAX_RECON_CONTROL)
CONTROL_AUC_TOL = 0.02  # the control X's AUC lies within 0.5 ± this
CONTROL_SEED = 0  # numpy seed of the [n, 128] standard-normal control X
RECON_VERTICES = 1000
CLUSTER_KS = range(2, 9)
# ``%.6g`` keeps 6 significant digits: off by at most 5e-6 of the value,
# and the f32 parse of the text adds at most 2^-24 of it more
EMBD_RTOL = 5e-6 + 2.0**-24
EMBD_ATOL = 1e-30
# slot-0 share of the first walk step against its expectation (its
# sampling spread is ~7e-4 over the bench graph's 131,072 rows)
WALK_UNIFORM_TOL = 0.01
# The card's peaks for bound_ms (H100 SXM at 700 W): device memory, and
# f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

EDGE_SOURCE = "force2vec_tpu_torch/ops/csrc/ell_edge_force.cu"
REP_SOURCE = "force2vec_tpu_torch/ops/csrc/grouped_rep_force.cu"
SAMPLE_SOURCE = "force2vec_tpu_torch/ops/csrc/ell_sample_force.cu"
EDGE_REPLACES = "force2vec_tpu/ops/pallas_force.py:218"
REP_REPLACES = "force2vec_tpu/ops/pallas_force.py:103"
SAMPLE_REPLACES = "force2vec_tpu/ops/pallas_force.py:264"
PROBES = {  # kernel: (source, TPU function it replaces)
    "take_sum": ("force2vec_tpu_torch/ops/csrc/take_sum.cu",
                 "benchmarks/exp_r3.py:146"),
    "tile_force_tc": ("force2vec_tpu_torch/ops/csrc/tile_force_tc.cu",
                      "benchmarks/exp_r3.py:638"),
    "resident_gather": ("force2vec_tpu_torch/ops/csrc/resident_gather.cu",
                        "benchmarks/exp_r4.py:127"),
    "read_sum": ("force2vec_tpu_torch/ops/csrc/read_sum.cu",
                 "benchmarks/exp_r4.py:470"),
}
# every __global__ function in ops/csrc, each of which must show in the
# ptxas report
CUDA_KERNELS = ("ell_edge_force_kernel", "grouped_rep_force_kernel",
                "ell_sample_force_kernel", "take_sum_kernel",
                "tile_force_tc_kernel", "resident_gather_kernel",
                "read_sum_partial_kernel", "read_sum_final_kernel")
# the instances the main path and path A run (bf16 replica, tdist), and
# the ring kernels' instances, which must spill nothing
MAIN_INSTANCES = ("ell_edge_force_kernel<bf16, 0>",
                  "ell_sample_force_kernel<bf16, 0>",
                  "grouped_rep_force_kernel<bf16, 4, 0>")
RING_INSTANCES = ("take_sum_kernel<bf16>", "take_sum_kernel<f32>",
                  "tile_force_tc_kernel<bf16>", "tile_force_tc_kernel<f32>")
# take_sum's ring depths (stages per block) timed
TAKE_DEPTHS = (2, 3, 4)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def say(*args):
    print(*args, flush=True)


def ptxas_summary(log: str) -> list:
    """One line per kernel instance from nvcc's ``-Xptxas=-v`` output:
    ``kernel<template arguments>: registers; spills``, e.g.
    ``ell_edge_force_kernel<bf16, 0>`` (replica, model) or
    ``resident_gather_kernel<16>``."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d([a-z_]+_kernel)I(\w+?)EEv",
                      line)
        if m:
            args = re.sub(r"Li(\d+)E?", r", \1", m[2])
            args = args.replace("13__nv_bfloat16", "bf16")
            args = re.sub(r"^f(?=,|$)", "f32", args).lstrip(", ")
            name, spill = f"{m[1]}<{args}>", ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def bound_ratio(got, terms, rtol: float = SUM_RTOL) -> float:
    """max over elements of |got - Σ terms| / (rtol · Σ |terms|), the sums
    over dim 1; at most 1 passes.  An element whose terms are all 0 gives
    inf unless ``got`` is exactly 0 there."""
    err = (got - terms.sum(dim=1)).abs()
    scale = rtol * terms.abs().sum(dim=1)
    return float(torch.where(err == 0, 0.0, err / scale).max())


# -- the least time the card could take ---------------------------------------


def term_flops(model, kind: str, dim: int) -> int:
    """f32 operations of one edge or sample term, from the kernels' loops:
    the per-pair scalar (a dot or a squared distance) and the update."""
    if kind == "edge":
        return (4 if model.a_kind == "dot" else 5) * dim
    # tdist (clamped), sigmoid, layout: common.cuh::add_sample_force
    return (8, 4, 5)[fk._SAMPLE_MODEL_IDS[model.sample_force]] * dim


def ell_work(launches, x, xg, with_invd: bool, reads_out: bool = False):
    """(bytes, terms) that ``ell_edge_force`` or ``ell_sample_force`` over
    the launches ``(idx, deg, xi_row)`` must move and compute: each input
    read once (the x and replica rows they touch, the real slots' ids, deg,
    xi_row, for the edge force invd and, adding into ``out``, the output
    rows) and each output row written once.  Slots past deg are skipped,
    so they count nothing."""
    dim = x.shape[1]
    xi = torch.cat([r for _, _, r in launches]).unique().numel()
    real = torch.cat([
        idx[torch.arange(idx.shape[1], device=idx.device)[None, :]
            < deg[:, None]] for idx, deg, _ in launches])
    rows = sum(r.numel() for _, _, r in launches)
    nbytes = (xi * dim * 4 + (xi * 4 if with_invd else 0)
              + real.unique().numel() * dim * xg.element_size()
              + real.numel() * 4 + rows * 8
              + rows * dim * 4 * (2 if reads_out else 1))
    return nbytes, real.numel()


def bound_ms(nbytes: float, flops: float):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / F32_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# -- kernel checks -------------------------------------------------------------


def bench_samples(fv, xg, seed):
    """``[ng, ns, D]`` group samples from the bench layout's negative range."""
    ng = -(-fv.layout.n_pad // BENCH_CONFIG.batch_size)
    negs = torch.randint(0, fv.layout.n - 1, (ng, BENCH_CONFIG.ns),
                         generator=torch.Generator(xg.device).manual_seed(seed),
                         device=xg.device)
    return xg[negs]


def check_edge(model, x, xg, b, invd, step, what):
    """One ``ell_edge_force`` launch against the plain terms; returns
    (max |err|, bound ratio)."""
    args = (model, x, xg, b.nbr, b.deg, b.xi_row, invd, step)
    got = fk.ell_edge_force(*args)
    terms = fk.ell_edge_force_terms(*args)
    e, ratio = max_err(got, terms.sum(dim=1)), bound_ratio(got, terms)
    check(ratio <= 1.0, f"ell_edge_force {what}: |err| exceeds {SUM_RTOL} x "
                        f"sum |terms| by {ratio:.3f}x")
    return e, ratio


def check_rep(model, x, sg, step, what):
    """One ``grouped_rep_force`` launch against the plain terms; returns
    (max |err|, bound ratio)."""
    group = BENCH_CONFIG.batch_size
    got = fk.grouped_rep_force(model, group, x, sg, step)
    terms = fk.grouped_rep_force_terms(model, group, x, sg, step)
    e, ratio = max_err(got, terms.sum(dim=1)), bound_ratio(got, terms)
    check(ratio <= 1.0, f"grouped_rep_force {what}: |err| exceeds {SUM_RTOL} "
                        f"x sum |terms| by {ratio:.3f}x")
    return e, ratio


def check_sample(model, x, xg, idx, deg, rows, step, what):
    """One ``ell_sample_force`` launch against the plain terms; returns
    (max |err|, bound ratio)."""
    args = (model, x, xg, idx, deg, rows, step)
    got = fk.ell_sample_force(*args)
    terms = fk.ell_sample_force_terms(*args)
    e, ratio = max_err(got, terms.sum(dim=1)), bound_ratio(got, terms)
    check(ratio <= 1.0, f"ell_sample_force {what}: |err| exceeds {SUM_RTOL} "
                        f"x sum |terms| by {ratio:.3f}x")
    return e, ratio


def check_table(model, x, xg, table, invd, step, what):
    """One ``ell_edge_force_table`` launch against the per-entry plain
    terms, over every entry (each bucket, the hub's virtual rows, and the
    width-0 entry, whose rows must be exactly 0); returns (max |err|,
    bound ratio)."""
    got = fk.ell_edge_force_table(model, x, xg, table, invd, step)
    err = ratio = 0.0
    for nbr, deg, xi_row, ob in table.parts():
        terms = fk.ell_edge_force_terms(model, x, xg, nbr, deg, xi_row, invd,
                                        step)
        part = got[ob: ob + nbr.shape[0]]
        err = max(err, max_err(part, terms.sum(dim=1)))
        ratio = max(ratio, bound_ratio(part, terms))
        del terms
    check(ratio <= 1.0, f"ell_edge_force_table {what}: |err| exceeds "
                        f"{SUM_RTOL} x sum |terms| by {ratio:.3f}x")
    return err, ratio


def edge_phase(fv, x, xg, card):
    """Edge kernel vs plain: each per-bucket launch of the bench layout,
    then the one work-table launch the path runs, for every separable
    model; times the table launch back to back and queued."""
    bucket_ms = 0.0
    for b in fv.device_buckets:
        kind = "hub" if b.owner_local is not None else "bucket"
        what = f"{kind} width {b.nbr.shape[1]}"
        e, ratio = check_edge(fv.model, x, xg, b, fv.inv_deg, fv.lr, what)
        check(e <= EDGE_TOL, f"ell_edge_force {what}: max |err| {e:.3e} > "
                             f"{EDGE_TOL}")
        args = (fv.model, x, xg, b.nbr, b.deg, b.xi_row, fv.inv_deg, fv.lr)
        km = cuda_ms(lambda: fk.ell_edge_force(*args))
        say(f"ell_edge_force {kind} width={b.nbr.shape[1]} rows="
            f"{b.nbr.shape[0]} max_abs_err={e:.3e} bound_ratio={ratio:.4f} "
            f"kernel_ms={km:.4f} [{card}]")
        bucket_ms += km
    t = fv.edge_table
    err = 0.0
    for name in ("tdist", "sigmoid", "fr", "linlog", "forceatlas"):
        step = fv.lr if name == "tdist" else 0.02
        e, ratio = check_table(get_model(name), x, xg, t, fv.inv_deg, step,
                               name)
        say(f"ell_edge_force table ({len(t.entries)} entries, "
            f"{t.out_rows} output rows) {name}: max_abs_err={e:.3e} "
            f"bound_ratio={ratio:.4f}")
        if name == "tdist":
            check(e <= EDGE_TOL, f"ell_edge_force_table: max |err| {e:.3e} > "
                                 f"{EDGE_TOL}")
            err = e
    args = (fv.model, x, xg, t, fv.inv_deg, fv.lr)
    km = cuda_ms(lambda: fk.ell_edge_force_table(*args), reps=20)
    qm = queued_device_ms(lambda: fk.ell_edge_force_table(*args), reps=20)
    pm = cuda_ms(lambda: fk.ell_edge_force_table_plain(*args), reps=3)
    nbytes, terms = ell_work([p[:3] for p in t.parts()], x, xg, True)
    b_ms, by = bound_ms(nbytes, terms * term_flops(fv.model, "edge",
                                                   x.shape[1]))
    say(f"ell_edge_force table, one launch: kernel_ms={km:.4f} queued="
        f"{qm:.4f} ({terms / qm / 1e6:.2f} G neighbour rows/s) plain_ms="
        f"{pm:.4f}; the {len(fv.device_buckets)} per-bucket launches: "
        f"{bucket_ms:.4f}; bound_ms={b_ms:.4f} ({by}: {nbytes / 1e6:.1f} MB, "
        f"{terms} terms) [{card}]")
    return dict(max_abs_err=err, ms=km, queued_ms=qm, plain_ms=pm,
                bound_ms=b_ms, bound_by=by)


def widest_bucket(fv):
    """The non-hub bucket with the most rows."""
    return max((b for b in fv.device_buckets if b.owner_local is None),
               key=lambda b: b.nbr.shape[0])


def other_models_phase(fv, x, xg):
    """The other separable models through both kernels, at one bucket."""
    b = widest_bucket(fv)
    sg = bench_samples(fv, xg, seed=3)
    for name in ("sigmoid", "fr", "linlog", "forceatlas"):
        model = get_model(name)
        e, ratio = check_edge(model, x, xg, b, fv.inv_deg, 0.02, name)
        er, ratio_r = check_rep(model, x, sg, 0.02, name)
        say(f"model {name}: edge max_abs_err={e:.3e} bound_ratio="
            f"{ratio:.4f}, rep max_abs_err={er:.3e} bound_ratio={ratio_r:.4f}")


def rep_phase(fv, x, xg, card):
    """Repulsion kernel vs plain at the bench shape."""
    sg = bench_samples(fv, xg, seed=5)
    e, ratio = check_rep(fv.model, x, sg, fv.lr, "tdist")
    check(e <= REP_TOL, f"grouped_rep_force: max |err| {e:.3e} > {REP_TOL}")
    args = (fv.model, BENCH_CONFIG.batch_size, x, sg, fv.lr)
    km = cuda_ms(lambda: fk.grouped_rep_force(*args), reps=20)
    pm = cuda_ms(lambda: fk.grouped_rep_force_plain(*args), reps=5)
    n, dim = x.shape
    nbytes = 2 * n * dim * 4 + sg.numel() * sg.element_size()
    b_ms, by = bound_ms(nbytes, n * sg.shape[1]
                        * term_flops(fv.model, "sample", dim))
    say(f"grouped_rep_force rows={n} groups={sg.shape[0]} "
        f"max_abs_err={e:.3e} bound_ratio={ratio:.4f} kernel_ms={km:.4f} "
        f"plain_ms={pm:.4f} bound_ms={b_ms:.4f} ({by}: "
        f"{nbytes / 1e6:.1f} MB) [{card}]")
    return dict(max_abs_err=e, ms=km, plain_ms=pm, bound_ms=b_ms, bound_by=by)


def _tdist_rep_r_squared(xi, s, step, rsum=None, mask=None):
    """Planted fault: tdist repulsion with 2/r² in place of 2/(r(1+r)), off
    by a factor 1 + 1/r (about 1.2% at the bench init, r ≈ 85)."""
    diff = xi - s
    r = torch.sum(diff * diff, dim=-1, keepdim=True)
    d1 = torch.where(r > 0.0, 2.0 / torch.where(r > 0.0, r * r, 1.0), 0.0)
    return step * torch.clamp(d1 * diff, -MAXBOUND, MAXBOUND)


def planted_fault_ratios(model, group, x, xg, b, invd, sg, step):
    """Bound ratios of the wrappers' outputs against two faulty plain
    versions: repulsion with 2/r² (``_tdist_rep_r_squared``), and attraction
    reading x_i from the bf16 replica instead of f32 X.  A bound that can
    catch such a kernel gives both ratios above 1."""
    rep = fk.grouped_rep_force(model, group, x, sg, step)
    bad = dataclasses.replace(model, sample_force=_tdist_rep_r_squared)
    rep_ratio = bound_ratio(
        rep, fk.grouped_rep_force_terms(bad, group, x, sg, step))
    args = (b.nbr, b.deg, b.xi_row, invd, step)
    edge = fk.ell_edge_force(model, x, xg, *args)
    edge_ratio = bound_ratio(
        edge, fk.ell_edge_force_terms(model, xg.float(), xg, *args))
    return rep_ratio, edge_ratio


def sample_planted_fault_ratios(model, x, xg, idx, deg, rows, step):
    """Bound ratios of ``ell_sample_force``'s output against two faulty
    plain versions: x_i read from the bf16 replica, and the last sample of
    each row skipped.  Both must be above 1."""
    got = fk.ell_sample_force(model, x, xg, idx, deg, rows, step)
    bf16_xi = bound_ratio(got, fk.ell_sample_force_terms(
        model, xg.float(), xg, idx, deg, rows, step))
    skip_last = bound_ratio(got, fk.ell_sample_force_terms(
        model, x, xg, idx, (deg - 1).clamp(min=0), rows, step))
    return bf16_xi, skip_last


def table_planted_fault_ratios(model, x, xg, table, invd, step):
    """Bound ratios of the work-table launch's output against two faulty
    plain versions aimed at its design: each warp's second row dropped
    (with a bf16 replica a warp holds two rows: deg 0 on each entry's odd
    rows), and the first entry (the widest: the hub's) skipped.  Both must
    be above 1."""
    got = fk.ell_edge_force_table(model, x, xg, table, invd, step)

    def ratio(fault):
        worst = 0.0
        for k, (nbr, deg, xi_row, ob) in enumerate(table.parts()):
            terms = fk.ell_edge_force_terms(model, x, xg, nbr, fault(k, deg),
                                            xi_row, invd, step)
            worst = max(worst, bound_ratio(got[ob: ob + nbr.shape[0]], terms))
            del terms
        return worst

    def second_row_dropped(k, deg):
        deg = deg.clone()
        deg[1::2] = 0
        return deg

    return (ratio(second_row_dropped),
            ratio(lambda k, deg: deg * 0 if k == 0 else deg))


def planted_fault_phase(fv, x, xg):
    """The elementwise bound rejects plausible kernel faults."""
    rep_ratio, edge_ratio = planted_fault_ratios(
        fv.model, BENCH_CONFIG.batch_size, x, xg, widest_bucket(fv),
        fv.inv_deg, bench_samples(fv, xg, seed=5), fv.lr)
    say(f"planted faults: repulsion 2/r^2 bound_ratio={rep_ratio:.2f}, "
        f"attraction with bf16 x_i bound_ratio={edge_ratio:.2f} (must be > 1)")
    check(rep_ratio > 1.0, "the bound passed a repulsion with 2/r^2")
    check(edge_ratio > 1.0, "the bound passed an attraction with bf16 x_i")
    dropped, skipped = table_planted_fault_ratios(
        fv.model, x, xg, fv.edge_table, fv.inv_deg, fv.lr)
    say(f"planted faults: work table with each warp's second row dropped "
        f"bound_ratio={dropped:.2f}, with its first entry skipped "
        f"bound_ratio={skipped:.2f} (must be > 1)")
    check(dropped > 1.0, "the bound passed a table launch that drops each "
                         "warp's second row")
    check(skipped > 1.0, "the bound passed a table launch that skips its "
                         "first entry")


# -- one iteration, training, quality ------------------------------------------


def count_ops(fn, name: str) -> int:
    """How many times ``fn()`` calls the torch operator ``name``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name == name)


def iteration_phase(fv, x0, card, negs, walks=None, adds=None):
    """One iteration through the kernels and through the plain versions,
    from the same X, negatives and walks, checking that it calls ``add_``
    ``adds`` times if given; returns (kernel ms, plain ms)."""
    if adds is not None:
        got = count_ops(lambda: fv.run_iteration(x0.clone(), negs,
                                                 walks=walks), "aten::add_")
        say(f"iteration add_ calls: {got} (expected {adds})")
        check(got == adds, f"an iteration calls add_ {got} times, not {adds}")
    a = fv.run_iteration(x0.clone(), negs, walks=walks)
    b = fv.run_iteration(x0.clone(), negs, walks=walks, plain=True)
    e = max_err(a, b)
    check(bool(torch.isfinite(a).all()), "iteration: non-finite X")
    check(e < ITER_TOL, f"iteration kernels vs plain: max |err| {e:.3e}")
    say(f"iteration kernels vs plain: max_abs_err={e:.3e}")
    negs_t = torch.as_tensor(negs, device=x0.device)
    xk, xp = x0.clone(), x0.clone()
    # plain, kernels, kernels, plain: one card, in turns
    times = {"plain": [], "kernels": []}
    for mode in ("plain", "kernels", "kernels", "plain"):
        xw = xp if mode == "plain" else xk
        times[mode].append(cuda_ms(
            lambda: fv.run_iteration(xw, negs_t, walks=walks,
                                     plain=mode == "plain"),
            reps=10 if mode == "kernels" else 3))
    k_ms, p_ms = np.mean(times["kernels"]), np.mean(times["plain"])
    say(f"iteration_ms kernels={times['kernels']} plain={times['plain']} "
        f"[{card}]")
    # the same iterations queued ahead of the device: the time once the
    # host's launch cost, which varies with the host's load, is out of it
    q_ms = queued_device_ms(
        lambda: fv.run_iteration(xk, negs_t, walks=walks), reps=10)
    say(f"iteration_ms kernels queued ahead of the device={q_ms:.4f} "
        f"[{card}]")
    return k_ms, p_ms


def train_phase(fv, expect, card):
    """``train()`` for TRAIN_ITERS iterations with the launch counts set to
    0 just before; checks the counts equal ``expect`` (the probe kernels
    0) and that X is finite.  Returns the [n, D] embedding and the
    counts."""
    reset_counts()
    emb = fv.train(iters=TRAIN_ITERS, seed=1)
    counts = read_counts()
    expect = {**{k: 0 for k in pk.launch_counts}, **expect}
    train_ms = fv.last_train_seconds * 1e3 / TRAIN_ITERS
    say(f"train {TRAIN_ITERS} iterations: {fv.last_train_seconds:.3f} s, "
        f"{train_ms:.4f} ms/iteration (host clock), launches {counts} "
        f"[{card}]")
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(tuple(emb.shape) == (fv.graph.n, fv.config.dim),
          f"embedding shape {tuple(emb.shape)}")
    check(bool(torch.isfinite(emb).all()), "trained X is not finite")
    return emb, counts


def reset_counts():
    fk.reset_launch_counts()
    pk.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launch count: the force kernels' and the probes'."""
    return {**fk.launch_counts, **pk.launch_counts}


def quality(graph, emb):
    """Mean distance and mean dot product over the edges and over
    QUALITY_PAIRS random pairs, in f64."""
    dev = emb.device
    src = torch.repeat_interleave(
        torch.arange(graph.n, device=dev),
        torch.as_tensor(graph.degrees, device=dev))
    dst = torch.as_tensor(graph.colids, device=dev).long()
    emb = emb.double()
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(0, graph.n, QUALITY_PAIRS), device=dev)
    b = torch.as_tensor(rng.integers(0, graph.n, QUALITY_PAIRS), device=dev)
    return dict(
        d_edge=float((emb[src] - emb[dst]).norm(dim=1).mean()),
        d_rand=float((emb[a] - emb[b]).norm(dim=1).mean()),
        dot_edge=float((emb[src] * emb[dst]).sum(dim=1).mean()),
        dot_rand=float((emb[a] * emb[b]).sum(dim=1).mean()))


def distance_gap_check(graph, emb, margin, what):
    q = quality(graph, emb)
    gap = q["d_rand"] - q["d_edge"]
    say(f"quality {what} after {TRAIN_ITERS} iterations: mean edge distance "
        f"{q['d_edge']:.4f}, mean random-pair distance {q['d_rand']:.4f}, "
        f"gap {gap:.4f} (needs > {margin})")
    check(gap > margin, f"{what}: edges are not closer than random pairs by "
                        "the margin")


# -- the main path -------------------------------------------------------------


def main_path(graph, dev, card):
    fv = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev)
    lay = fv.layout
    say(f"graph n={graph.n} nnz={graph.nnz} n_pad={lay.n_pad} "
        f"padded_slots={lay.padded_edges} buckets={len(lay.buckets)} "
        f"hub_rows={sum(b.count for b in lay.buckets if b.owners is not None)}")
    x0 = fv.init_embedding(seed=1)
    xg = x0.to(torch.bfloat16)
    edge = edge_phase(fv, x0, xg, card)
    rep = rep_phase(fv, x0, xg, card)
    other_models_phase(fv, x0, xg)
    planted_fault_phase(fv, x0, xg)
    ng = -(-lay.n_pad // BENCH_CONFIG.batch_size)
    negs = np.random.default_rng(7).integers(
        0, graph.n - 1, size=(ng, BENCH_CONFIG.ns)).astype(np.int32)
    # the repulsion's add_ and X += update
    iter_ms, iter_plain_ms = iteration_phase(fv, x0, card, negs, adds=2)
    updates = graph.nnz + graph.n * BENCH_CONFIG.ns  # bench.py:158-161
    say(f"ms_per_iteration kernels={iter_ms:.4f} plain={iter_plain_ms:.4f} "
        f"(CUDA events) [{card}]")
    say(f"edge_force_updates_per_s kernels={updates / iter_ms / 1e3:.2f} M "
        f"plain={updates / iter_plain_ms / 1e3:.2f} M [{card}]")

    emb, counts = train_phase(fv, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS,
        "ell_sample_force": 0}, card)
    distance_gap_check(graph, emb, QUALITY_MARGIN, "main path")
    return edge, rep, counts, len(fv.device_buckets)


# -- path A: per-vertex negatives ------------------------------------------------


def accumulate_check(model, x, xg, idx, deg, rows, step, what):
    """``ell_sample_force(..., out=base, accumulate=True)`` equals
    ``base.add_(ell_sample_force(...))`` bit for bit."""
    base = torch.randn(x.shape, device=x.device,
                       generator=torch.Generator(x.device).manual_seed(19))
    got = fk.ell_sample_force(model, x, xg, idx, deg, rows, step,
                              out=base.clone(), accumulate=True)
    want = base.add_(fk.ell_sample_force(model, x, xg, idx, deg, rows, step))
    check(torch.equal(got, want), f"ell_sample_force {what}: accumulate=True "
                                  "differs from out.add_")


def per_vertex_path(graph, dev, card):
    cfg = dataclasses.replace(BENCH_CONFIG, per_vertex_samples=True)
    fv = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
    n_pad, ns = fv.layout.n_pad, cfg.ns
    x0 = fv.init_embedding(seed=1)
    xg = x0.to(torch.bfloat16)
    idx = torch.randint(0, graph.n - 1, (n_pad, ns), dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(11),
                        device=dev)
    deg = torch.full((n_pad,), ns, dtype=torch.int32, device=dev)
    rows = torch.arange(n_pad, dtype=torch.int32, device=dev)
    errs = {}
    for name in ("tdist", "sigmoid", "fr"):
        e, ratio = check_sample(get_model(name), x0, xg, idx, deg, rows,
                                fv.lr, name)
        accumulate_check(get_model(name), x0, xg, idx, deg, rows, fv.lr, name)
        say(f"ell_sample_force {name} ({get_model(name).sample_force.__name__}"
            f") rows={n_pad} ns={ns} max_abs_err={e:.3e} bound_ratio="
            f"{ratio:.4f}; accumulate=True bit for bit out.add_")
        errs[name] = e
    err = errs["tdist"]
    check(err <= REP_TOL, f"ell_sample_force: max |err| {err:.3e} > {REP_TOL}")
    args = (fv.model, x0, xg, idx, deg, rows, fv.lr)
    upd = torch.zeros_like(x0)
    # as path A runs it: adding into the update
    km = cuda_ms(lambda: fk.ell_sample_force(*args, out=upd, accumulate=True),
                 reps=20)
    qm = queued_device_ms(lambda: fk.ell_sample_force(
        *args, out=upd, accumulate=True), reps=20)
    store_ms = cuda_ms(lambda: fk.ell_sample_force(*args, out=upd), reps=20)
    pm = cuda_ms(lambda: fk.ell_sample_force_plain(*args, out=upd,
                                                   accumulate=True), reps=5)
    nbytes, terms = ell_work([(idx, deg, rows)], x0, xg, False, True)
    b_ms, by = bound_ms(nbytes, terms * term_flops(fv.model, "sample",
                                                   cfg.dim))
    store_bytes, _ = ell_work([(idx, deg, rows)], x0, xg, False)
    say(f"ell_sample_force tdist, accumulate=True: kernel_ms={km:.4f} "
        f"queued={qm:.4f} plain_ms={pm:.4f} bound_ms={b_ms:.4f} ({by}: "
        f"{nbytes / 1e6:.1f} MB, {terms} terms); storing a new result: "
        f"kernel_ms={store_ms:.4f} bound_ms="
        f"{bound_ms(store_bytes, 0)[0]:.4f} [{card}]")
    bf16_xi, skip_last = sample_planted_fault_ratios(
        fv.model, x0, xg, idx, deg, rows, fv.lr)
    say(f"planted faults: sample force with bf16 x_i bound_ratio="
        f"{bf16_xi:.2f}, last sample skipped bound_ratio={skip_last:.2f} "
        f"(must be > 1)")
    check(bf16_xi > 1.0, "the bound passed a sample force with bf16 x_i")
    check(skip_last > 1.0, "the bound passed a sample force that skips the "
                           "last sample")

    negs = np.random.default_rng(7).integers(
        0, graph.n - 1, size=(n_pad, ns)).astype(np.int32)
    # X += update: the repulsion is added in the kernel
    iter_ms, iter_plain_ms = iteration_phase(fv, x0, card, negs, adds=1)
    say(f"per-vertex ms_per_iteration kernels={iter_ms:.4f} "
        f"plain={iter_plain_ms:.4f} (CUDA events) [{card}]")
    emb, counts = train_phase(fv, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": 0,
        "ell_sample_force": TRAIN_ITERS}, card)
    distance_gap_check(graph, emb, PV_QUALITY_MARGIN, "-bs 1")
    return dict(max_abs_err=err, ms=km, queued_ms=qm, plain_ms=pm,
                bound_ms=b_ms, bound_by=by), counts


# -- path B: rwalk -------------------------------------------------------------


def check_walks(fv, walks):
    """Every step of ``walks`` [n_pad, L] lands on a neighbour of the
    previous position (searched in the sorted src·n_pad + dst keys of the
    relabeled edges), or stays put on a row of degree 0; and the first
    step takes slot 0 of its row as often as a uniform slot draw would.
    Raises on a violation; returns (rows that moved, slot-0 share, its
    expectation)."""
    lay, g, dev = fv.layout, fv.graph, walks.device
    n_pad = lay.n_pad
    src = torch.as_tensor(lay.inv_perm[np.repeat(np.arange(g.n), g.degrees)],
                          device=dev).long()
    dst = torch.as_tensor(lay.inv_perm[g.colids], device=dev).long()
    keys = torch.sort(src * n_pad + dst).values
    deg = torch.as_tensor(lay.deg, device=dev)
    check(tuple(walks.shape) == (n_pad, fv.config.walk_length)
          and walks.dtype == torch.int32, f"walks {tuple(walks.shape)} "
                                          f"{walks.dtype}")
    cur = torch.arange(n_pad, device=dev)
    moved = 0
    for step in range(walks.shape[1]):
        nxt = walks[:, step].long()
        moves = deg[cur] > 0
        check(torch.equal(nxt[~moves], cur[~moves]),
              f"walk step {step}: a row of degree 0 moved")
        k = cur[moves] * n_pad + nxt[moves]
        pos = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        check(bool((keys[pos] == k).all()),
              f"walk step {step}: a target is not a neighbour")
        moved += int(moves.sum())
        cur = nxt
    # slot 0 of row v holds u0 = pool[base[v]]; a uniform draw lands on u0
    # with probability (slots of v holding u0) / deg[v]
    pool = fv.walk_pool.long()
    base = fv.walk_db[:, 1].long()
    d = deg.long()
    multi = torch.nonzero(d > 1).squeeze(1)
    first = pool[base[multi]]
    seg = torch.repeat_interleave(multi, d[multi])
    slot = torch.arange(seg.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(d[multi], 0) - d[multi], d[multi])
    same = torch.zeros(n_pad, device=dev, dtype=torch.float64).index_add_(
        0, seg, (pool[base[seg] + slot] == pool[base[seg]]).double())
    expect = float((same[multi] / d[multi]).mean())
    share = float((walks[multi, 0].long() == first).double().mean())
    check(abs(share - expect) < WALK_UNIFORM_TOL,
          f"walk slot-0 share {share:.4f} vs uniform {expect:.4f}")
    return moved, share, expect


def rwalk_path(graph, dev, card):
    cfg = dataclasses.replace(BENCH_CONFIG, model="rwalk")
    fv = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
    n_pad, wl = fv.layout.n_pad, cfg.walk_length
    gen = torch.Generator(dev).manual_seed(13)
    walks = fv.draw_walks(gen)
    moved, share, expect = check_walks(fv, walks)
    walk_ms = cuda_ms(lambda: fv.draw_walks(gen), reps=10)
    say(f"walks [{n_pad}, {wl}]: {moved} steps land on neighbours, slot-0 "
        f"share {share:.4f} vs uniform {expect:.4f}; walk engine ms="
        f"{walk_ms:.4f} [{card}]")

    emb, counts = train_phase(fv, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS,
        "ell_sample_force": 0}, card)
    q = quality(graph, emb)
    gap = q["dot_edge"] - q["dot_rand"]
    say(f"quality rwalk after {TRAIN_ITERS} iterations: mean edge x_i.x_j "
        f"{q['dot_edge']:.4f}, mean random-pair x_i.x_j {q['dot_rand']:.4f}, "
        f"gap {gap:.4f} (needs > {RWALK_DOT_MARGIN}); distance gap "
        f"{q['d_rand'] - q['d_edge']:.4f}")
    check(gap > RWALK_DOT_MARGIN, "rwalk: edges do not have a larger dot "
                                  "product than random pairs by the margin")

    # The kernel checks run at the trained X: at the [0, 1) init every
    # x_i.x_j is ~32, where 1 - sigmoid is 0 in f32 and the walk attraction
    # vanishes.
    x = fv.pad_embedding(emb)
    xg = x.to(torch.bfloat16)
    b = DeviceBucket(start=0, nbr=walks,
                     deg=torch.full((n_pad,), wl, dtype=torch.int32,
                                    device=dev),
                     xi_row=torch.arange(n_pad, dtype=torch.int32, device=dev))
    e, ratio = check_edge(fv.model, x, xg, b, fv.inv_deg, fv.lr, "walks")
    args = (fv.model, x, xg, b.nbr, b.deg, b.xi_row, fv.inv_deg, fv.lr)
    check(bool(fk.ell_edge_force_plain(*args).abs().max() > 0),
          "the walk attraction is 0 everywhere: the check would be vacuous")
    km = cuda_ms(lambda: fk.ell_edge_force(*args), reps=20)
    pm = cuda_ms(lambda: fk.ell_edge_force_plain(*args), reps=5)
    nbytes, terms = ell_work([(b.nbr, b.deg, b.xi_row)], x, xg, True)
    b_ms, by = bound_ms(nbytes, terms * term_flops(fv.model, "edge",
                                                   cfg.dim))
    say(f"ell_edge_force walks (sigmoid) rows={n_pad} width={wl} "
        f"max_abs_err={e:.3e} bound_ratio={ratio:.4f} kernel_ms={km:.4f} "
        f"plain_ms={pm:.4f} bound_ms={b_ms:.4f} ({by}: {nbytes / 1e6:.1f} "
        f"MB) [{card}]")

    ng = -(-n_pad // cfg.batch_size)
    negs = np.random.default_rng(7).integers(
        0, graph.n - 1, size=(ng, cfg.ns)).astype(np.int32)
    iter_ms, iter_plain_ms = iteration_phase(fv, x, card, negs, walks=walks)
    say(f"rwalk ms_per_iteration (walks injected) kernels={iter_ms:.4f} "
        f"plain={iter_plain_ms:.4f}, walk engine {walk_ms:.4f} more (CUDA "
        f"events) [{card}]")
    return counts


# -- path C: the benchmark probes ---------------------------------------------------


def probes_path(graph, dev, card, buckets):
    """``tools.probes``' four experiments at their full shapes, with exact
    launch counts: each kernel timing is WARMUP + REPS launches (and
    QUEUED_REPS more for the loops: the sweeps and the 40 take groups),
    after one parity launch per case (``take_sum``: 2 dtypes;
    ``resident_gather``: 2 dtypes × 3 H; ``read_sum``: each take group,
    then the whole tile) or per sweep (``ell_edge_force`` and
    ``tile_force_tc``: the mxu_parity bucket).  A sweep is 13 edge
    launches, or one ``tile_force_tc`` launch over the 13 tiles."""
    reset_counts()
    recs = (probes.exp_vmem_take(dev) + probes.exp_sweepvar(graph, dev)
            + probes.exp_dg(dev) + probes.exp_sweepfloor(graph, dev))
    counts = read_counts()
    for r in recs:
        say(f"probe {json.dumps(r)} [{card}]")
    floor = [r for r in recs if r["exp"] == "sweepfloor"]
    shape = (floor[0]["rows_per_group"], floor[0]["groups"],
             floor[0]["t_rows"])
    check(shape == (64368, 40, 4023), f"take groups {shape} != the JAX "
                                      "package's (64368, 40, 4023)")
    timed = probes.WARMUP + probes.REPS
    looped = timed + probes.QUEUED_REPS
    expect = {"ell_edge_force": buckets * looped + 1,
              "grouped_rep_force": 0, "ell_sample_force": 0,
              "take_sum": 2 * (1 + timed), "resident_gather": 6 * (1 + timed),
              "read_sum": shape[1] * (1 + looped) + 1 + timed,
              "tile_force_tc": looped + 1}
    say(f"probes path launches {counts} [{card}]")
    check(counts == expect, f"probe launch counts {counts} != {expect}")
    check(all(r["exact"] for r in recs if r["exp"] == "dg"),
          "resident_gather differs from its plain version")
    errs = [r.get("max_abs_err", r.get("max_err")) for r in recs]
    check(all(np.isfinite(e) for e in errs if e is not None),
          "a probe's parity error is not finite")
    return counts


def take_sum_planted_fault_ratios(tbl, idx, got):
    """Bound ratios of ``take_sum``'s output ``got`` against two faulty
    plain versions: the last of each row's K rows skipped, and each ring
    stage consumed one row short (the stage's last gathered row, the last
    id of every ``rows_per_stage``-th output row, not added).  Both must be
    above 1."""
    rps = pk.take_sum_rows_per_stage(idx.shape[1])
    skip = bound_ratio(got, pk.take_sum_terms(tbl, idx[:, :-1]))
    terms = pk.take_sum_terms(tbl, idx)
    terms[rps - 1::rps, -1] = 0.0
    return skip, bound_ratio(got, terms)


def take_sum_phase(dev, card):
    """``take_sum`` against its plain terms at exp_vmem_take's shapes, for
    both table dtypes, to SUM_RTOL·Σ|terms| (only the order of 16 f32
    additions differs), at each ring depth of TAKE_DEPTHS, each timed with
    its gathered rows/s and TB/s from L2; the bound must reject both
    planted faults.  The bf16 case at the default depth goes into the
    kernels line."""
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        tbl, idx = probes.take_sum_inputs(dev, dt)
        (c, k), dim = idx.shape, tbl.shape[1]
        e = ratio = 0.0
        for depth in TAKE_DEPTHS:
            got = pk.take_sum(tbl, idx, stages=depth)
            terms = pk.take_sum_terms(tbl, idx)
            e_d, r_d = max_err(got, terms.sum(dim=1)), bound_ratio(got, terms)
            del terms
            check(r_d <= 1.0, f"take_sum {dt} depth {depth}: |err| exceeds "
                              f"{SUM_RTOL} x sum |terms| by {r_d:.3f}x")
            e, ratio = max(e, e_d), max(ratio, r_d)
            km = cuda_ms(lambda: pk.take_sum(tbl, idx, stages=depth), reps=20)
            smem, per_sm = pk.take_sum_occupancy(dt, depth)
            say(f"take_sum {dt} ring depth {depth} ({smem} bytes of shared "
                f"memory a block, {per_sm} blocks an SM, "
                f"{per_sm * depth * pk.TAKE_STAGE_IDS} rows in flight an SM): "
                f"max_abs_err={e_d:.3e} bound_ratio={r_d:.4f} kernel_ms="
                f"{km:.4f}, {c * k / km / 1e6:.2f} G rows/s, "
                f"{c * k * dim * tbl.element_size() / km / 1e9:.3f} TB/s from "
                f"L2 [{card}]")
        skip, short = take_sum_planted_fault_ratios(tbl, idx,
                                                    pk.take_sum(tbl, idx))
        check(skip > 1.0, "the bound passed a take_sum that skips the last "
                          "of K rows")
        check(short > 1.0, "the bound passed a take_sum whose ring stages "
                           "are consumed one row short")
        km = cuda_ms(lambda: pk.take_sum(tbl, idx))
        qm = queued_device_ms(lambda: pk.take_sum(tbl, idx), reps=20)
        pm = cuda_ms(lambda: pk.take_sum_plain(tbl, idx), reps=3)
        lm = cuda_ms(lambda: F.embedding_bag(idx, tbl, mode="sum"))
        nbytes = (idx.unique().numel() * dim * tbl.element_size()
                  + idx.numel() * 4 + c * dim * 4)
        b_ms, by = bound_ms(nbytes, c * k * dim)
        say(f"take_sum {dt} [{c}, {k}] of [{tbl.shape[0]}, {dim}], filler "
            f"{pk.TAKE_FILLER}, ring depth {pk.TAKE_STAGES}: at every depth "
            f"max_abs_err <= {e:.3e} bound_ratio <= {ratio:.4f}; "
            f"last row skipped bound_ratio={skip:.2f}, stages one row short "
            f"bound_ratio={short:.2f} (must be > 1); kernel_ms={km:.4f} "
            f"queued={qm:.4f} plain_ms={pm:.4f} library_ms={lm:.4f} "
            f"(embedding_bag, {dt} out) bound_ms={b_ms:.4f} ({by}: "
            f"{nbytes / 1e6:.1f} MB); {c * k / km / 1e6:.2f} G rows/s "
            f"[{card}]")
        res.setdefault("max_abs_err", 0.0)
        res["max_abs_err"] = max(res["max_abs_err"], e)
        if dt == torch.bfloat16:
            res.update(ms=km, queued_ms=qm, plain_ms=pm, library_ms=lm,
                       bound_ms=b_ms, bound_by=by)
    return res


def resident_gather_phase(dev, card):
    """``resident_gather`` at exp_dg's H = 2048 (its largest output), both
    dtypes: bit for bit equal to its plain version, and unequal to a
    gather whose ids are off by one.  Times the bf16 case."""
    res = {"max_abs_err": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        tbl, idx = probes.dg_inputs(dev, dt, 2048)
        (h, dim), m = tbl.shape, idx.shape[0]
        got = torch.empty((m, dim), dtype=dt, device=dev)
        pk.resident_gather(tbl, idx, out=got)
        check(torch.equal(got, pk.resident_gather_plain(tbl, idx)),
              f"resident_gather {dt} differs from its plain version")
        off = int((got != pk.resident_gather_plain(tbl, (idx + 1) % h))
                  .any(dim=1).sum())
        check(off > 0, "the check passed a gather with ids off by one")
        km = cuda_ms(lambda: pk.resident_gather(tbl, idx, out=got))
        pm = cuda_ms(lambda: pk.resident_gather_plain(tbl, idx), reps=3)
        lib = torch.empty_like(got)
        lm = cuda_ms(lambda: torch.index_select(tbl, 0, idx, out=lib))
        row = dim * tbl.element_size()
        nbytes = idx.unique().numel() * row + m * 4 + m * row
        b_ms, by = bound_ms(nbytes, 0)
        say(f"resident_gather {dt} {m} rows of [{h}, {dim}]: bit-exact; ids "
            f"off by one: {off} rows differ; kernel_ms={km:.4f} "
            f"plain_ms={pm:.4f} library_ms={lm:.4f} (index_select) "
            f"bound_ms={b_ms:.4f} ({by}: {nbytes / 1e6:.1f} MB); "
            f"{m / km / 1e3:.1f} M rows/s [{card}]")
        if dt == torch.bfloat16:
            res.update(ms=km, plain_ms=pm, library_ms=lm, bound_ms=b_ms,
                       bound_by=by)
        del got, lib
    return res


def read_sum_phase(graph, dev, card):
    """``read_sum`` over exp_sweepfloor's 40 take groups, each against a
    float64 sum of the same tile to γ_n·Σ|terms| per column (n from
    ``read_sum_plan``); for every group the bound must reject a sum that
    skips the last tile row.  Times the 40-launch loop, which streams the
    659 MB from HBM, and one group repeated (16.5 MB, warm in L2)."""
    tiles, _, _ = probes.sweepfloor_tiles(graph, dev)
    groups, t_rows, k, dim = tiles.shape
    _, _, adds = pk.read_sum_plan(t_rows * k, tiles.dtype)
    gamma = adds * F32_UNIT / (1 - adds * F32_UNIT)
    e, ratio, skip = 0.0, 0.0, float("inf")
    for t in tiles:
        got = pk.read_sum(t)[0].double()
        x = t.double().reshape(-1, dim)
        scale = gamma * x.abs().sum(dim=0)
        err = (got - x.sum(dim=0)).abs()
        e = max(e, float(err.max()))
        ratio = max(ratio, float(torch.where(err == 0, 0.0, err / scale).max()))
        skip = min(skip, float(((got - x[:-k].sum(dim=0)).abs() / scale).max()))
    check(ratio <= 1.0, f"read_sum: |err| exceeds gamma_{adds} x sum |terms| "
                        f"by {ratio:.3f}x")
    check(skip > 1.0, "the bound passed a read_sum that skips the last tile "
                      "row")
    def kernel():
        for t in tiles:
            pk.read_sum(t)

    def library():
        for t in tiles:
            t.sum((0, 1), dtype=torch.float32)

    km, qm = cuda_ms(kernel), queued_device_ms(kernel, reps=5)
    pm = cuda_ms(lambda: [pk.read_sum_plain(t) for t in tiles], reps=3)
    lm, lqm = cuda_ms(library), queued_device_ms(library, reps=5)
    one_ms = queued_device_ms(lambda: pk.read_sum(tiles[0]), reps=100)
    nbytes = tiles.numel() * tiles.element_size() + groups * dim * 4
    b_ms, by = bound_ms(nbytes, tiles.numel())
    say(f"read_sum {groups} groups of [{t_rows}, {k}, {dim}] bf16: "
        f"max_abs_err={e:.3e} bound_ratio={ratio:.4f} (gamma_{adds}="
        f"{gamma:.3e} x sum |terms|); last tile row skipped bound_ratio >= "
        f"{skip:.2f} (must be > 1); kernel_ms={km:.4f} queued={qm:.4f} "
        f"({nbytes / qm / 1e6:.1f} GB/s) plain_ms={pm:.4f} library_ms="
        f"{lm:.4f} queued={lqm:.4f} (sum, f32) bound_ms={b_ms:.4f} ({by}: "
        f"{nbytes / 1e6:.1f} MB); one group repeated, queued (L2-warm): "
        f"{one_ms:.4f} ms, {nbytes / groups / one_ms / 1e6:.1f} GB/s "
        f"[{card}]")
    return dict(max_abs_err=e, ms=km, queued_ms=qm, plain_ms=pm,
                library_ms=lm, bound_ms=b_ms, bound_by=by)


def tile_table_planted_fault_ratios(work, got, step):
    """Bound ratios of a ``tile_force_tc_table`` output ``got`` (one
    result per part) against two faulty plain versions: each row's last
    slot skipped (the least ratio over the parts: each must reject it), and
    the table's first entry (the widest, launched first) skipped.  Both
    must be above 1."""
    def ratios(fault):
        return [bound_ratio(out, pk.tile_force_tc_terms(xi, xj, fault(i, deg),
                                                        step), TC_RTOL)
                for i, ((xi, xj, deg), out) in enumerate(zip(work.parts, got))]

    first = work.order[0]
    return (min(ratios(lambda i, deg: (deg - 1).clamp(min=0))),
            max(ratios(lambda i, deg: deg * 0 if i == first else deg)))


def tile_force_tc_phase(graph, dev, card):
    """``tile_force_tc`` as one launch over a work table of the bench
    layout's 13 materialised bucket tiles, each entry against its plain
    terms to TC_RTOL·Σ|terms|; the bound must reject both planted faults.
    Times the one launch back to back and queued (the gather that made
    the tiles not included)."""
    fv, _, xg, xis = probes.sweep_setup(graph, dev)
    step = probes.STEP
    work = pk.tile_work_table([(xi, xg[b.nbr.long()], b.deg)
                               for b, xi in zip(fv.device_buckets, xis)])
    got = pk.tile_force_tc_table(work, step)
    e, ratio = 0.0, 0.0
    for (xi, xj, deg), out in zip(work.parts, got):
        terms = pk.tile_force_tc_terms(xi, xj, deg, step)
        e = max(e, max_err(out, terms.sum(dim=1)))
        ratio = max(ratio, bound_ratio(out, terms, TC_RTOL))
        del terms
    skip, first = tile_table_planted_fault_ratios(work, got, step)
    check(ratio <= 1.0, f"tile_force_tc: |err| exceeds {TC_RTOL:.3e} x sum "
                        f"|terms| by {ratio:.3f}x")
    check(skip > 1.0, "the bound passed a tile_force_tc that skips the last "
                      "slot")
    check(first > 1.0, "the bound passed a tile_force_tc table launch that "
                       "skips its first entry")
    km = cuda_ms(lambda: pk.tile_force_tc_table(work, step), reps=20)
    qm = queued_device_ms(lambda: pk.tile_force_tc_table(work, step),
                          reps=20)
    pm = cuda_ms(lambda: pk.tile_force_tc_table_plain(work, step), reps=3)
    slots = sum(int(deg.sum()) for _, _, deg in work.parts)
    rows = work.out_rows
    dim = xg.shape[1]
    nbytes = slots * dim * xg.element_size() + rows * (2 * dim * 4 + 4)
    # per real slot and value: sub, square, coefficient mul, 2 clamps,
    # step mul, add (the tensor cores' 2·dim per slot are < 1% at 495 TF/s)
    b_ms, by = bound_ms(nbytes, slots * 7 * dim)
    smem, per_sm = pk.tile_force_tc_occupancy(xg.dtype)
    say(f"tile_force_tc one launch over {len(work.entries)} buckets, {rows} "
        f"rows, {slots} real slots ({smem} bytes of shared memory a block, "
        f"{per_sm} blocks an SM): max_abs_err={e:.3e} bound_ratio="
        f"{ratio:.4f} ({TC_RTOL:.3e} x sum |terms|); last slot skipped "
        f"bound_ratio >= {skip:.2f}, first entry skipped bound_ratio="
        f"{first:.2f} (must be > 1); kernel_ms={km:.4f} queued={qm:.4f} "
        f"({nbytes / qm / 1e9:.3f} TB/s) plain_ms={pm:.4f} "
        f"bound_ms={b_ms:.4f} ({by}: {nbytes / 1e6:.1f} MB) [{card}]")
    return dict(max_abs_err=e, ms=km, queued_ms=qm, plain_ms=pm,
                library_ms=None, bound_ms=b_ms, bound_by=by)


# -- path D: a graph file in, an .embd out, scored on the card -------------------


def score_phase(graph, x, dev, what, card):
    """Link prediction and reconstruction of ``x`` on the card, each timed;
    returns (scores, reconstruction accuracy)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, y = link_prediction_dataset(graph, x, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores = fit_and_score(X, y)
    t2 = time.perf_counter()
    rows = len(y)
    del X, y
    recon = graph_reconstruction_accuracy(graph, x, RECON_VERTICES,
                                          device=dev)
    t3 = time.perf_counter()
    check(all(np.isfinite(v) for v in scores.values()) and np.isfinite(recon),
          f"{what}: a score is not finite: {scores}, {recon}")
    say(f"link prediction {what}: {rows} rows, data build {t1 - t0:.3f} s, "
        f"fit and score {t2 - t1:.3f} s; accuracy {scores['accuracy']:.6f} "
        f"f1_macro {scores['f1_macro']:.6f} f1_micro {scores['f1_micro']:.6f} "
        f"auc {scores['auc']:.6f}; reconstruction accuracy ({RECON_VERTICES} "
        f"vertices) {recon:.6f} in {t3 - t2:.3f} s [{card}]")
    return scores, recon


def file_path(graph, dev, card):
    """Path D: the bench graph through a .mtx file, 50 training iterations
    with exact launch counts, the .embd round trip, and the scores of the
    trained X against a random-normal control, all on the card."""
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "the native graph loader did not "
                                        "build (g++)")
    say(f"native graph loader: {time.perf_counter() - t0:.3f} s "
        f"-> {native.library_path().name}")
    with tempfile.TemporaryDirectory() as tmp:
        mtx = os.path.join(tmp, "bench.mtx")
        t0 = time.perf_counter()
        write_mtx(graph, mtx)
        t1 = time.perf_counter()
        loaded = load_graph(mtx)
        t2 = time.perf_counter()
        check(gio.last_parser == "native",
              f"load_graph used the {gio.last_parser} parser, not the native")
        check(loaded.n == graph.n
              and np.array_equal(loaded.rowptr, graph.rowptr)
              and np.array_equal(loaded.colids, graph.colids),
              "the loaded graph differs from the generator's")
        say(f"graph file: write_mtx {t1 - t0:.3f} s "
            f"({os.path.getsize(mtx) / 1e6:.1f} MB), load_graph {t2 - t1:.3f} "
            f"s ({gio.last_parser} parser), n={loaded.n} nnz={loaded.nnz}, "
            f"rowptr and colids equal the generator's [{card}]")

        fv = SyncForce2Vec(loaded, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH,
                           device=dev)
        emb, counts = train_phase(fv, {
            "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS,
            "ell_sample_force": 0}, card)
        distance_gap_check(loaded, emb, QUALITY_MARGIN, "file path")

        embd = os.path.join(tmp, "bench.embd")
        host = emb.cpu().numpy()
        t0 = time.perf_counter()
        check(native.write_embd_native(embd, host),
              "the native .embd writer failed")
        t1 = time.perf_counter()
        back = read_embeddings(embd)
        t2 = time.perf_counter()
        check(back.shape == host.shape, f".embd read back as {back.shape}")
        off = np.abs(back.astype(np.float64) - host) > (
            EMBD_ATOL + EMBD_RTOL * np.abs(host.astype(np.float64)))
        check(not off.any(), f".embd round trip: {int(off.sum())} values off "
                             "by more than the text's rounding")
        say(f".embd: native write {t1 - t0:.3f} s "
            f"({os.path.getsize(embd) / 1e6:.1f} MB), read {t2 - t1:.3f} s, "
            f"every value within {EMBD_RTOL:.3e} relative [{card}]")

    control = np.random.default_rng(CONTROL_SEED).standard_normal(
        back.shape).astype(np.float32)
    trained, recon = score_phase(loaded, back, dev, "trained X", card)
    ctrl, recon_ctrl = score_phase(loaded, control, dev, "control X", card)
    say(f"path D scores: auc {trained['auc']:.6f} (JAX {JAX_LINKPRED_AUC:.6f};"
        f" needs > {0.5 + AUC_MARGIN:.6f}), control auc {ctrl['auc']:.6f} "
        f"(needs 0.5 +- {CONTROL_AUC_TOL}); reconstruction {recon:.6f} - "
        f"control {recon_ctrl:.6f} = {recon - recon_ctrl:.6f} (JAX "
        f"{JAX_RECON - JAX_RECON_CONTROL:.6f}; needs >= {RECON_MARGIN:.6f}) "
        f"[{card}]")
    check(trained["auc"] - 0.5 >= AUC_MARGIN, "path D: link-prediction AUC "
          "below half of the JAX package's margin")
    check(abs(ctrl["auc"] - 0.5) <= CONTROL_AUC_TOL,
          f"path D: the control X's AUC {ctrl['auc']:.4f} is not ~0.5")
    check(recon - recon_ctrl >= RECON_MARGIN, "path D: reconstruction "
          "margin below half of the JAX package's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clust = clustering_scores(loaded, back, k_range=CLUSTER_KS, device=dev)
    t1 = time.perf_counter()
    q = clust["best_modularity"]
    say(f"clustering (KMeans k in [{CLUSTER_KS.start}, {CLUSTER_KS.stop}), "
        f"3 inits each): best modularity {q:.6f} at k="
        f"{clust['best_k']:.0f}, {t1 - t0:.3f} s [{card}]")
    check(np.isfinite(q) and -0.5 <= q <= 1.0,
          f"path D: best modularity {q} outside [-0.5, 1]")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    say(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    ptxas = ptxas_summary(lib_path.with_suffix(".log").read_text())
    for line in ptxas:
        say(f"  ptxas: {line}")
    missing = [k for k in CUDA_KERNELS
               if not any(line.startswith(k + "<") for line in ptxas)]
    check(not missing, f"kernels missing from the ptxas report: {missing}")
    spilling = [line for line in ptxas
                if line.split(":")[0] in MAIN_INSTANCES + RING_INSTANCES
                and " 0 bytes spill stores" not in line]
    check(not spilling, f"main-path or ring instances spill: {spilling}")
    missing = [k for k in RING_INSTANCES
               if not any(line.startswith(k + ":") for line in ptxas)]
    check(not missing, f"ring instances missing from the ptxas report: "
                       f"{missing}")

    graph = synth_powerlaw_graph()
    t0 = time.perf_counter()
    edge, rep, counts_main, buckets = main_path(graph, dev, card)
    say(f"main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sample, counts_pv = per_vertex_path(graph, dev, card)
    say(f"path A (-bs 1): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_rw = rwalk_path(graph, dev, card)
    say(f"path B (rwalk): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_probes = probes_path(graph, dev, card, buckets)
    measured = {"take_sum": take_sum_phase(dev, card),
                "tile_force_tc": tile_force_tc_phase(graph, dev, card),
                "resident_gather": resident_gather_phase(dev, card),
                "read_sum": read_sum_phase(graph, dev, card)}
    say(f"path C (probes): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_file = file_path(graph, dev, card)
    say(f"path D (file): {time.perf_counter() - t0:.1f} s")

    paths = {"main": counts_main, "per_vertex": counts_pv,
             "rwalk": counts_rw, "probes": counts_probes,
             "file": counts_file}

    def entry(name, source, replaces, measured):
        by_path = {p: c[name] for p, c in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "library_ms": None, **measured}

    say(json.dumps({"kernels": [
        entry("ell_edge_force", EDGE_SOURCE, EDGE_REPLACES, edge),
        entry("grouped_rep_force", REP_SOURCE, REP_REPLACES, rep),
        entry("ell_sample_force", SAMPLE_SOURCE, SAMPLE_REPLACES, sample),
    ] + [entry(name, *PROBES[name], m) for name, m in measured.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
