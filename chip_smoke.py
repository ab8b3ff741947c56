"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py        # from the repository root, one card

Drives ``force2vec_tpu_torch``'s three sync paths at full width, on
``bench.py``'s graph (131,072-vertex power-law graph, 2,097,122 edges) with
its configuration (dim 128, ns 5, bf16 gathers, min_width 8,
hub_width 128), the benchmark probes (``tools/probes.py``) at the
shapes the JAX tools ran, the file path from a graph file to scores, and
the command line on both schedules:

1. checks for a card and prints its name and power limit;
2. builds the CUDA kernels from ``force2vec_tpu_torch/ops/csrc`` with nvcc
   and checks that no instance of the training kernels spills;

the main path, tdist with 256-row group-shared negatives (``-option 5``):

3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the path gives it, elementwise and for every separable model, and
   times both: ``ell_edge_force`` as the path runs it, one launch over the
   layout's work table (every bucket, the hub included), back to back and
   queued ahead of the device, beside its per-bucket launches; then shows
   that the same bound rejects four planted faults;
4. runs one iteration through the kernels and through the plain versions
   from the same X and negatives (no ``add_``: the fused pass, path M,
   applies X += update + repulsion), and times both;
5. trains 50 iterations through the kernels, checks the launch counts (the
   fused pass's two launches per iteration, the second over the hub's
   owner rows), that X is finite, and that edges end closer than random
   pairs;

path A, tdist with per-vertex negatives (``-option 5 -bs 1``):

6. holds ``ell_sample_force`` against its plain version at ``[n_pad, ns]``
   for the tdist, sigmoid and layout sample forces, shows that adding into
   ``out`` (``accumulate=True``, as the path runs it) equals ``out.add_``
   of its result bit for bit, times it, and shows that the bound rejects
   two planted faults;
7. one iteration both ways, timed, with no ``add_`` (the fused pass
   applies X += update); 50 training iterations with exact launch counts, X finite, edges
   closer than random pairs;

path B, ``rwalk`` (``-option 7``, walk length 5, group-shared negatives):

8. draws walks on the card (a draw a step, then one ``walk_steps``
   launch) and checks that every step lands on a neighbour and that steps
   pick slots uniformly; holds the walks to ``walk_steps_plain``'s over
   the same draws taken again from the same seed, bit for bit, and times
   the engine against the torch engine (the draws, then
   ``walk_steps_plain``) and the kernel alone, at the bench graph and at
   com-Youtube's vertex count (``--path B`` runs the build and path B
   alone);
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

path E, the command line (``python3 -m force2vec_tpu_torch``), on path D's
file:

17. (a) the batch schedule as a subprocess, ``-option 5 -iter 20`` (batch
    256, dim 128): the ``.embd`` name and shape, the ``Results.txt`` row,
    the quality margin; the trainer's ms per iteration and device
    operations per batch, in this process;
18. (b) a batch iteration on the card against the same on the CPU, from
    the same X and injected samples (tdist, sigmoid ``-bs 1``, rwalk), and
    two runs from one seed bit for bit; (c) ``tdist_exact`` (O(n²)
    repulsion) for 3 iterations: finite, edges closer than random pairs;
19. (d) ``--schedule sync -dim 64`` through the CLI with exact launch
    counts, then every dim-64 instance against its plain version at the
    bench shapes (both gather dtypes), a planted fault per kernel, the
    three kernels timed at dim 64;
20. (e) ``-option 6`` and ``-option 7`` with ``--sm-table`` through the
    CLI; the lookup-table instances against their plain versions and
    against exact σ's terms (a planted fault they must reject); one
    iteration in table mode against exact σ: different, within the
    table's resolution;
21. sigmoid (``-option 6``) and fr (``-option 2``) on the sync schedule,
    50 iterations with exact launch counts, each in the statistic it
    optimises against the JAX package's;
22. (f) ``--checkpoint-every``, then ``--resume`` from the middle, on both
    schedules: bit for bit the straight run; the sync schedule at dim 96
    (once refused) runs; then the refusals: the sync schedule above the
    kernels' cap (dim 1025), a coordinator without world size and rank,
    and more ranks than cards exit 2.

path F, the vertex and sharded schedules (``dist/``), at the main path's
configuration with f32 gathers (the vertex schedule's):

23. (F1) in a real NCCL process group of one rank (a FileStore),
    ``VertexShardedForce2Vec`` at P = 1: each launch on its operands (the
    free slabs on x_loc, the dep slabs on ``[x_loc | hot | halo]``, one
    ``grouped_rep_force`` group of n_loc rows, ``ell_sample_force`` into
    a 128-row pool) against its plain version; one iteration against
    ``SyncForce2Vec``'s from the same X and negatives; its queued
    ms/iteration beside main's; its metered phases through
    ``run_iteration`` (eager) and through ``run_span`` (the graph's
    replays, timed by external event nodes); 50 training iterations in
    ``shared`` and ``pool`` mode (graph replays) with exact launch counts
    and half the JAX vertex schedule's distance gap;
24. (F2) the four shards of a P = 4 layout on this card: each shard's
    table assembled from a global X by ``hot_send`` and ``send_idx``,
    each launch against its plain version, the four updates against the
    sync iteration, and a planted fault (a dep slab's halo index one row
    on) that the bound must reject;
25. (F3) ``--schedule vertex --devices 1``, and with ``-bs 1``, through
    the command line: the JAX CLI's output name and ``Results.txt`` row,
    exact launch counts;
26. (F5) the sync runner's dp × tp on this card, at the main path's
    configuration with random per-group negatives: the four dp = 4
    ranks' runners (``SpmdAxes(n_dp=4, dp_index=k)``, no group), each
    rank's edge launch over its bucket slices and its repulsion launch
    counted and held to their plain versions, the slices put in place by
    the runner's permutation against the single-card iteration; then two
    gloo ranks sharing the card at tp = 2: one iteration through the
    split-dim kernels (one ``tp_pair_partial`` over the attraction's and
    the repulsion's tables laid end to end, one ``all_reduce``, a
    ``tp_pair_force`` for each) with exact launch and all_reduce counts,
    each launch on the runner's own tables against its plain version, X
    against the single-card iteration; the two kernels timed at a tp = 2
    rank's shapes, back to back and queued, beside their plain versions
    and bounds, and an iteration's three launches summed;
27. (F4) with two or more cards, min(count, 4) NCCL ranks (even): a
    vertex iteration against F1's single-card result, and the sync
    iteration at dp = ranks and at tp = 2 against F5's, their launch
    counts, exchange bytes and ms/iteration; then each multi-rank runner
    (the vertex schedule at P = ranks: ``shared``, ``pool``, rwalk through
    the ring and the a2a fetch, ``halo_stale``; sync at dp = ranks and at
    tp = 2; batch at dp = ranks): ``run_span`` (one CUDA graph an
    iteration, the NCCL collectives captured) against its eager loop bit
    for bit on every rank, straight and in spans, with the same launch
    and collective counts and one capture; per rank, ms per iteration
    back to back and queued, three repeats each, graph and eager in
    turns, the host's launch calls per iteration and the idle share; the
    seconds the ranks took to leave their groups after the last result;
    then ``--devices ranks`` through the command line (batch and vertex
    schedules), exit 0 and the output written; with one card the script
    says so and goes on (the CPU tests hold the ranks on gloo, the graphs'
    code run uncaptured against the eager loops).

path G, every width (``-dim`` any of 1 to ``force_kernels.KERNEL_MAX_DIM``,
1024; the trainers hold X at the dim rounded up to 8):

28. (G1) at dims 2, 8, 16, 24, 32, 100, 256, 512, 1000 and 1024 (every
    row class of the kernels, with path E's dim 64), with bf16 and f32
    gathers: each kernel and the split-dim pair against its plain version
    on X of ``padded_dim(dim)`` columns, tdist at the bench shapes (the
    edge kernel over the work table, the repulsion over every group,
    ``ell_sample_force`` over ``[n_pad, ns]`` samples and adding into an
    update bit for bit, the pair over the edge table), every other model
    on the widest bucket; each output's padding columns 0; at dim 100 the
    bound rejects each kernel's result held to its plain terms with the
    last real column skipped (the split-dim pair's at every dim); every
    kernel, the pair among them, refuses x of 12 columns and x off its
    16-byte alignment;
29. (G2) 50 sync iterations with exact launch counts and the JAX
    package's statistic at the same width: tdist at dim 32, tdist ``-bs
    1`` at dim 256, rwalk at dim 100 (its walk attraction then held to its
    plain version at the trained X), fr at dim 2;
30. (G3) ``--schedule sync -dim 100`` and ``--schedule vertex --devices 1
    -dim 24`` through the command line: the JAX CLI's name and row, an
    ``.embd`` and a checkpoint of ``dim`` columns that agree;
31. (G4) each row class at the bench shapes: the three kernels and the
    split-dim pair queued ahead of the device, beside their bounds and
    plain versions; the ``kernels`` line lists them under ``row_classes``.

path I, X held in bf16 (``TrainConfig(dtype="bfloat16")``, X its own
gather table), at the main path's configuration:

32. (I0) float64 X refused by name in the trainers' constructors, and a
    bf16 X beside an f32 gather table by the wrappers, with no launch;
    (I1) each kernel at bf16 X against its plain version elementwise,
    within 1e-5 of Σ|terms| plus half an ulp of the bf16 output: the edge
    table launch (tdist), ``grouped_rep_force``, ``ell_sample_force``
    storing and adding, the split-dim pair over main's tables on tp = 2
    halves, and sigmoid, fr, linlog and forceatlas on the widest bucket;
    the bound rejects the edge launch with each row's last slot skipped
    and with x_i read as zeros; each timed beside its bound and plain
    version;
33. (I2) one iteration through the kernels and the plain versions: no
    cast of X, no ``add_`` (the repulsion launch applies X += update +
    repulsion), each element within the bf16 roundings the
    two may each make their own way (one ulp each of the attraction, the
    repulsion, the update and X, and of each hub partial row); then
    against the f32-X iteration from the same X, its difference stated;
34. (I3) 50 iterations on the main path and with ``-bs 1`` (exact launch
    counts, no cast) and 20 batch-schedule iterations, each with half the
    JAX package's distance gap at bf16 X;
35. (I4) the vertex schedule at P = 1 against the sync iteration, its
    exchange bytes at 2 bytes an element (P = 1 and a P = 4 layout), and
    the dp = 2 slices on this card against one card;
36. (I5) main queued with f32 X and with bf16 X in turns, at the bench
    graph and at 1,048,576 vertices, and the batch schedule back to back.

path J, ``grouped_rep_force``'s three output modes (``store``; ``add``
into the update, as the layout family runs it; ``apply``, X += update +
repulsion in place, the main path's and rwalk's last launch):

37. (J1) at every row class (dims 2 to 1024) with f32 X (bf16 and f32
    samples) and bf16 X, tdist over every 256-row group: each mode against
    its exact composition from the plain terms, within SUM_RTOL (scaled
    above dim 128) of Σ|terms| plus half an ulp of each rounding the mode
    makes; ``add`` and ``apply`` bit for bit ``out.add_`` of the stored
    result and ``upd.add_(rep); x.add_(upd)``; padding columns 0; at dims
    100 and 128 a planted fault per mode (the last sample skipped, out
    not read, upd not read) that the bound must catch; more samples than
    a launch holds (a launch a chunk, the f32 sums passed on) in each
    mode; every sample model's ``add`` and ``apply`` bit for bit at the
    bench dim, and ``apply`` with an energy model refused;
38. (J3) one iteration of main (f32 X gathering from itself, where no
    fused pass runs, and bf16 X), rwalk and linlog in the
    mode the trainer derives (apply, add for linlog; store under dp): the
    launch against the store launch and the ``add_``s composed from copies
    of its operands, bit for bit; an ``apply`` iteration calls no
    ``add_``, and no launch count, torch operation or device kernel
    follows the repulsion (the profiler's kernels, recorded in a fresh
    process: the full run takes path J as ``--path J``);
39. (J4) 50 iterations of main (f32 and bf16 X) and rwalk with exact
    launch counts against the main path's and path I's margins;
40. (J5) each mode queued and back to back beside its bound and plain
    version at the bench shape; ``store`` and ``apply`` queued at every
    row class; main queued with the store launch and the ``add_``s in the
    apply launch's place and with the trainer's ``apply``, in turns.

path K, X held in f16 (``TrainConfig(dtype="float16")``, X its own gather
table) and the f16 gather replica of an f32 X (``--gather-dtype
float16``), at the main path's configuration (after path I in the full
run):

41. (K0) the pairs the kernels lack refused by the wrappers by name (an
    f16 X beside a bf16 or f32 table, a bf16 X beside an f16 one), with
    no launch; (K1) path I1 at f16 X (each kernel against its plain
    version within 1e-5 of Σ|terms| plus half an f16 ulp of the output,
    the two planted faults, each kernel timed), then every row class
    (dims 2 to 1024) of the four kernels with f16 X and with the f16
    replica of an f32 X, every model, as path G1 holds them (the planted
    faults at dim 100), each f16-X class timed as G4 times it, and
    ``grouped_rep_force``'s three modes at every row class with f16 X
    and with f16 samples beside an f32 X, as J1 holds them;
42. (K2) one f16-X iteration against its plain version as I2 holds it (no
    cast of X, no ``add_``), and one f32-X iteration with the f16 replica
    (one cast of X, to the replica) within 1e-3;
43. (K3) path I3 at f16 X, and 50 iterations of main with the f16
    replica, each with half the JAX package's gap
    (``scripts/jax_quality_reference.py``: ``tdist_x_f16``,
    ``tdist_per_vertex_x_f16``, ``tdist_batch_x_f16``, ``tdist_g_f16``);
44. (K4) path I4 at f16 X;
45. (K5) main queued with f32 X (the bf16 replica), bf16 X, f16 X and
    f32 X with the f16 replica, in turns, at the bench graph and at
    1,048,576 vertices.

path L, ``run_span`` and ``train()`` as a CUDA graph (each single-card
iteration captured once per X and replayed, the step and the draws in
device buffers; ``train/graph.py``), in a fresh process (``--path L``),
after path J in the full run:

46. (L1) every single-card configuration of the three schedules: the
    sync schedule's main path with f32, bf16 and f16 X and with the f16
    replica, ``-bs 1``, rwalk, sigmoid, the table σ, fr, linlog,
    forceatlas and dim 100 at the bench graph; the vertex schedule at
    P = 1 (``shared``, ``pool``, rwalk, ``halo_stale`` with its two
    tables, bf16 X) at the bench graph; the batch schedule at
    the CLI's default (bench graph) and with bf16 and f16 X, ``-bs 1``,
    sigmoid, rwalk and the layout family on a small graph, and
    tdist_exact on a smaller one.  Each, in torch's default mode (and the
    sync schedule again in its deterministic mode): two eager runs of
    L_ITERS iterations (``_run_span_eager``), ``train()`` (the graph) and
    ``run_span`` in spans on a new X, from one seed: the same launch
    counts in all four, the two eager runs bit for bit equal (the hub's
    owner sums are ordered: main and fr among them), the graph's runs
    against the first eager run bit for bit (``halo_stale``'s spans
    against the eager loop in the same spans: each primes its first
    iteration);
47. (L2) planted faults that the graph's bound must catch: the step
    buffer written once and never refreshed (fr, whose step decays every
    iteration; the sync, batch and vertex schedules) and the negatives
    drawn once and never redrawn (tdist; sync and batch);
48. (L3) main with f32, bf16 and f16 X, rwalk, the vertex schedule at
    P = 1 and the batch schedule at the bench graph, the graph against
    the eager loop in turns: back to
    back and queued ms per iteration, host enqueue ms, the host's launch
    calls per iteration and the idle share (profiled windows), our
    kernels' device ms in each, capture seconds, the graph's pool beside
    the eager iteration's peak.

path M, the fused pass (``ell_edge_apply``: attraction, repulsion and X
+= update in one launch, which the sync trainer runs at one rank with an
f32 X beside a bf16 or f16 replica; the main path, paths A and D, G2's
tdist runs, K3's f16 replica and path L's runs of those configurations
run it), after path K in the full run:

49. (M1) 50 iterations at dims 8, 64, 100, 128 and 256, bf16 and f16
    replicas, group-shared and per-vertex negatives: each iteration the
    trainer's fused iteration against the separate passes composed from
    the kernel wrappers (``separate_iteration``) and against itself
    again, on the same X, draws and step: ``-bs 1`` the same bits; the
    group-shared repulsion (its pair scalar summed in the replica's row
    class, not X's) within the sound runs' ``upd_err`` of 5.6e-6
    (``PERF.md`` §9.2); the same bits run to run; its launches an
    iteration (a second over the hub's owner rows);
50. (M2) at dim 128 on the bench graph and at 1,048,576 vertices, both
    sample modes: the fused launch queued beside the edge launch and the
    repulsion's launches it replaces, and the fused iteration against
    ``separate_iteration`` in turns.

Path N (the carried replica, ``SyncForce2Vec.replica_carry``: the launch
that writes X also writes the replica the next iteration gathers from, so
no cast of X runs in an iteration), after path M in the full run:

51. (N1) at the bench graph and at com-Youtube's vertex count, for the
    sync trainer, ``-bs 1`` and rwalk: N_ITERS iterations through
    ``run_span`` (one span: a capture and replays; one span an iteration,
    as the benchmark calls it; two spans with X rewritten in place between
    them) against the eager loop that casts X into a fresh replica each
    iteration, bit for bit; the replica the next iteration reads equal to
    ``x.to(gather_dtype)``; the counters: one cast a new X (and one a
    rewrite), one carried iteration a replay;
52. (N2) at com-Youtube's vertex count: the launches that write X queued
    with and without the replica's store, beside the cast they replace.

``python3 chip_smoke.py --path F`` builds the kernels and runs path F
alone (a check of the multi-card schedules on a host with several cards,
where F4 captures every multi-rank runner);
``--path G`` runs path G alone, ``--path I`` path I,
``--path J`` path J, ``--path K`` path K, ``--path L`` path L, ``--path
M`` path M, ``--path N`` path N.

The quality margins are half of what the JAX package reaches on the CPU
with the same graph, configuration and iteration count
(``scripts/jax_quality_reference.py``).  Every phase raises on failure, so
any failure exits non-zero.  The line before the last is a JSON record of
the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import dataclasses
import datetime
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from force2vec_tpu_torch import cli
from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.dist.vertex_sharded import (ShardTables,
                                                     VertexShardedForce2Vec,
                                                     shard_dep_part,
                                                     shard_free_part)
from force2vec_tpu_torch.eval.clustering import clustering_scores
from force2vec_tpu_torch.eval.linkpred import (fit_and_score,
                                               link_prediction_dataset)
from force2vec_tpu_torch.eval.reconstruction import (
    graph_reconstruction_accuracy)
from force2vec_tpu_torch.graphs import io as gio
from force2vec_tpu_torch.graphs import (load_graph, native, read_embeddings,
                                        synth_powerlaw_graph)
from force2vec_tpu_torch.graphs.partition import VertexShardLayout
from force2vec_tpu_torch.graphs.tools import write_mtx
from force2vec_tpu_torch.models.forces import MAXBOUND, get_model
from force2vec_tpu_torch.ops import _build, force_kernels as fk
from force2vec_tpu_torch.ops import probe_kernels as pk
from force2vec_tpu_torch.ops.segment import hub_owner_sum
from force2vec_tpu_torch.tools import (BENCH_CONFIG, HUB_WIDTH, MIN_WIDTH,
                                      card_name_and_power, cuda_ms, probes,
                                      queued_device_ms)
from force2vec_tpu_torch.tools.profile_iter import (device_breakdown,
                                                    profile_window)
from force2vec_tpu_torch.train.sync import DeviceBucket, SyncForce2Vec
from force2vec_tpu_torch.train.checkpoint import load_checkpoint
from force2vec_tpu_torch.train.graph import IterationGraph
from force2vec_tpu_torch.train.trainer import (Force2Vec, TrainConfig,
                                               iteration_seed, round_to)
from force2vec_tpu_torch.utils import profiling
from force2vec_tpu_torch.utils.profiling import Meter

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
EMBD_HEAD_ROWS = 1000  # rows of path E's .embd files held to the checkpoint
# slot-0 share of the first walk step against its expectation (its
# sampling spread is ~7e-4 over the bench graph's 131,072 rows)
WALK_UNIFORM_TOL = 0.01
# Path E, the command line.  (a) runs ``python3 -m force2vec_tpu_torch
# -input bench.mtx -option 5 -iter CLI_ITERS`` (the batch schedule, batch
# 256, dim 128); its margin is half the JAX batch trainer's distance gap at
# that configuration and seed 1 (scripts/jax_quality_reference.py,
# tdist_batch): 0.46787964415575267.
CLI_ITERS = 20
JAX_BATCH_GAP = 0.46787964415575267
BATCH_QUALITY_MARGIN = 0.5 * JAX_BATCH_GAP
# (b), (f): a small graph; (c) tdist_exact's O(n²) repulsion on a smaller
SMALL_GRAPH = dict(n=4096, avg_deg=16, seed=42)
EXACT_GRAPH = dict(n=2048, avg_deg=16, seed=42)
EXACT_ITERS = 3
# (b): the card's batch iteration against the CPU's from the same X and
# samples.  Both add in f32, in other orders (the dot products' and the
# segment sums'); 1e-5 is ~30 ulp at |x| ≈ 1 and 20 times the 0.02 step's
# f32 rounding.
BATCH_CPU_TOL = 1e-5
# (d), (e): iterations of the sync CLI runs
SYNC_CLI_ITERS = 20
TABLE_CLI_ITERS = 5
# the largest |σ̂ - σ| of the lookup table: σ's value just above 6, where
# the table gives 1 (inside [-6, 6] it is at most one 12/2048 step of σ's
# 1/4 slope, 1.5e-3)
TABLE_ERR = 1.0 / (1.0 + np.exp(6.0))
# the force models the dim-64 instances are held to their plain versions in
EDGE_MODELS = ("tdist", "sigmoid", "fr", "linlog", "forceatlas",
               "sigmoid_table")
SAMPLE_MODELS = ("tdist", "sigmoid", "fr", "sigmoid_table")
# sigmoid (-option 6) and fr (-option 2) on the sync schedule, TRAIN_ITERS
# iterations at the bench configuration; the JAX package's values from
# scripts/jax_quality_reference.py.  sigmoid: mean edge minus random-pair
# x_i.x_j 0.31968850592200765, held to half of it.  fr: after 50
# iterations at step ~1 every row still moves ~1 an iteration, and the
# distance gap is negative in the JAX package too: -0.1471681109139633
# (seeds 2 and 3: -0.1461, -0.1467).  The port's must lie within half of
# its size of it.
JAX_SIGMOID_DOT_GAP = 0.31968850592200765
SIGMOID_DOT_MARGIN = 0.5 * JAX_SIGMOID_DOT_GAP
JAX_FR_GAP = -0.1471681109139633
FR_GAP_TOL = 0.5 * abs(JAX_FR_GAP)
# (f): checkpoints every RESUME_ITERS // 3 iterations; on both schedules
# the resumed run is held to the straight run bit for bit
RESUME_ITERS = 6
# path F: the JAX package's vertex schedule on one device, 50 iterations,
# tdist, f32 (scripts/jax_quality_reference.py: tdist_vertex,
# tdist_vertex_pool), the distance gap; the port's must pass half of it
JAX_VERTEX_GAP = 0.8214333572548669
JAX_VERTEX_POOL_GAP = 0.8201282732186037
F_SHARDS = 4  # F2: the shards of one layout run on one card
F_MAX_RANKS = 4  # F4: NCCL ranks, one per card, where there are two or more
# F4: each multi-rank runner's train() (the graph) against its eager loop,
# straight and in spans of one X, over F4_ITERS iterations (3 and spans of
# one for the batch schedule, whose eager iteration takes ~0.3 s), then
# F4_REPEATS back-to-back and queued timings of each, in turns
F4_ITERS = 10
F4_SPANS = (4, 3, 3)
F4_REPEATS = 3
F_DP = 4  # F5: the dp slices of one sync layout run on one card
F_TP = 2  # F5: gloo ranks sharing this card, each with its 1/tp of the dim
# a tp rank's iteration: one tp_pair_partial over the attraction's and the
# repulsion's tables laid end to end, one all_reduce, a tp_pair_force each
TP_ITERATION_COUNTS = {"tp_pair_partial": 1, "tp_pair_force": 2,
                       "tp_all_reduce": 1}
VERTEX_CLI_ITERS = 5
# path G, every width: G1 and G4 at these dims (every row class of
# csrc/common.cuh::with_row_class in bf16 and f32 gathers, dim 64 aside,
# which path E runs; 1024 is the cap, force_kernels.KERNEL_MAX_DIM), the
# planted faults at G_FAULT_DIM, the terms of a plain check in chunks of at
# most G_TERMS elements
G_DIMS = (2, 8, 16, 24, 32, 100, 256, 512, 1000, 1024)
G_FAULT_DIM = 100
G_TERMS = 1 << 26
# samples a group of the repulsion held in chunks where they pass a
# launch's shared memory (dims 512 and up)
G_MANY_SAMPLES = 40
G_CLI_ITERS = 5
# the dp slices that run on one card; the big graph's vertices (its bf16
# replica 268 MB, 5.4x the H100's 50 MB L2)
SLICE_DP = 2
BIG_N = 1 << 20
# Path I: X itself held in bf16 (no separate gather replica), and the JAX
# package's distance gaps at bf16 X on the CPU after TRAIN_ITERS sync
# iterations (tdist_x_bf16, tdist_per_vertex_x_bf16) and CLI_ITERS batch
# iterations (tdist_batch_x_bf16), scripts/jax_quality_reference.py; each
# held to half of it, as the f32 paths are.
I_CONFIG = dataclasses.replace(BENCH_CONFIG, dtype="bfloat16",
                               gather_dtype=None)
JAX_TDIST_X_BF16_GAP = 0.8167409752598589
JAX_TDIST_PV_X_BF16_GAP = 0.8169534115864345
JAX_TDIST_BATCH_X_BF16_GAP = 0.4657693201425728
# Path K: X held in f16, and f32 X with an f16 gather replica; the JAX
# package's gaps at them on the CPU (tdist_x_f16, tdist_per_vertex_x_f16,
# tdist_batch_x_f16, tdist_g_f16, scripts/jax_quality_reference.py), each
# held to half of it
K_CONFIG = dataclasses.replace(BENCH_CONFIG, dtype="float16",
                               gather_dtype=None)
K_REPLICA_CONFIG = dataclasses.replace(BENCH_CONFIG, gather_dtype="float16")
JAX_TDIST_X_F16_GAP = 0.820914543667818
JAX_TDIST_PV_X_F16_GAP = 0.8222852574968318
JAX_TDIST_BATCH_X_F16_GAP = 0.46707264978308416
JAX_TDIST_G_F16_GAP = 0.8204016299637944
# G2: (what, TrainConfig over the bench's, statistic, the JAX package's
# value after TRAIN_ITERS sync iterations on the CPU from
# scripts/jax_quality_reference.py: tdist_d32, tdist_per_vertex_d256,
# rwalk_d100, fr_d2).  Distance gaps for tdist, the x_i.x_j gap for rwalk,
# each held to half the JAX value (seeds 2 and 3: tdist 0.1437, 0.1337;
# rwalk 0.0259, 0.0177); fr's distance gap within half its size of JAX's,
# as phase 21 holds fr at dim 128 (seeds 2 and 3: -0.0953, -0.0943).
JAX_TDIST_D32_GAP = 0.13367595235229646
JAX_TDIST_PV_D256_GAP = 0.776250347631315
JAX_RWALK_D100_DOT_GAP = 0.022150505199042294
JAX_FR_D2_GAP = -0.0954679211624927
G2_RUNS = (
    ("tdist dim 32", dict(dim=32), "dist", JAX_TDIST_D32_GAP),
    ("tdist -bs 1 dim 256", dict(dim=256, per_vertex_samples=True), "dist",
     JAX_TDIST_PV_D256_GAP),
    ("rwalk dim 100", dict(dim=100, model="rwalk"), "dot",
     JAX_RWALK_D100_DOT_GAP),
    ("fr dim 2", dict(dim=2, model="fr"), "fr", JAX_FR_D2_GAP),
)
# path J, grouped_rep_force's modes (store, add into the update, apply X
# += update + repulsion): every row class of both X dtypes at these dims
# (path G's and the full classes of dims 64 and 128), with (X, sample)
# dtypes; the planted faults at J_FAULT_DIMS
J_DIMS = (2, 8, 16, 24, 32, 64, 100, 128, 256, 512, 1000, 1024)
J_DTYPES = ((torch.float32, torch.bfloat16), (torch.float32, torch.float32),
            (torch.bfloat16, torch.bfloat16))
J_FAULT_DIMS = (100, 128)
# J3-J5's f32 X gathers from X itself: beside a 2-byte replica the trainer
# runs the fused pass (ell_edge_apply, path M), and no grouped launch
J_CONFIG = dataclasses.replace(BENCH_CONFIG, gather_dtype=None)
# path M, the fused pass (ell_edge_apply): M_ITERS iterations of the
# trainer's fused iteration against the separate passes composed from the
# kernel wrappers, from the same X each iteration, at these dims and
# replicas, both sample modes.  Per-vertex negatives (-bs 1) sum their
# samples in the same row class and order: the same bits.  Group-shared
# negatives sum each sample's pair scalar over the replica's row class
# (grouped_rep_force: X's), another lane order: held to the sound runs'
# upd_err, 5.6e-6 (PERF.md §9.2), and the same bits from run to run.
M_ITERS = 50
M_DIMS = (8, 64, 100, 128, 256)
M_GATHERS = (torch.bfloat16, torch.float16)
M_UPD_ERR = 5.6e-6
# path N, the carried replica: N_ITERS iterations of each configuration
# that carries it (what, TrainConfig over the bench's, replicas), at the
# bench graph and at com-Youtube's vertex count (WALK_BIG_N)
N_ITERS = 20
N_CONFIGS = (("sync", {}, 2), ("-bs 1", dict(per_vertex_samples=True), 2),
             ("rwalk", dict(model="rwalk"), 1))
# path L, run_span and train() as a CUDA graph: L_ITERS iterations of each
# configuration against the eager loop from the same seed, the same run in
# spans, bit for bit, and two eager runs against each other, in torch's
# default mode.  The hub owners' sums are ordered (ops/segment.py): while
# they were float atomics, two eager runs of main with f32 X differed by
# ~1e-7 after 20 iterations and of fr by up to 0.47 (its energy step
# normalises each row's update: a difference in a row's last bits turns
# its step).  The sync schedule is held again under torch's deterministic
# mode, as it was while its default mode could not be
L_ITERS = 20
L_SPANS = (7, 7, 6)
# (what, TrainConfig over the bench's): every single-card sync
# configuration
L_SYNC = (
    ("main f32 X", {}),
    ("main bf16 X", dict(dtype="bfloat16", gather_dtype=None)),
    ("main f16 X", dict(dtype="float16", gather_dtype=None)),
    ("main f16 replica", dict(gather_dtype="float16")),
    ("-bs 1", dict(per_vertex_samples=True)),
    ("rwalk", dict(model="rwalk")),
    ("sigmoid", dict(model="sigmoid")),
    ("sigmoid table", dict(model="sigmoid", sm_table=True)),
    ("fr", dict(model="fr")),
    ("linlog", dict(model="linlog")),
    ("forceatlas", dict(model="forceatlas")),
    ("dim 100", dict(dim=100)),
)
# (what, TrainConfig, graph): the batch trainer, the CLI's default at the
# bench graph, every other model and mode on SMALL_GRAPH, tdist_exact on
# EXACT_GRAPH
L_BATCH_CONFIG = TrainConfig(dim=128, batch_size=256, model="tdist", ns=5)
L_BATCH = (
    ("batch tdist", {}, "bench"),
    ("batch tdist bf16 X", dict(dtype="bfloat16"), "small"),
    ("batch tdist f16 X", dict(dtype="float16"), "small"),
    ("batch -bs 1", dict(per_vertex_samples=True), "small"),
    ("batch sigmoid", dict(model="sigmoid"), "small"),
    ("batch rwalk", dict(model="rwalk"), "small"),
    ("batch fr", dict(model="fr"), "small"),
    ("batch linlog", dict(model="linlog"), "small"),
    ("batch forceatlas", dict(model="forceatlas"), "small"),
    ("batch tdist_exact", dict(model="tdist_exact"), "exact"),
)
# (what, VertexShardedForce2Vec keywords, TrainConfig over the vertex
# schedule's): the vertex schedule at P = 1 (one card, no process group) at
# the bench graph
L_VERTEX = (
    ("vertex shared", {}, {}),
    ("vertex pool", dict(sampling="pool"), {}),
    ("vertex rwalk", {}, dict(model="rwalk")),
    ("vertex halo_stale", dict(halo_stale=True), {}),
    ("vertex bf16 X", {}, dict(dtype="bfloat16")),
)
# the configurations path L times, graph against eager
L_TIMED = ("main f32 X", "main bf16 X", "main f16 X", "rwalk", "batch tdist",
           "vertex shared")
ROOT = os.path.dirname(os.path.abspath(__file__))
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
# the split-dim kernels: the JAX package's tp sync step runs in jnp ops
# (Pallas off at tp > 1, force2vec_tpu/train/sync.py:269)
APPLY_SOURCE = "force2vec_tpu_torch/ops/csrc/ell_edge_apply.cu"
# the JAX iteration's x + (upd + repulsion), with the two kernels before it
APPLY_REPLACES = "force2vec_tpu/train/sync.py:668"
TP_SOURCE = "force2vec_tpu_torch/ops/csrc/tp_pair_force.cu"
TP_REPLACES = "force2vec_tpu/train/sync.py:269"
WALK_SOURCE = "force2vec_tpu_torch/ops/csrc/walk_steps.cu"
# the walk engine the kernel replaces: jnp ops in the JAX package
WALK_REPLACES = "force2vec_tpu/train/sync.py:789"
# path B times the walk engine again at com-Youtube's vertex count (the
# benchmark's youtube-rwalk.sync), at an average degree of 5 (com-Youtube's
# 5.3)
WALK_BIG_N = 1_134_890
WALK_BIG_DEG = 5
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
CUDA_KERNELS = ("ell_edge_force_kernel", "ell_edge_apply_kernel",
                "grouped_rep_force_kernel",
                "ell_sample_force_kernel", "take_sum_kernel",
                "tile_force_tc_kernel", "resident_gather_kernel",
                "read_sum_partial_kernel", "read_sum_final_kernel",
                "tp_pair_partial_kernel", "tp_pair_force_kernel")
# the instances the main path and path A run (bf16 replica, dim 128,
# tdist); they, every other instance of the three force kernels and the
# split-dim pair (every row class, exact and table sigma) and the ring
# kernels' instances must spill nothing
FORCE_KERNELS = ("ell_edge_force_kernel<", "ell_edge_apply_kernel<",
                 "ell_sample_force_kernel<",
                 "grouped_rep_force_kernel<", "tp_pair_partial_kernel<",
                 "tp_pair_force_kernel<")
# (replica, X, lanes a row, pieces a lane, the row fills its class, model;
# the repulsion: X, ...): dim 128 in bf16 or f16 fills 16 lanes of one
# 16-byte piece; the repulsion's rows are in X's type: 32 lanes of f32, 16
# of bf16 or f16 (X in bf16: path I; X in f16 and the f16 replica: path K)
MAIN_INSTANCES = ("ell_edge_force_kernel<bf16, f32, 16, 1, 1, 0>",
                  "ell_sample_force_kernel<bf16, f32, 16, 1, 1, 0>",
                  "grouped_rep_force_kernel<f32, 32, 1, 1, 0>",
                  "ell_edge_force_kernel<bf16, bf16, 16, 1, 1, 0>",
                  "ell_sample_force_kernel<bf16, bf16, 16, 1, 1, 0>",
                  "grouped_rep_force_kernel<bf16, 16, 1, 1, 0>",
                  "ell_edge_force_kernel<f16, f16, 16, 1, 1, 0>",
                  "ell_sample_force_kernel<f16, f16, 16, 1, 1, 0>",
                  "grouped_rep_force_kernel<f16, 16, 1, 1, 0>",
                  "ell_edge_force_kernel<f16, f32, 16, 1, 1, 0>",
                  "ell_sample_force_kernel<f16, f32, 16, 1, 1, 0>",
                  "ell_edge_apply_kernel<bf16, f32, 16, 1, 1, 0, 0>",
                  "ell_edge_apply_kernel<f16, f32, 16, 1, 1, 0, 0>")
RING_INSTANCES = ("take_sum_kernel<bf16>", "take_sum_kernel<f32>",
                  "tile_force_tc_kernel<bf16>", "tile_force_tc_kernel<f32>")
# take_sum's ring depths (stages per block) timed
TAKE_DEPTHS = (2, 3, 4)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def say(*args):
    print(*args, flush=True)


# the element types' mangled names, as ptxas_summary writes them
MANGLED_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def ptxas_summary(log: str) -> list:
    """One line per kernel instance from nvcc's ``-Xptxas=-v`` output:
    ``kernel<template arguments>: registers; spills``, e.g.
    ``ell_edge_force_kernel<bf16, f32, 16, 1, 1, 0>`` (replica, X, lanes,
    pieces, full, model) or ``resident_gather_kernel<16>``."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d([a-z_]+_kernel)I(\w+?)EEv",
                      line)
        if m:
            # the leading type arguments: f32, bf16, f16, or a mangling
            # substitution (``S2_``), which repeats the type before it
            types, args = [], m[2]
            while t := re.match(r"f|13__nv_bfloat16|6__half|S\d*_", args):
                types.append(MANGLED_TYPES.get(t[0]) or types[-1])
                args = args[t.end():]
            # a force model class (``EdgeForce<3>``), a bool (``Lb1E``)
            args = re.sub(r"NS_\d+([A-Za-z]+)ILi(\d+)EEE?", r", \1<\2>", args)
            args = re.sub(r"Lb(\d)E", r", \1", args)
            args = re.sub(r"Li(\d+)E?", r", \1", args)
            args = ", ".join(types) + args
            name, spill = f"{m[1]}<{args.lstrip(', ')}>", ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def half_ulp(t):
    """Half a unit in the last place of each element of a bf16 or f16
    ``t`` (X held in bf16 or f16: a kernel's f32 sum rounded once), as
    f32, at 0 half the least subnormal; 0 for f32."""
    if t.dtype == torch.float32:
        return 0.0
    fi = torch.finfo(t.dtype)
    # |t| in [2^(e-1), 2^e): ulp 2^(e-1)·eps; subnormals and 0 (an f16 sum
    # under half the least subnormal rounds to 0) keep the least normal
    # exponent's ulp
    _, e = torch.frexp(t.float())
    least = int(np.frexp(fi.tiny)[1])
    e = torch.where(t == 0, least, e.clamp(min=least))
    return fi.eps * torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                e - 2)


def bound_ratio(got, terms, rtol: float = SUM_RTOL) -> float:
    """max over elements of |got - Σ terms| / (rtol · Σ |terms|), the sums
    over dim 1; at most 1 passes.  An element whose terms are all 0 gives
    inf unless ``got`` is exactly 0 there.  A bf16 ``got`` is held to half
    an ulp of itself more (its rounding)."""
    err = (got.float() - terms.sum(dim=1)).abs()
    scale = rtol * terms.abs().sum(dim=1) + half_ulp(got)
    return float(torch.where(err == 0, 0.0, err / scale).max())


# A table model's kernel and plain version compute each pair's a = x_i.x_j
# in other orders, so they can read neighbouring table entries where a lies
# within rounding of a bin edge: both sums are within γ_D·Σ_d|x_i,d·x_j,d|
# of the exact a (γ_D ≈ D·2^-24, D ≤ 128), so within twice that of each
# other.  ``held_ratio`` holds a table kernel to the interval its plain
# terms span when a moves by that much either way.
TABLE_A_SHIFT = 2 * 128 * 2.0**-24


def _shifted(fn, sign, shift=TABLE_A_SHIFT):
    def rsum(v):
        return (v.sum(dim=-1, keepdim=True)
                + sign * shift * v.abs().sum(dim=-1, keepdim=True))
    return lambda *args, **kw: fn(*args, rsum=rsum, **kw)


def held_ratio(got, terms_of, model, rtol: float = SUM_RTOL,
               shift: float = TABLE_A_SHIFT, dot: bool = False) -> float:
    """``bound_ratio`` of ``got`` against ``terms_of(model)``, the plain
    per-term forces.  For a lookup-table model (with ``dot``, any model
    whose scalar is a dot product), each element must lie in the interval
    its terms span with every pair's a moved down and up by ``shift`` of
    its Σ|products| (σ and σ̂ are monotone, so each term's two ends bound
    it), to within ``rtol``·Σ|terms| (max over elements of the excess over
    that tolerance; at most 1 passes)."""
    if not (model.name.endswith("_table")
            or (dot and model.a_kind == "dot")):
        return bound_ratio(got, terms_of(model), rtol)
    lo, hi = (terms_of(dataclasses.replace(
        model, edge_force=_shifted(model.edge_force, sign, shift),
        sample_force=_shifted(model.sample_force, sign, shift)))
        for sign in (-1, 1))
    low = torch.minimum(lo, hi).sum(dim=1)
    high = torch.maximum(lo, hi).sum(dim=1)
    scale = (rtol * torch.maximum(lo.abs(), hi.abs()).sum(dim=1)
             + half_ulp(got))
    got = got.float()
    excess = (low - got).clamp(min=0) + (got - high).clamp(min=0)
    return float(torch.where(excess == 0, 0.0, excess / scale).max())


# -- the least time the card could take ---------------------------------------


def term_flops(model, kind: str, dim: int) -> int:
    """f32 operations of one edge or sample term, from the kernels' loops:
    the per-pair scalar (a dot or a squared distance) and the update."""
    if kind == "edge":
        return (4 if model.a_kind == "dot" else 5) * dim
    # tdist (clamped), sigmoid, layout, sigmoid table: common.cuh::
    # SampleForce
    return (8, 4, 5, 4)[fk._SAMPLE_MODEL_IDS[model.sample_force]] * dim


def ell_work(launches, x, xg, with_invd: bool, reads_out: bool = False):
    """(bytes, terms) that ``ell_edge_force`` or ``ell_sample_force`` over
    the launches ``(idx, deg, xi_row)`` must move and compute: each input
    read once (the x and replica rows they touch, the real slots' ids, deg,
    xi_row, for the edge force invd and, adding into ``out``, the output
    rows; x, invd and out in X's dtype) and each output row written once.
    Where X is its own gather table, a row that is both an x_i and a
    gathered row is read once.  Slots past deg are skipped, so they count
    nothing."""
    dim, xs = x.shape[1], x.element_size()
    xi = torch.cat([r for _, _, r in launches]).unique()
    real = torch.cat([
        idx[torch.arange(idx.shape[1], device=idx.device)[None, :]
            < deg[:, None]] for idx, deg, _ in launches])
    gathered = real.unique()
    if xg.data_ptr() == x.data_ptr() and xg.shape == x.shape:
        row_bytes = torch.cat([xi, gathered]).unique().numel() * dim * xs
    else:
        row_bytes = (xi.numel() * dim * xs
                     + gathered.numel() * dim * xg.element_size())
    rows = sum(r.numel() for _, _, r in launches)
    nbytes = (row_bytes + (xi.numel() * xs if with_invd else 0)
              + real.numel() * 4 + rows * 8
              + rows * dim * xs * (2 if reads_out else 1))
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
    args = (x, xg, b.nbr, b.deg, b.xi_row, invd, step)
    got = fk.ell_edge_force(model, *args)
    e = max_err(got, fk.ell_edge_force_terms(model, *args).sum(dim=1))
    ratio = held_ratio(got, lambda m: fk.ell_edge_force_terms(m, *args),
                       model)
    check(ratio <= 1.0, f"ell_edge_force {what}: |err| exceeds {SUM_RTOL} x "
                        f"sum |terms| by {ratio:.3f}x")
    return e, ratio


def check_rep(model, x, sg, step, what):
    """One ``grouped_rep_force`` launch against the plain terms; returns
    (max |err|, bound ratio)."""
    args = (BENCH_CONFIG.batch_size, x, sg, step)
    got = fk.grouped_rep_force(model, *args)
    e = max_err(got, fk.grouped_rep_force_terms(model, *args).sum(dim=1))
    ratio = held_ratio(got, lambda m: fk.grouped_rep_force_terms(m, *args),
                       model)
    check(ratio <= 1.0, f"grouped_rep_force {what}: |err| exceeds {SUM_RTOL} "
                        f"x sum |terms| by {ratio:.3f}x")
    return e, ratio


def check_sample(model, x, xg, idx, deg, rows, step, what):
    """One ``ell_sample_force`` launch against the plain terms; returns
    (max |err|, bound ratio)."""
    args = (x, xg, idx, deg, rows, step)
    got = fk.ell_sample_force(model, *args)
    e = max_err(got, fk.ell_sample_force_terms(model, *args).sum(dim=1))
    ratio = held_ratio(got, lambda m: fk.ell_sample_force_terms(m, *args),
                       model)
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
        args = (x, xg, nbr, deg, xi_row, invd, step)
        part = got[ob: ob + nbr.shape[0]]
        err = max(err, max_err(part, fk.ell_edge_force_terms(
            model, *args).sum(dim=1)))
        ratio = max(ratio, held_ratio(
            part, lambda m: fk.ell_edge_force_terms(m, *args), model))
    check(ratio <= 1.0, f"ell_edge_force_table {what}: |err| exceeds "
                        f"{SUM_RTOL} x sum |terms| by {ratio:.3f}x")
    return err, ratio


def edge_phase(fv, x, xg, card):
    """Edge kernel vs plain: each per-bucket launch of the bench layout,
    then the one work-table launch the path runs, for every separable
    model; times the table launch back to back and queued."""
    bucket_ms = 0.0
    for b in fv.device_buckets:
        kind = "hub" if b.owner_off is not None else "bucket"
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
    return max((b for b in fv.device_buckets if b.owner_off is None),
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
    """Repulsion kernel vs plain at the bench shape: stored, against its
    plain terms; then as the main path runs it, applying X += update +
    repulsion in place, bit for bit the stored result's two ``add_``s;
    both timed beside their bounds and plain versions."""
    sg = bench_samples(fv, xg, seed=5)
    e, ratio = check_rep(fv.model, x, sg, fv.lr, "tdist")
    check(e <= REP_TOL, f"grouped_rep_force: max |err| {e:.3e} > {REP_TOL}")
    group = BENCH_CONFIG.batch_size
    args = (fv.model, group, x, sg, fv.lr)
    km = cuda_ms(lambda: fk.grouped_rep_force(*args), reps=20)
    pm = cuda_ms(lambda: fk.grouped_rep_force_plain(*args), reps=5)
    upd = x * 0.01
    xa = x.clone()
    fk.grouped_rep_force(fv.model, group, xa, sg, fv.lr, mode="apply",
                         upd=upd)
    check(torch.equal(xa, x.clone().add_(upd.clone().add_(
        fk.grouped_rep_force(*args)))),
          "grouped_rep_force apply differs from upd.add_(rep); x.add_(upd)")
    am = cuda_ms(lambda: fk.grouped_rep_force(
        fv.model, group, xa, sg, fv.lr, mode="apply", upd=upd), reps=20)
    apm = cuda_ms(lambda: fk.grouped_rep_force_plain(
        fv.model, group, xa, sg, fv.lr, mode="apply", upd=upd), reps=5)
    n, dim = x.shape
    flops = n * sg.shape[1] * term_flops(fv.model, "sample", dim)
    sg_bytes = sg.numel() * sg.element_size()
    nbytes = 2 * n * dim * x.element_size() + sg_bytes
    b_ms, by = bound_ms(nbytes, flops)
    a_bytes = 3 * n * dim * x.element_size() + sg_bytes
    ab_ms, a_by = bound_ms(a_bytes, flops)
    say(f"grouped_rep_force rows={n} groups={sg.shape[0]} "
        f"max_abs_err={e:.3e} bound_ratio={ratio:.4f} kernel_ms={km:.4f} "
        f"plain_ms={pm:.4f} bound_ms={b_ms:.4f} ({by}: "
        f"{nbytes / 1e6:.1f} MB); applying X += update + repulsion (bit "
        f"for bit the two add_s): kernel_ms={am:.4f} plain_ms={apm:.4f} "
        f"bound_ms={ab_ms:.4f} ({a_by}: {a_bytes / 1e6:.1f} MB) [{card}]")
    return dict(max_abs_err=e, ms=am, plain_ms=apm, bound_ms=ab_ms,
                bound_by=a_by, mode="apply", store_ms=km, store_plain_ms=pm,
                store_bound_ms=b_ms)


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
    ``adds`` times if given; returns (kernel ms, plain ms, kernel ms
    queued ahead of the device)."""
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
    return k_ms, p_ms, q_ms


def sync_counts(fv, iters, separate) -> dict:
    """The launch counts ``iters`` iterations of the sync trainer ``fv``
    make: ``separate`` where it runs the separate passes, else its fused
    pass's (``fv.fused_apply``): an ``ell_edge_apply`` launch an
    iteration, a second over the hub's owner rows where the layout has a
    hub, and no other force kernel."""
    if not fv.fused_apply:
        return separate
    return {"ell_edge_apply": iters * (2 if fv._hub is not None else 1)}


def train_phase(fv, expect, card):
    """``train()`` for TRAIN_ITERS iterations with the launch counts set to
    0 just before; checks the counts equal ``expect`` (the probe kernels
    0) and that X is finite.  Returns the [n, D] embedding and the
    counts."""
    reset_counts()
    emb = fv.train(iters=TRAIN_ITERS, seed=1)
    counts = read_counts()
    expect = {**{k: 0 for k in counts}, **expect}
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


def distance_gap_check(graph, emb, margin, what, iters=TRAIN_ITERS):
    q = quality(graph, emb)
    gap = q["d_rand"] - q["d_edge"]
    say(f"quality {what} after {iters} iterations: mean edge distance "
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
    # none: the fused launch (or the repulsion launch) applies X +=
    # update + repulsion
    iter_ms, iter_plain_ms, iter_q_ms = iteration_phase(fv, x0, card, negs,
                                                        adds=0)
    updates = graph.nnz + graph.n * BENCH_CONFIG.ns  # bench.py:158-161
    say(f"ms_per_iteration kernels={iter_ms:.4f} plain={iter_plain_ms:.4f} "
        f"(CUDA events) [{card}]")
    say(f"edge_force_updates_per_s kernels={updates / iter_ms / 1e3:.2f} M "
        f"plain={updates / iter_plain_ms / 1e3:.2f} M [{card}]")

    emb, counts = train_phase(fv, sync_counts(fv, TRAIN_ITERS, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS,
        "ell_sample_force": 0}), card)
    distance_gap_check(graph, emb, QUALITY_MARGIN, "main path")
    return edge, rep, counts, len(fv.device_buckets), iter_q_ms


# -- path A: per-vertex negatives ------------------------------------------------


def accumulate_check(model, x, xg, idx, deg, rows, step, what):
    """``ell_sample_force(..., out=base, accumulate=True)`` equals
    ``base.add_(ell_sample_force(...))`` bit for bit."""
    base = torch.randn(x.shape, device=x.device,
                       generator=torch.Generator(x.device).manual_seed(19)
                       ).to(x.dtype)
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
    # none in the fused pass; else X += update (the repulsion is added
    # into the update in the kernel)
    iter_ms, iter_plain_ms, _ = iteration_phase(
        fv, x0, card, negs, adds=0 if fv.fused_apply else 1)
    say(f"per-vertex ms_per_iteration kernels={iter_ms:.4f} "
        f"plain={iter_plain_ms:.4f} (CUDA events) [{card}]")
    emb, counts = train_phase(fv, sync_counts(fv, TRAIN_ITERS, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": 0,
        "ell_sample_force": TRAIN_ITERS}), card)
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


def walk_draws(fv, gen):
    """``[walk_length, n_pad]`` int32: the walk's draws as ``draw_walks``
    takes them from ``gen``, one ``[n_pad]`` draw a step."""
    return torch.stack([torch.randint(0, 2**31 - 1, (fv.layout.n_pad,),
                                      generator=gen, dtype=torch.int32,
                                      device=fv.device)
                        for _ in range(fv.config.walk_length)])


def walk_ptxas(log: str):
    """nvcc's ``-Xptxas=-v`` registers line of the ``walk_steps`` kernel
    (not a template, so ``ptxas_summary`` lists it not), or None."""
    take = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            take = "10walk_stepsE" in line
        elif take and "registers" in line:
            return line.split(":", 1)[1].strip()
    return None


def walk_engine_phase(fv, card, what) -> dict:
    """The walk engine of ``fv`` (``draw_walks``: a draw a step, then one
    ``walk_steps`` launch) against ``walk_steps_plain`` over the draws
    taken again from the same seed, bit for bit (``max_abs_err`` 0); the
    kernel timed back to back and queued beside its least bytes (each real
    row's draws read and walk written, the graph's (deg, base) and slots
    read once) at the card's rate, and the engine beside the torch engine
    (the same draws, then ``walk_steps_plain``)."""
    dev, n_pad, wl = fv.device, fv.layout.n_pad, fv.config.walk_length
    db, pool = fv.walk_db, fv.walk_pool
    new = fv.draw_walks(torch.Generator(dev).manual_seed(17))
    r = walk_draws(fv, torch.Generator(dev).manual_seed(17))
    check(torch.equal(new, fk.walk_steps_plain(r, db, pool)),
          f"path B {what}: the walks differ from walk_steps_plain's over "
          "the same draws")
    gen = torch.Generator(dev).manual_seed(19)
    rec = {
        "rows": n_pad, "steps": wl, "max_abs_err": 0,
        "ms": cuda_ms(lambda: fk.walk_steps(r, db, pool), reps=20),
        "queued_ms": queued_device_ms(
            lambda: fk.walk_steps(r, db, pool), reps=20),
        "plain_ms": cuda_ms(lambda: fk.walk_steps_plain(r, db, pool),
                            reps=10),
        "engine_ms": cuda_ms(lambda: fv.draw_walks(gen), reps=20),
        "engine_queued_ms": queued_device_ms(lambda: fv.draw_walks(gen),
                                             reps=20),
        "torch_engine_ms": cuda_ms(
            lambda: fk.walk_steps_plain(walk_draws(fv, gen), db, pool),
            reps=10),
        "torch_engine_queued_ms": queued_device_ms(
            lambda: fk.walk_steps_plain(walk_draws(fv, gen), db, pool),
            reps=10),
    }
    nbytes = (2 * wl * fv.graph.n + 2 * fv.graph.n + fv.graph.nnz) * 4
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 0)
    say(f"path B {what}: walks [{n_pad}, {wl}] walk_steps_plain's over the "
        f"same draws bit for bit; walk_steps kernel {rec['ms']:.4f} ms "
        f"(queued {rec['queued_ms']:.4f}), plain {rec['plain_ms']:.4f}; "
        f"engine (draws + kernel) {rec['engine_ms']:.4f} (queued "
        f"{rec['engine_queued_ms']:.4f}) against the torch engine (draws + "
        f"walk_steps_plain) {rec['torch_engine_ms']:.4f} (queued "
        f"{rec['torch_engine_queued_ms']:.4f}); bound {rec['bound_ms']:.4f} "
        f"ms ({nbytes / 1e6:.1f} MB) [{card}]")
    return rec


def rwalk_path(graph, dev, card):
    """Path B; returns its launch counts and the walk kernel's record."""
    cfg = dataclasses.replace(BENCH_CONFIG, model="rwalk")
    fv = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
    n_pad, wl = fv.layout.n_pad, cfg.walk_length
    log = _build.library_path().with_suffix(".log").read_text()
    say(f"walk_steps ptxas: {walk_ptxas(log)}")
    gen = torch.Generator(dev).manual_seed(13)
    walks = fv.draw_walks(gen)
    moved, share, expect = check_walks(fv, walks)
    say(f"walks [{n_pad}, {wl}]: {moved} steps land on neighbours, slot-0 "
        f"share {share:.4f} vs uniform {expect:.4f} [{card}]")
    walk = walk_engine_phase(fv, card, "bench graph")
    walk_ms = walk["engine_ms"]
    big = SyncForce2Vec(
        synth_powerlaw_graph(n=WALK_BIG_N, avg_deg=WALK_BIG_DEG), cfg,
        MIN_WIDTH, HUB_WIDTH, device=dev)
    moved, share, expect = check_walks(big, big.draw_walks(gen))
    say(f"path B n={WALK_BIG_N}: {moved} steps land on neighbours, slot-0 "
        f"share {share:.4f} vs uniform {expect:.4f} [{card}]")
    walk["youtube_n"] = walk_engine_phase(big, card, f"n={WALK_BIG_N}")
    del big

    emb, counts = train_phase(fv, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS,
        "ell_sample_force": 0, "walk_steps": TRAIN_ITERS}, card)
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
    iter_ms, iter_plain_ms, _ = iteration_phase(fv, x, card, negs,
                                                walks=walks)
    say(f"rwalk ms_per_iteration (walks injected) kernels={iter_ms:.4f} "
        f"plain={iter_plain_ms:.4f}, walk engine {walk_ms:.4f} more (CUDA "
        f"events) [{card}]")
    return counts, walk


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
    expect = {**{k: 0 for k in counts}, "ell_edge_force": buckets * looped + 1,
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


def file_path(graph, dev, card, tmp):
    """Path D: the bench graph through a .mtx file (``tmp/bench.mtx``, which
    path E reads too), 50 training iterations with exact launch counts, the
    .embd round trip, and the scores of the trained X against a
    random-normal control, all on the card."""
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "the native graph loader did not "
                                        "build (g++)")
    say(f"native graph loader: {time.perf_counter() - t0:.3f} s "
        f"-> {native.library_path().name}")
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
    emb, counts = train_phase(fv, sync_counts(fv, TRAIN_ITERS, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS,
        "ell_sample_force": 0}), card)
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


# -- path E: the command line ----------------------------------------------------


def cli_run(argv, expect, what, card):
    """``python -m force2vec_tpu_torch`` as ``cli.main(argv)`` in this
    process, with the launch counts set to 0 just before and read just
    after: checks the exit code and that the counts equal ``expect`` (the
    others 0).  Returns (counts, the command's standard output)."""
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    counts = read_counts()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"the CLI ({what}) exited {rc}")
    expect = {**{k: 0 for k in counts}, **expect}
    say(f"cli {what}: {seconds:.2f} s, launches {counts} [{card}]")
    check(counts == expect, f"cli {what}: launch counts {counts} != {expect}")
    return counts, out.getvalue()


def model_by(name):
    """A model of EDGE_MODELS or SAMPLE_MODELS: ``<name>_table`` is the
    sigmoid family's lookup-table variant."""
    if name.endswith("_table"):
        return get_model(name[: -len("_table")], sm_table=True)
    return get_model(name)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def cli_outputs(out_dir, name, row):
    """The CLI wrote ``name`` and one Results.txt row whose fields before
    the time are ``row``; returns the .embd's path and the row's seconds."""
    got = sorted(f for f in os.listdir(out_dir) if f.endswith(".embd"))
    check(got == [name], f"CLI outputs {got}, expected {name}")
    with open(os.path.join(out_dir, "Results.txt")) as f:
        fields = f.read().strip().split("\t")
    check(fields[:-1] == row and fields[-1].startswith("Time(sec.):"),
          f"Results.txt row {fields} != {row} + time")
    return os.path.join(out_dir, name), float(fields[-1].split(":")[1])


def check_embd_head(path, emb, rows=EMBD_HEAD_ROWS):
    """The text ``.embd`` at ``path`` has ``emb``'s shape in its header,
    and its first ``rows`` rows hold ``emb``'s within the text's rounding
    (the whole file is read back in path D)."""
    with open(path) as f:
        check(f.readline().split() == [str(n) for n in emb.shape],
              f"{path}: the header is not {emb.shape}")
        head = np.array([f.readline().split() for _ in range(rows)],
                        dtype=np.float64)
    check(np.array_equal(head[:, 0], np.arange(1, rows + 1)),
          f"{path}: the first rows' ids")
    want = emb[:rows].astype(np.float64)
    off = np.abs(head[:, 1:] - want) > EMBD_ATOL + EMBD_RTOL * np.abs(want)
    check(not off.any(), f"{path}: {int(off.sum())} values differ from the "
                         "checkpoint")


def batch_cli_phase(graph, mtx, tmp, dev, card):
    """(a) ``python3 -m force2vec_tpu_torch -input bench.mtx -option 5 -iter
    CLI_ITERS --checkpoint-every CLI_ITERS`` as a subprocess (the batch
    schedule, batch 256, dim 128): its .embd name, header and first rows
    (against the checkpoint, which holds the same X at full precision),
    its Results.txt row, the quality margin; then, in this process, the
    same trainer's ms per iteration and device operations per batch.
    Returns those numbers."""
    out = os.path.join(tmp, "batch")
    cmd = [sys.executable, "-m", "force2vec_tpu_torch", "-input", mtx,
           "-option", "5", "-iter", str(CLI_ITERS), "-output", out,
           "--checkpoint-every", str(CLI_ITERS)]
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=600)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"the batch CLI exited {res.returncode}: "
                               f"{res.stderr[-2000:]}")
    embd, train_s = cli_outputs(
        out, f"bench.mtxF2VTDIST256D128IT{CLI_ITERS}NS5.embd",
        ["tdist", "Init", f"Iteration:{CLI_ITERS}", "Numofthreads:0",
         "BatchSize:256", "Dimension:128"])
    emb, it = load_checkpoint(os.path.join(out, f"ckpt_{CLI_ITERS:07d}.npz"))
    check(it == CLI_ITERS and emb.shape == (graph.n, 128)
          and np.isfinite(emb).all(),
          f"batch CLI checkpoint {emb.shape} at {it}, finite "
          f"{np.isfinite(emb).all()}")
    check_embd_head(embd, emb)
    say(f"cli batch schedule (subprocess): {wall:.2f} s in all, training "
        f"{train_s:.3f} s = {train_s * 1e3 / CLI_ITERS:.2f} ms/iteration "
        f"(host clock), .embd {emb.shape} [{card}]")
    distance_gap_check(graph, torch.as_tensor(emb, device=dev),
                       BATCH_QUALITY_MARGIN, "batch CLI", iters=CLI_ITERS)

    fv = Force2Vec(graph, TrainConfig(dim=128, batch_size=256, model="tdist",
                                      ns=5), device=dev)
    x = fv.init_embedding(seed=1)
    reset_counts()
    ms = cuda_ms(lambda: fv.run_span(x, 1, 1), reps=3, warmup=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fv.run_span(x, 1, 1)
        torch.cuda.synchronize()
    counts = read_counts()
    check(not any(counts.values()),
          f"the batch schedule launched a force kernel: {counts}")
    ops = device_breakdown(prof, 1)
    n_ops = sum(k["launches_per_iter"] for k in ops.values())
    busy = sum(k["ms_per_iter"] for k in ops.values())
    nb = fv.dg.num_batches
    say(f"batch schedule iteration: {ms:.3f} ms (CUDA events, back to back), "
        f"{n_ops:.0f} device operations ({n_ops / nb:.2f} per batch, "
        f"{nb} batches), device busy {busy:.3f} ms, idle share "
        f"{1 - busy / ms:.3f} [{card}]")
    return dict(ms_per_iter=ms, cli_ms_per_iter=train_s * 1e3 / CLI_ITERS,
                ops_per_batch=n_ops / nb)


def batch_parity_phase(small, dev, card):
    """(b) The batch trainer's iteration on the card against the same
    iteration on the CPU, from the same X and injected negatives and walks,
    within BATCH_CPU_TOL; two runs from one seed give equal bits."""
    rng = np.random.default_rng(21)
    for model, per_vertex in (("tdist", False), ("sigmoid", True),
                              ("rwalk", False)):
        cfg = TrainConfig(dim=128, batch_size=256, model=model, ns=5,
                          per_vertex_samples=per_vertex)
        fc = Force2Vec(small, cfg, device="cpu")
        fg = Force2Vec(small, cfg, device=dev)
        dg = fc.dg
        # a symmetric X: at the sigmoid family's [0, 1) init the attraction
        # is 0 (see rwalk_path) and the check would be vacuous
        x0 = (rng.random((small.n, 128)) * 2 - 1).astype(np.float32)
        m = cfg.ns * dg.batch_size if per_vertex else cfg.ns
        negs = rng.integers(0, small.n - 1, (dg.num_batches, m),
                            dtype=np.int32)
        walks = (rng.integers(0, small.n, (dg.n_pad, cfg.walk_length),
                              dtype=np.int32) if model == "rwalk" else None)
        want = fc.run_iteration(fc.pad_embedding(x0), negs, walks)
        got = fg.run_iteration(fg.pad_embedding(x0), negs, walks).cpu()
        e = max_err(got, want)
        moved = max_err(want, fc.pad_embedding(x0))
        say(f"batch iteration {model}{' -bs 1' if per_vertex else ''} card "
            f"vs CPU: max_abs_err={e:.3e} (X moved up to {moved:.3e})")
        check(bool(torch.isfinite(got).all()) and e <= BATCH_CPU_TOL,
              f"batch iteration {model}: card vs CPU {e:.3e} > "
              f"{BATCH_CPU_TOL}")
    fg = Force2Vec(small, TrainConfig(dim=128, batch_size=256), device=dev)
    a, b = fg.train(iters=5, seed=7), fg.train(iters=5, seed=7)
    check(torch.equal(a, b), "the batch trainer is not deterministic on the "
                             "card")
    say(f"batch trainer, 5 iterations twice from seed 7: equal bits [{card}]")


def exact_phase(dev, card):
    """(c) ``tdist_exact`` (option 1, O(n²) repulsion) for EXACT_ITERS
    iterations on EXACT_GRAPH: finite, edges closer than random pairs."""
    g = synth_powerlaw_graph(**EXACT_GRAPH)
    fv = Force2Vec(g, TrainConfig(dim=128, batch_size=256,
                                  model="tdist_exact"), device=dev)
    emb = fv.train(iters=EXACT_ITERS, seed=1)
    check(bool(torch.isfinite(emb).all()), "tdist_exact: X is not finite")
    say(f"tdist_exact on n={g.n} nnz={g.nnz}: {fv.last_train_seconds:.3f} s "
        f"for {EXACT_ITERS} iterations [{card}]")
    distance_gap_check(g, emb, 0.0, "tdist_exact", iters=EXACT_ITERS)


def time_kernels(model, fv, x, xg, sg, idx, deg, rows, step) -> dict:
    """{kernel: (ms, bound_ms, plain_ms, bound_by)} of the three training
    kernels as
    the sync paths run them: the edge kernel over ``fv.edge_table``,
    ``grouped_rep_force`` over the 256-row groups' samples ``sg``, and
    ``ell_sample_force`` adding the ``[n_pad, ns]`` samples ``idx`` into an
    update; each beside its bound and its plain version's time.  The
    kernels are timed queued ahead of the device: back to back, a launch
    under ~0.1 ms waits for its wrapper's 50-110 µs of host time."""
    dim, n = x.shape[1], x.shape[0]
    table, group = fv.edge_table, BENCH_CONFIG.batch_size
    upd = torch.zeros_like(x)
    edge_args = (model, x, xg, table, fv.inv_deg.to(x.dtype), step)
    edge = queued_device_ms(lambda: fk.ell_edge_force_table(*edge_args),
                            reps=20)
    edge_p = cuda_ms(lambda: fk.ell_edge_force_table_plain(*edge_args),
                     reps=3)
    nbytes, terms = ell_work([p[:3] for p in table.parts()], x, xg, True)
    edge_b = bound_ms(nbytes, terms * term_flops(model, "edge", dim))
    rep_args = (model, group, x, sg, step)
    rep = queued_device_ms(lambda: fk.grouped_rep_force(*rep_args), reps=20)
    rep_p = cuda_ms(lambda: fk.grouped_rep_force_plain(*rep_args), reps=3)
    rep_b = bound_ms(2 * n * dim * x.element_size()
                     + sg.numel() * sg.element_size(),
                     n * sg.shape[1] * term_flops(model, "sample", dim))
    sample_args = (model, x, xg, idx, deg, rows, step)
    sample = queued_device_ms(lambda: fk.ell_sample_force(
        *sample_args, out=upd, accumulate=True), reps=20)
    sample_p = cuda_ms(lambda: fk.ell_sample_force_plain(
        *sample_args, out=upd, accumulate=True), reps=3)
    nbytes, terms = ell_work([(idx, deg, rows)], x, xg, False, True)
    sample_b = bound_ms(nbytes, terms * term_flops(model, "sample", dim))
    return {"ell_edge_force": (edge, edge_b[0], edge_p, edge_b[1]),
            "grouped_rep_force": (rep, rep_b[0], rep_p, rep_b[1]),
            "ell_sample_force": (sample, sample_b[0], sample_p,
                                 sample_b[1])}


def dim64_phase(graph, mtx, tmp, dev, card):
    """(d) ``--schedule sync -dim 64`` through the CLI (exact launch
    counts), then every dim-64 instance against its plain version at the
    bench shapes, both gather dtypes, with a planted fault per kernel;
    times the three kernels at dim 64 with bf16.  Returns (counts,
    {kernel: ms})."""
    out = os.path.join(tmp, "sync64")
    counts, _ = cli_run(["-input", mtx, "-option", "5", "-iter",
                         str(SYNC_CLI_ITERS), "-dim", "64", "--schedule",
                         "sync", "-output", out],
                        {"ell_edge_force": SYNC_CLI_ITERS,
                         "grouped_rep_force": SYNC_CLI_ITERS},
                        "--schedule sync -dim 64", card)
    embd, _ = cli_outputs(
        out, f"bench.mtxF2VTDIST256D64IT{SYNC_CLI_ITERS}NS5.embd",
        ["tdist", "Init", f"Iteration:{SYNC_CLI_ITERS}", "Numofthreads:0",
         "BatchSize:256", "Dimension:64"])
    with open(embd) as f:
        check(f.readline().split() == [str(graph.n), "64"],
              "the dim-64 .embd header")

    cfg = dataclasses.replace(BENCH_CONFIG, dim=64)
    fv = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
    n_pad, ns = fv.layout.n_pad, cfg.ns
    x0 = fv.init_embedding(seed=1)
    idx = torch.randint(0, graph.n - 1, (n_pad, ns), dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(11),
                        device=dev)
    deg = torch.full((n_pad,), ns, dtype=torch.int32, device=dev)
    rows = torch.arange(n_pad, dtype=torch.int32, device=dev)
    worst = {"edge": 0.0, "rep": 0.0, "sample": 0.0}
    for xg in (x0.to(torch.bfloat16), x0):
        sg = bench_samples(fv, xg, seed=5)
        for name in EDGE_MODELS:
            model = model_by(name)
            _, r = check_table(model, x0, xg, fv.edge_table, fv.inv_deg,
                               0.02, f"dim 64 {xg.dtype} {name}")
            worst["edge"] = max(worst["edge"], r)
        for name in SAMPLE_MODELS:
            model = model_by(name)
            _, r = check_rep(model, x0, sg, 0.02, f"dim 64 {xg.dtype} {name}")
            worst["rep"] = max(worst["rep"], r)
            _, r = check_sample(model, x0, xg, idx, deg, rows, 0.02,
                                f"dim 64 {xg.dtype} {name}")
            accumulate_check(model, x0, xg, idx, deg, rows, 0.02,
                             f"dim 64 {xg.dtype} {name}")
            worst["sample"] = max(worst["sample"], r)
    say(f"dim 64: every instance (bf16 and f32 gathers; edge: "
        f"{', '.join(EDGE_MODELS)}; repulsion: {', '.join(SAMPLE_MODELS)}) "
        f"within the bound: worst ratios {worst}; ell_sample_force "
        f"accumulate=True bit for bit out.add_")

    xg = x0.to(torch.bfloat16)
    sg = bench_samples(fv, xg, seed=5)
    _, skipped = table_planted_fault_ratios(fv.model, x0, xg, fv.edge_table,
                                            fv.inv_deg, fv.lr)
    rep_ratio, _ = planted_fault_ratios(fv.model, BENCH_CONFIG.batch_size, x0,
                                        xg, widest_bucket(fv), fv.inv_deg, sg,
                                        fv.lr)
    _, skip_last = sample_planted_fault_ratios(fv.model, x0, xg, idx, deg,
                                               rows, fv.lr)
    say(f"dim 64 planted faults: table's first entry skipped bound_ratio="
        f"{skipped:.2f}, repulsion 2/r^2 {rep_ratio:.2f}, last sample "
        f"skipped {skip_last:.2f} (must be > 1)")
    check(min(skipped, rep_ratio, skip_last) > 1.0,
          "the bound passed a planted fault at dim 64")

    ms = time_kernels(fv.model, fv, x0, xg, sg, idx, deg, rows, fv.lr)
    say(f"dim 64 (kernel_ms queued, bound_ms, plain_ms), bf16 gathers, the "
        f"bench shapes: "
        f"{json.dumps(ms)} [{card}]")
    return counts, ms


def table_phase(graph, mtx, tmp, dev, card):
    """(e) ``-option 6`` and ``-option 7`` with ``--sm-table`` on the sync
    schedule through the CLI (exact launch counts); the table instances
    against their plain versions at the bench shapes, with a planted fault
    (the exact σ's plain terms), timed beside exact σ's; one iteration in
    table mode differs from exact σ by more than 0 and less than the
    table's resolution allows.  Returns (the CLI runs' counts, {"table":
    time_kernels of the table model, "exact": of exact sigmoid})."""
    total = {}
    for opt, name in ((6, "SIGMOID_TABLE"), (7, "RWALK_TABLE")):
        out = os.path.join(tmp, f"table{opt}")
        counts, _ = cli_run(["-input", mtx, "-option", str(opt), "-iter",
                             str(TABLE_CLI_ITERS), "-dim", "64", "--schedule",
                             "sync", "--sm-table", "-output", out],
                            {"ell_edge_force": TABLE_CLI_ITERS,
                             "grouped_rep_force": TABLE_CLI_ITERS,
                             "walk_steps": TABLE_CLI_ITERS * (opt == 7)},
                            f"-option {opt} --sm-table --schedule sync", card)
        cli_outputs(out, f"bench.mtx{'F2V' + name}256D64IT"
                         f"{TABLE_CLI_ITERS}NS5.embd",
                    [name.lower(), "Init", f"Iteration:{TABLE_CLI_ITERS}",
                     "Numofthreads:0", "BatchSize:256", "Dimension:64"])
        add_counts(total, counts)

    cfg = dataclasses.replace(BENCH_CONFIG, model="sigmoid")
    fvt = SyncForce2Vec(graph, dataclasses.replace(cfg, sm_table=True),
                        MIN_WIDTH, HUB_WIDTH, device=dev)
    fve = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
    table, exact = fvt.model, fve.model
    # a symmetric X (the tdist init), where x_i.x_j spans the table
    x0 = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH,
                       device=dev).init_embedding(seed=1)
    xg = x0.to(torch.bfloat16)
    n_pad, ns, step = fvt.layout.n_pad, cfg.ns, fvt.lr
    sg = bench_samples(fvt, xg, seed=5)
    idx = torch.randint(0, graph.n - 1, (n_pad, ns), dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(11),
                        device=dev)
    deg = torch.full((n_pad,), ns, dtype=torch.int32, device=dev)
    rows = torch.arange(n_pad, dtype=torch.int32, device=dev)
    _, r_edge = check_table(table, x0, xg, fvt.edge_table, fvt.inv_deg, step,
                            "sigmoid table")
    _, r_rep = check_rep(table, x0, sg, step, "sigmoid table")
    _, r_sample = check_sample(table, x0, xg, idx, deg, rows, step,
                               "sigmoid table")
    accumulate_check(table, x0, xg, idx, deg, rows, step, "sigmoid table")
    # planted fault: a table kernel that computed exact σ
    got = fk.ell_edge_force_table(table, x0, xg, fvt.edge_table, fvt.inv_deg,
                                  step)
    f_edge = max(bound_ratio(got[ob: ob + nbr.shape[0]],
                             fk.ell_edge_force_terms(exact, x0, xg, nbr, d,
                                                     xi_row, fvt.inv_deg,
                                                     step))
                 for nbr, d, xi_row, ob in fvt.edge_table.parts())
    f_rep = bound_ratio(fk.grouped_rep_force(table, BENCH_CONFIG.batch_size,
                                             x0, sg, step),
                        fk.grouped_rep_force_terms(
                            exact, BENCH_CONFIG.batch_size, x0, sg, step))
    f_sample = bound_ratio(fk.ell_sample_force(table, x0, xg, idx, deg, rows,
                                               step),
                           fk.ell_sample_force_terms(exact, x0, xg, idx, deg,
                                                     rows, step))
    say(f"sigmoid table instances: bound ratios edge {r_edge:.4f}, rep "
        f"{r_rep:.4f}, sample {r_sample:.4f}; against exact sigma's terms "
        f"(planted fault) {f_edge:.2f}, {f_rep:.2f}, {f_sample:.2f} (must be "
        f"> 1)")
    check(min(f_edge, f_rep, f_sample) > 1.0,
          "the bound passed a table kernel computing exact sigma")
    times = {"table": time_kernels(table, fvt, x0, xg, sg, idx, deg, rows,
                                   step),
             "exact": time_kernels(exact, fvt, x0, xg, sg, idx, deg, rows,
                                   step)}
    say(f"sigmoid (kernel_ms queued, bound_ms, plain_ms), bf16 gathers, dim "
        f"128, the bench shapes: {json.dumps(times)} [{card}]")

    ng = -(-n_pad // cfg.batch_size)
    negs = np.random.default_rng(7).integers(
        0, graph.n - 1, size=(ng, ns)).astype(np.int32)
    xt = fvt.run_iteration(x0.clone(), negs)
    e_plain = max_err(xt, fvt.run_iteration(x0.clone(), negs, plain=True))
    xe = fve.run_iteration(x0.clone(), negs)
    d = max_err(xt, xe)
    # per element: the attraction's Σ invd·|xg_j| ≤ max|xg| and ns
    # repulsion terms, each off by at most TABLE_ERR · step · max|xg|
    bound = TABLE_ERR * step * (1 + ns) * float(xg.float().abs().max())
    say(f"one sigmoid iteration, table vs exact sigma: max |diff| {d:.3e} "
        f"(needs 0 < it < {bound:.3e}); table kernels vs plain {e_plain:.3e}")
    check(0.0 < d < bound, "table mode vs exact sigma: the difference is "
                           "not within (0, the table's resolution)")
    check(e_plain < ITER_TOL, f"table iteration kernels vs plain {e_plain}")
    return total, times


def sync_quality_phase(graph, dev, card):
    """``sigmoid`` (-option 6, exact σ) and ``fr`` (-option 2) on the sync
    schedule at the bench configuration, TRAIN_ITERS iterations with exact
    launch counts, each held to the JAX package in its statistic."""
    total = {}
    expect = {"ell_edge_force": TRAIN_ITERS,
              "grouped_rep_force": TRAIN_ITERS, "ell_sample_force": 0}
    fv = SyncForce2Vec(graph, dataclasses.replace(BENCH_CONFIG,
                                                  model="sigmoid"),
                       MIN_WIDTH, HUB_WIDTH, device=dev)
    emb, counts = train_phase(fv, sync_counts(fv, TRAIN_ITERS, expect), card)
    add_counts(total, counts)
    q = quality(graph, emb)
    gap = q["dot_edge"] - q["dot_rand"]
    say(f"quality sigmoid after {TRAIN_ITERS} iterations: mean edge x_i.x_j "
        f"{q['dot_edge']:.4f}, random pairs {q['dot_rand']:.4f}, gap "
        f"{gap:.4f} (JAX {JAX_SIGMOID_DOT_GAP:.4f}; needs > "
        f"{SIGMOID_DOT_MARGIN:.4f})")
    check(gap > SIGMOID_DOT_MARGIN, "sigmoid: edges do not have a larger dot "
                                    "product than random pairs by the margin")

    fv = SyncForce2Vec(graph, dataclasses.replace(BENCH_CONFIG, model="fr"),
                       MIN_WIDTH, HUB_WIDTH, device=dev)
    emb, counts = train_phase(fv, sync_counts(fv, TRAIN_ITERS, expect), card)
    add_counts(total, counts)
    q = quality(graph, emb)
    gap = q["d_rand"] - q["d_edge"]
    say(f"quality fr after {TRAIN_ITERS} iterations: mean edge distance "
        f"{q['d_edge']:.4f}, random pairs {q['d_rand']:.4f}, gap {gap:.4f} "
        f"(JAX {JAX_FR_GAP:.4f}; needs within {FR_GAP_TOL:.4f} of it)")
    check(abs(gap - JAX_FR_GAP) <= FR_GAP_TOL,
          "fr: the distance gap strays from the JAX package's")
    return total


def resume_phase(small_mtx, tmp, card):
    """(f) ``--checkpoint-every`` over RESUME_ITERS iterations, then
    ``--resume`` from the middle checkpoint, on both schedules, against a
    straight run, bit for bit (the sync schedule's hub sums in a fixed
    order).  Returns the runs' counts."""
    total = {}
    k = RESUME_ITERS // 3
    for schedule in ("batch", "sync"):
        base = ["-input", small_mtx, "-option", "5", "-iter",
                str(RESUME_ITERS), "--schedule", schedule]

        def run(tag, iters, *extra):
            out = os.path.join(tmp, f"resume_{schedule}_{tag}")
            launches = iters if schedule == "sync" else 0
            counts, _ = cli_run(base + ["-output", out, *extra],
                                {"ell_edge_force": launches,
                                 "grouped_rep_force": launches},
                                f"{schedule} {tag}", card)
            add_counts(total, counts)
            return out

        straight = run("straight", RESUME_ITERS, "--checkpoint-every",
                       str(RESUME_ITERS))
        ck = run("checkpointed", RESUME_ITERS, "--checkpoint-every", str(k))
        mid = os.path.join(ck, f"ckpt_{2 * k:07d}.npz")
        resumed = run("resumed", RESUME_ITERS - 2 * k, "--resume", mid,
                      "--checkpoint-every", str(k))
        last = f"ckpt_{RESUME_ITERS:07d}.npz"
        want, _ = load_checkpoint(os.path.join(straight, last))
        for tag, d in (("checkpointed", ck), ("resumed", resumed)):
            got, it = load_checkpoint(os.path.join(d, last))
            e = float(np.abs(got - want).max())
            say(f"{schedule} schedule, {tag} run vs straight run at iteration "
                f"{it}: max |diff| {e:.3e}")
            check(it == RESUME_ITERS and np.isfinite(got).all(),
                  f"{schedule} {tag}: checkpoint at {it}")
            check(np.array_equal(got, want), f"{schedule} {tag}: not bit for "
                                             "bit the straight run")
    return total


def refusal_phase(mtx, tmp, card):
    """The sync schedule at dim 96, once refused (the kernels took 64 and
    128), runs through the command line: exact launch counts, an ``.embd``
    of 96 columns under the JAX CLI's name.  Then the command line on the
    card refuses, exiting 2 with a message and writing nothing, the sync
    schedule above the kernels' cap (dim 1025), a multi-host coordinator
    with neither the world size nor the rank, and more ranks than the host
    has cards.  Returns the dim-96 run's counts."""
    it = TABLE_CLI_ITERS
    out96 = os.path.join(tmp, "sync96")
    counts, _ = cli_run(["-input", mtx, "-option", "5", "-iter", str(it),
                         "-dim", "96", "--schedule", "sync", "-output",
                         out96],
                        {"ell_edge_force": it, "grouped_rep_force": it},
                        "--schedule sync -dim 96", card)
    embd, _ = cli_outputs(
        out96, f"bench.mtxF2VTDIST256D96IT{it}NS5.embd",
        ["tdist", "Init", f"Iteration:{it}", "Numofthreads:0",
         "BatchSize:256", "Dimension:96"])
    with open(embd) as f:
        check(f.readline().split()[1] == "96", "the dim-96 .embd header")
    out = os.path.join(tmp, "refused")
    cap = fk.KERNEL_MAX_DIM
    for extra, why in ((["--schedule", "sync", "-dim", str(cap + 1)],
                        f"1 to {cap}"),
                       (["--coordinator", "localhost:1"],
                        "world size and rank"),
                       (["--devices", str(torch.cuda.device_count() + 1)],
                        "cards")):
        err = io.StringIO()
        reset_counts()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-input", mtx, "-output", out, "-iter", "1"]
                          + extra)
        check(rc == 2 and why in err.getvalue(),
              f"the CLI with {extra} exited {rc}: {err.getvalue()!r}")
        check(not any(read_counts().values()) and not os.path.exists(out),
              f"the CLI with {extra} ran or wrote before refusing")
    say(f"cli: the sync schedule at dim 96 runs; refusals: the sync "
        f"schedule at dim {cap + 1} (above the cap), a coordinator without "
        f"world size and rank, and more ranks than cards exit 2 with a "
        f"message, launching nothing [{card}]")
    return counts


def cli_path(graph, mtx, dev, card):
    """Path E, the command line on the card: (a)-(f) and the sigmoid and fr
    quality checks.  Returns (the launch counts of its driven runs, the
    batch schedule's times, the dim-64 kernel times, the sigmoid kernel
    times with the table and exact)."""
    small = synth_powerlaw_graph(**SMALL_GRAPH)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        small_mtx = os.path.join(tmp, "small.mtx")
        write_mtx(small, small_mtx)
        t0 = time.perf_counter()
        batch = batch_cli_phase(graph, mtx, tmp, dev, card)
        say(f"path E (a): {time.perf_counter() - t0:.1f} s")
        batch_parity_phase(small, dev, card)
        exact_phase(dev, card)
        d_counts, ms64 = dim64_phase(graph, mtx, tmp, dev, card)
        add_counts(counts, d_counts)
        t_counts, sigmoid_ms = table_phase(graph, mtx, tmp, dev, card)
        add_counts(counts, t_counts)
        add_counts(counts, sync_quality_phase(graph, dev, card))
        add_counts(counts, resume_phase(small_mtx, tmp, card))
        add_counts(counts, refusal_phase(mtx, tmp, card))
    return counts, batch, ms64, sigmoid_ms


# -- path F: the vertex and sharded schedules --------------------------------


@contextlib.contextmanager
def nccl_world_of_one(dev):
    """A real NCCL process group of one rank, rendezvousing through a
    FileStore in a temporary directory; one ``all_reduce`` proves it."""
    torch.cuda.set_device(dev)
    tmp = tempfile.mkdtemp(prefix="f2v_nccl_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        check(float(t.sum()) == 4.0, "NCCL all_reduce of one rank")
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def check_partial_table(model, x, xg, table, invd, step, what):
    """One launch of a vertex shard's work table (its entries write some of
    the output rows) against the per-entry plain terms; returns (max
    |err|, bound ratio, the launch's output)."""
    got = torch.full((table.out_rows, x.shape[1]), float("nan"),
                     device=x.device)
    fk.ell_edge_force_table(model, x, xg, table, invd, step, out=got)
    err = ratio = 0.0
    for nbr, deg, xi_row, ob in table.parts():
        args = (x, xg, nbr, deg, xi_row, invd, step)
        part = got[ob: ob + nbr.shape[0]]
        terms = fk.ell_edge_force_terms(model, *args)
        err = max(err, max_err(part, terms.sum(dim=1)))
        ratio = max(ratio, bound_ratio(part, terms))
    check(ratio <= 1.0, f"ell_edge_force_table {what}: |err| exceeds "
                        f"{SUM_RTOL} x sum |terms| by {ratio:.3f}x")
    return err, ratio, got


def shard_kernel_phase(model, t, x, tab, pool_rows, choice, step, what):
    """Each launch a shard's local update makes, on its operands, against
    its plain version: the free table (gathering from x_loc), the dep table
    (from ``tab`` = [x_loc | hot | halo]) and the repulsion (one group of
    n_loc rows, or ``choice`` into the pool rows).  Returns the worst ratio
    and max |err|."""
    out = {}
    if t.free is not None:
        out["free"] = check_partial_table(model, x, x, t.free, t.inv_deg,
                                          step, f"{what} free slabs")[:2]
    if t.dep is not None:
        out["dep"] = check_partial_table(model, x, tab, t.dep, t.inv_deg,
                                         step, f"{what} dep slabs")[:2]
    if choice is None:
        sg = pool_rows[None]
        got = fk.grouped_rep_force(model, t.n_loc, x, sg, step)
        terms = fk.grouped_rep_force_terms(model, t.n_loc, x, sg, step)
    else:
        deg = torch.full((t.n_loc,), choice.shape[1], dtype=torch.int32,
                         device=x.device)
        got = fk.ell_sample_force(model, x, pool_rows, choice, deg, t.rows,
                                  step)
        terms = fk.ell_sample_force_terms(model, x, pool_rows, choice, deg,
                                          t.rows, step)
    out["rep"] = (max_err(got, terms.sum(dim=1)), bound_ratio(got, terms))
    check(out["rep"][1] <= 1.0, f"{what} repulsion: bound ratio "
                                f"{out['rep'][1]:.3f}")
    say(f"{what}: " + ", ".join(f"{k} max_abs_err={e:.3e} bound_ratio="
                                f"{r:.4f}" for k, (e, r) in out.items()))
    return max(r for _, r in out.values()), max(e for e, _ in out.values())


def vertex_cfg():
    """The bench configuration as the vertex path runs it: f32 gathers."""
    return dataclasses.replace(BENCH_CONFIG, gather_dtype=None)


def vertex_single_card_phase(graph, dev, card, main_queued_ms):
    """F1: in a real NCCL group of one rank, ``VertexShardedForce2Vec`` at
    P = 1.  Each launch on its operands against its plain version (both
    sampling modes); one iteration against ``SyncForce2Vec``'s from the
    same X and negatives (every group sharing the pool); its queued ms
    beside main's; the metered phases; 50 trained iterations in each mode
    with exact launch counts and the quality margin.  Returns (X in
    original order, the pool, the sync and vertex iterations' results,
    the counts)."""
    cfg, ns = vertex_cfg(), BENCH_CONFIG.ns
    model = get_model(cfg.model)
    counts = {}
    with nccl_world_of_one(dev):
        sync = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
        v = VertexShardedForce2Vec(graph, cfg, min_width=MIN_WIDTH,
                                   hub_width=HUB_WIDTH, device=dev)
        lay, t = v.layout, v.tables
        say(f"vertex P=1: n_loc={lay.n_loc} H={lay.halo_width} "
            f"Hh={lay.hot_width} slabs "
            f"{[(b.width, b.count, b.phase) for b in lay.buckets]}")
        x_s = sync.init_embedding(seed=1)
        x_host = sync.unpad_embedding(x_s)  # [n, D] original order
        x_v = v.pad_embedding(x_host)
        rng = np.random.default_rng(7)
        pool = rng.integers(0, graph.n - 1, ns).astype(np.int32)
        pool_t = torch.as_tensor(pool, device=dev)
        rows = v.pool_rows(x_v, pool_t)
        tab = v._new_table(x_v)
        v._issue_exchange(x_v, tab)
        tab[: lay.n_loc].copy_(x_v)
        shard_kernel_phase(model, t, x_v, tab, rows, None, v.lr,
                           "vertex P=1 shared")
        big = rng.integers(0, graph.n - 1, 128).astype(np.int32)
        choice = torch.randint(0, 128, (lay.n_loc, ns), dtype=torch.int32,
                               device=dev)
        shard_kernel_phase(model, t, x_v, tab,
                           v.pool_rows(x_v, torch.as_tensor(big, device=dev)),
                           choice, v.lr, "vertex P=1 pool")

        ng = -(-sync.layout.n_pad // cfg.batch_size)
        want = sync.unpad_embedding(sync.run_iteration(
            x_s.clone(), np.broadcast_to(pool, (ng, ns)).copy()))
        got = v.unpad_embedding(v.run_iteration(x_v.clone(), pool))
        e = max_err(got, want)
        say(f"vertex P=1 iteration vs sync (same X, every group sharing the "
            f"pool): max |dX| {e:.3e} (needs < {ITER_TOL})")
        check(e < ITER_TOL, "vertex P=1 iteration differs from sync")
        xq = x_v.clone()
        # the iteration as training runs it (run_iteration also reads its
        # injected ids back to check them)
        q_ms = queued_device_ms(
            lambda: v._iteration(xq, pool_t, None, None, v.lr), reps=10)
        k_ms = cuda_ms(lambda: v._iteration(xq, pool_t, None, None, v.lr),
                       reps=10)
        say(f"vertex P=1 ms/iteration: queued {q_ms:.4f} (main path queued "
            f"{main_queued_ms:.4f}), back to back {k_ms:.4f} [{card}]")
        # the phases of the eager iteration, then of each graph replay
        # (the span's first iteration is the capture's eager warm-up)
        v.meter = Meter(dev)
        for _ in range(10):
            v.run_iteration(xq, pool)
        sec = v.meter.seconds
        say("vertex P=1 metered phases (run_iteration, eager), device ms "
            "per iteration: "
            + ", ".join(f"{k} {s * 100:.4f}" for k, s in sec.items())
            + f" [{card}]")
        v.meter = Meter(dev)  # drops the graph: the capture records phases
        v.run_span(xq, 1, 1)  # the capture, after its eager warm-up
        replays = v.span_graph.meter = Meter(dev)  # the replays' alone
        v.run_span(xq, 1, 10, 1)
        sec = replays.seconds
        say("vertex P=1 metered phases (run_span, 10 graph replays), "
            "device ms per iteration: "
            + ", ".join(f"{k} {s * 100:.4f}" for k, s in sec.items())
            + f" [{card}]")
        check(set(sec) == {"pool", "exchange", "free", "dep", "apply"}
              and all(s > 0 for s in sec.values()),
              f"vertex P=1: the graph's metered phases {sec}")
        v.meter = None

        edge_per = int(t.free is not None) + int(t.dep is not None)
        for sampling, gap in (("shared", JAX_VERTEX_GAP),
                              ("pool", JAX_VERTEX_POOL_GAP)):
            fv = VertexShardedForce2Vec(graph, cfg, min_width=MIN_WIDTH,
                                        hub_width=HUB_WIDTH,
                                        sampling=sampling, device=dev)
            expect = {"ell_edge_force": edge_per * TRAIN_ITERS,
                      "grouped_rep_force": TRAIN_ITERS * (sampling == "shared"),
                      "ell_sample_force": TRAIN_ITERS * (sampling == "pool")}
            emb, c = train_phase(fv, expect, card)
            add_counts(counts, c)
            distance_gap_check(graph, emb, 0.5 * gap, f"vertex P=1 {sampling} "
                               f"(JAX {gap:.4f})")
    return x_host, pool, want, got, counts


def halo_fault_ratio(model, t, x, tab, step, n_halo_from):
    """The dep table's launch against a faulty plain version whose halo
    slots read one row further on: above 1 if the bound catches it."""
    got = torch.zeros((t.out_rows, x.shape[1]), device=x.device)
    fk.ell_edge_force_table(model, x, tab, t.dep, t.inv_deg, step, out=got)
    worst = 0.0
    for nbr, deg, xi_row, ob in t.dep.parts():
        halo = (nbr >= n_halo_from) & fk._slot_mask(nbr, deg)[:, :, 0]
        if not bool(halo.any()):
            continue
        bad = torch.where(halo, (nbr + 1).clamp(max=tab.shape[0] - 1), nbr)
        terms = fk.ell_edge_force_terms(model, x, tab, bad, deg, xi_row,
                                        t.inv_deg, step)
        worst = max(worst, bound_ratio(got[ob: ob + nbr.shape[0]], terms))
    return worst


def vertex_shards_phase(graph, dev, card, x_host, pool, want):
    """F2: the four shards of a P = 4 layout on this one card.  Each
    shard's ``[x_loc | hot | halo]`` is assembled by indexing the global X
    with ``hot_send`` and ``send_idx`` (the rows the exchange delivers);
    each launch of its local update is held to its plain version; the four
    updates, unpermuted, equal the sync iteration (``want``); a dep slab's
    halo index moved by one row fails the bound."""
    cfg, P = vertex_cfg(), F_SHARDS
    model = get_model(cfg.model)
    step = cfg.resolve_lr(model)
    t0 = time.perf_counter()
    lay = VertexShardLayout.build(graph, P, min_width=MIN_WIDTH,
                                  hub_width=HUB_WIDTH)
    n_loc = lay.n_loc
    say(f"vertex P={P} layout: {time.perf_counter() - t0:.2f} s, n_loc "
        f"{n_loc}, H {lay.halo_width}, Hh {lay.hot_width}, deal "
        f"{lay.stats['deal']}, rows received per shard "
        f"{lay.stats['v2_recv_rows_per_shard']}")
    g = torch.as_tensor(lay.inv_perm, device=dev).long()  # orig id → row
    slot = (torch.as_tensor(lay.shard_of, device=dev).long()[g] * n_loc
            + torch.as_tensor(lay.lrow_of, device=dev).long()[g])
    xall = torch.zeros((P * n_loc, cfg.dim), device=dev)
    xall[slot] = x_host
    base = torch.arange(P, device=dev)[:, None] * n_loc
    hot = xall[(base + torch.as_tensor(lay.hot_send, device=dev)).reshape(-1)]
    pool_rows = x_host[torch.as_tensor(lay.perm[pool], device=dev).long()]
    new = torch.empty_like(xall)
    worst = fault = 0.0
    halo_from = n_loc + P * lay.hot_width
    for p in range(P):
        t = ShardTables.build(lay, p, dev)
        x = xall[p * n_loc: (p + 1) * n_loc]
        halo = xall[(base + torch.as_tensor(lay.send_idx[:, p],
                                            device=dev)).reshape(-1)]
        tab = torch.cat([x, hot, halo])
        ratio, _ = shard_kernel_phase(model, t, x, tab, pool_rows, None, step,
                                      f"vertex P={P} shard {p}")
        worst = max(worst, ratio)
        upd, rep = shard_free_part(model, t, x, pool_rows, step)
        new[p * n_loc: (p + 1) * n_loc] = x + shard_dep_part(
            model, t, x, tab, upd, rep, step)
        fault = max(fault, halo_fault_ratio(model, t, x, tab, step,
                                            halo_from))
    e = max_err(new[slot], want)
    say(f"vertex P={P} shards on one card: the four updates vs the sync "
        f"iteration max |dX| {e:.3e} (needs < {ITER_TOL}); planted fault "
        f"(halo index one row on) bound_ratio={fault:.2f} (must be > 1) "
        f"[{card}]")
    check(e < ITER_TOL, f"the P={P} shards' updates differ from sync")
    check(fault > 1.0, "the bound passed a dep slab reading the halo one "
                       "row off")
    return worst


def vertex_cli_phase(mtx, tmp, card):
    """F3: ``--schedule vertex --devices 1``, and with ``-bs 1`` (pool
    sampling), through the command line: the JAX CLI's output name and
    ``Results.txt`` row, exact launch counts, and ``train()`` replaying a
    CUDA graph (one capture a run, counted on ``IterationGraph``)."""
    total = {}
    capture = IterationGraph._capture
    captures = []

    def counted(graph, *args):
        captures.append(1)
        return capture(graph, *args)

    for extra, mode in (([], "shared"), (["-bs", "1"], "pool")):
        out = os.path.join(tmp, f"vertex_{mode}")
        expect = {"ell_edge_force": 2 * VERTEX_CLI_ITERS,
                  "grouped_rep_force": VERTEX_CLI_ITERS * (mode == "shared"),
                  "ell_sample_force": VERTEX_CLI_ITERS * (mode == "pool")}
        captures.clear()
        IterationGraph._capture = counted
        try:
            counts, _ = cli_run(["-input", mtx, "-output", out, "-option",
                                 "5", "-iter", str(VERTEX_CLI_ITERS),
                                 "--schedule", "vertex", "--devices", "1",
                                 *extra],
                                expect, f"--schedule vertex {mode}", card)
        finally:
            IterationGraph._capture = capture
        say(f"cli --schedule vertex {mode}: {len(captures)} CUDA graph "
            f"capture(s), the other iterations replays")
        check(len(captures) == 1, f"F3 {mode}: {len(captures)} captures")
        add_counts(total, counts)
        cli_outputs(out, f"bench.mtxF2VTDIST256D128IT{VERTEX_CLI_ITERS}NS5"
                    ".embd", ["tdist", "Init", f"Iteration:{VERTEX_CLI_ITERS}",
                              "Numofthreads:0", "BatchSize:256",
                              "Dimension:128"])
    return total


def _aligned(dev):
    """Every rank's device idle and the ranks met: timings start together."""
    torch.cuda.synchronize(dev)
    dist.barrier(device_ids=[dev.index])
    torch.cuda.synchronize(dev)


def f4_queued(fn, reps, dev):
    """``queued_device_ms(fn, reps)`` on every rank, or with 3 reps where
    any rank's host could not queue ``reps`` calls within the sleep (the
    ranks agree by an ``all_reduce``, so that each issues the same
    collectives); None where 3 did not fit either."""
    for k in (reps, 3):
        try:
            ms, ok = queued_device_ms(fn, k), 1
        except RuntimeError:
            torch.cuda.synchronize(dev)
            ms, ok = None, 0
        flag = torch.tensor([ok], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if int(flag) == 1:
            return ms
    return None


def f4_check(fv, dev) -> dict:
    """F4, one runner on one rank: from one X, ``run_span`` (the graph,
    captured once on a work buffer) against ``_run_span_eager`` straight,
    and in spans (against the eager loop in the same spans with
    ``halo_stale``), with each run's launch counts (the tp pair's
    ``all_reduce`` among them); then F4_REPEATS back-to-back
    and queued ms per iteration of each, in turns, and a profiled window
    of each (the host's launch calls per iteration, the idle share).  The
    eager batch schedule is not queued: its enqueue outlasts the sleep."""
    x0 = fv.init_embedding(seed=1)
    batch = isinstance(fv, Force2Vec)
    iters, spans = (3, (1, 1, 1)) if batch else (F4_ITERS, F4_SPANS)
    stale = getattr(fv, "halo_stale", False)
    work = x0.clone()

    def run(fn, ks):
        work.copy_(x0)
        reset_counts()
        done = 0
        for k in ks:
            fn(work, 1, k, done)
            done += k
        torch.cuda.synchronize(dev)
        return work.clone(), nonzero(read_counts())

    eager, c_eager = run(fv._run_span_eager, (iters,))
    graph, c_graph = run(fv.run_span, (iters,))
    in_spans, c_spans = run(fv.run_span, spans)
    want = run(fv._run_span_eager, spans)[0] if stale else eager
    g = fv.span_graph
    rec = dict(graph_vs_eager=max_err(graph, eager),
               spans_vs_eager=max_err(in_spans, want),
               moved=max_err(eager, x0),
               finite=bool(torch.isfinite(graph).all()),
               counts_eager=c_eager, counts_graph=c_graph,
               counts_spans=c_spans, per_replay=g.counts,
               captures=g.captures, capture_s=g.capture_seconds,
               pool_mb=g.pool_bytes / 2**20,
               b2b_ms={"graph": [], "eager": []},
               queued_ms={"graph": [], "eager": []})
    modes = {"graph": lambda k: fv.run_span(work, 1, k, 1),
             "eager": lambda k: fv._run_span_eager(work, 1, k, 1)}
    for mode in ("eager", "graph", "graph", "eager") * F4_REPEATS:
        if len(rec["b2b_ms"][mode]) == F4_REPEATS:
            continue
        _aligned(dev)
        rec["b2b_ms"][mode].append(
            cuda_ms(lambda: modes[mode](iters), reps=1, warmup=1) / iters)
        if batch and mode == "eager":
            continue
        _aligned(dev)
        rec["queued_ms"][mode].append(f4_queued(
            lambda: modes[mode](1), 2 if batch else 10, dev))
    for mode in ("graph", "eager"):
        _aligned(dev)
        prof = profile_window(lambda: modes[mode](iters), iters)[0]
        rec[f"host_launches_{mode}"] = prof["host_launches"]
        rec[f"idle_share_{mode}"] = prof["idle_share"]
    return rec


def f4_runners(graph, dev, world) -> dict:
    """F4's runners on this rank (``f4_check`` each): the vertex schedule at
    P = ranks (``shared``, ``pool``, rwalk through the ring and through the
    a2a fetch, ``halo_stale``), the sync schedule at dp = ranks and at
    tp = 2, and the batch schedule at dp = ranks, at the bench
    configurations (the vertex schedule's f32 gathers)."""
    vcfg = vertex_cfg()
    vkw = dict(min_width=MIN_WIDTH, hub_width=HUB_WIDTH, device=dev)
    rw = dataclasses.replace(vcfg, model="rwalk")
    makers = {
        "vertex shared": lambda: VertexShardedForce2Vec(graph, vcfg, **vkw),
        "vertex pool": lambda: VertexShardedForce2Vec(
            graph, vcfg, sampling="pool", **vkw),
        "vertex rwalk ring": lambda: VertexShardedForce2Vec(
            graph, rw, walk_fetch="ring", **vkw),
        "vertex rwalk a2a": lambda: VertexShardedForce2Vec(
            graph, rw, walk_fetch="a2a", **vkw),
        "vertex halo_stale": lambda: VertexShardedForce2Vec(
            graph, vcfg, halo_stale=True, **vkw),
        f"sync dp={world}": lambda: SyncForce2Vec(
            graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH,
            spmd=multihost.pod_mesh(1), device=dev),
        f"sync dp={world // 2} tp=2": lambda: SyncForce2Vec(
            graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH,
            spmd=multihost.pod_mesh(2), device=dev),
        f"batch dp={world}": lambda: Force2Vec(
            graph, L_BATCH_CONFIG, spmd=multihost.pod_mesh(1), device=dev),
    }
    out, rank = {}, dist.get_rank()
    for what, make in makers.items():
        t0 = time.perf_counter()
        fv = make()
        r = out[what] = f4_check(fv, dev)
        del fv
        torch.cuda.empty_cache()
        # each rank's line as it goes, so a later failure keeps these
        say(f"F4 {what} rank {rank} ({time.perf_counter() - t0:.1f} s): "
            f"graph vs eager {r['graph_vs_eager']}, spans "
            f"{r['spans_vs_eager']}; ms/iteration back to back graph "
            f"{r['b2b_ms']['graph']} eager {r['b2b_ms']['eager']}; queued "
            f"graph {r['queued_ms']['graph']} eager "
            f"{r['queued_ms']['eager']}; host launch calls/iteration graph "
            f"{r['host_launches_graph']:.1f} eager "
            f"{r['host_launches_eager']:.1f}; idle share graph "
            f"{r['idle_share_graph']} eager {r['idle_share_eager']}; "
            f"capture {r['capture_s']:.3f} s, pool {r['pool_mb']:.1f} MB "
            f"[{card_name_and_power()}]")
    return out


def _multi_rank(rank, world, x_host, pool, sync_x, negs):
    """F4, one rank: a vertex iteration (P = world) from F1's X and pool,
    and the sync iteration at (dp, tp) = (world, 1) and (world / 2, 2) from
    F5's X and negatives; times each; then every multi-rank runner's graph
    against its eager loop (``f4_runners``).  Every rank returns its
    runners' record, rank 0 the rest as well."""
    dev = torch.device("cuda", torch.cuda.current_device())
    graph = synth_powerlaw_graph()
    cfg = vertex_cfg()
    v = VertexShardedForce2Vec(graph, cfg, min_width=MIN_WIDTH,
                               hub_width=HUB_WIDTH, device=dev)
    x = v.pad_embedding(x_host)
    reset_counts()
    v.run_iteration(x, pool)
    torch.cuda.synchronize(dev)
    out = {"counts_v": read_counts(), "vertex": v.unpad_embedding(x)}
    pool_t = torch.as_tensor(pool, device=dev)
    out["ms_v"] = cuda_ms(lambda: v._iteration(x, pool_t, None, None, v.lr),
                          reps=10)
    out["comm"] = v.comm_stats()
    del v
    negs_t = torch.as_tensor(negs, device=dev)
    for tp in (1, 2):
        s = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH,
                          spmd=multihost.pod_mesh(tp), device=dev)
        xs = s.pad_embedding(sync_x)
        reset_counts()
        s.run_iteration(xs, negs_t)
        torch.cuda.synchronize(dev)
        # the launches and the pair scalars' all_reduces
        out[f"counts_tp{tp}"] = read_counts()
        out[f"sync_tp{tp}"] = s.unpad_embedding(xs)
        out[f"ms_tp{tp}"] = cuda_ms(lambda: s.run_iteration(xs, negs_t),
                                    reps=10)
        del s
    runners = f4_runners(graph, dev, world)
    if rank:
        return {"runners": runners, "done_at": time.time()}
    return {"runners": runners, "done_at": time.time(),
            **{k: (val.cpu().numpy() if isinstance(val, torch.Tensor)
                   else val) for k, val in out.items()}}


def f4_runner_report(world, per_rank, card, errs) -> None:
    """F4's runners: each rank's graph against its eager loop, bit for bit,
    with the same launch and collective counts and one capture (each rank
    printed its times as it went).  Failures go to ``errs``."""
    for what in per_rank[0]:
        recs = [r[what] for r in per_rank]
        r0 = recs[0]
        say(f"F4 {what} on {world} NCCL ranks: graph vs eager per rank "
            f"{[r['graph_vs_eager'] for r in recs]}, in spans "
            f"{[r['spans_vs_eager'] for r in recs]} (X moved up to "
            f"{max(r['moved'] for r in recs):.3e}); launches and "
            f"collectives per run eager {r0['counts_eager']}, graph "
            f"{r0['counts_graph']}; per replay {r0['per_replay']}; "
            f"captures {[r['captures'] for r in recs]}, capture s "
            f"{[round(r['capture_s'], 3) for r in recs]}, graph pool MB "
            f"{[round(r['pool_mb'], 1) for r in recs]} [{card}]")
        for k, r in enumerate(recs):
            bad = [name for name in ("graph_vs_eager", "spans_vs_eager")
                   if r[name] != 0.0]
            if bad or not r["finite"] or not r["moved"] > 0:
                errs.append(f"F4 {what} rank {k}: {bad or 'X'} "
                            f"{[r[b] for b in bad]}, not bit for bit")
            if not (r["counts_graph"] == r["counts_eager"]
                    == r["counts_spans"]):
                errs.append(f"F4 {what} rank {k}: counts eager "
                            f"{r['counts_eager']}, graph "
                            f"{r['counts_graph']}, spans "
                            f"{r['counts_spans']}")
            if r["captures"] != 1:
                errs.append(f"F4 {what} rank {k}: {r['captures']} captures")


def multi_rank_phase(dev, card, x_host, pool, got_p1, sync_ref, mtx, tmp):
    """F4: where the host has two or more cards, min(count, 4) NCCL ranks:
    one vertex iteration against F1's single-card result, and the sync
    iteration at dp = ranks and at tp = 2 (dp = ranks / 2) against F5's,
    with their launch counts, exchange bytes and ms/iteration; then every
    multi-rank runner's ``train()`` graph against its eager loop
    (``f4_runner_report``), and the seconds the ranks took to leave their
    groups after their last result; then ``--devices ranks`` through the
    command line (``f4_cli``)."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        say(f"F4 (multi-rank NCCL) needs two cards; this host has "
            f"{n_cards}: not run here (the CPU tests hold the ranks on gloo, "
            f"their graphs' code uncaptured against the eager loops, and F5 "
            f"the tp ranks on this card)")
        return {}
    world = min(n_cards, F_MAX_RANKS) // 2 * 2
    sync_x, negs, want = sync_ref
    t0 = time.perf_counter()
    results = multihost.spawn(_multi_rank, world, "nccl",
                              args=(x_host.cpu().numpy(), pool,
                                    sync_x.cpu().numpy(), negs),
                              timeout=300, wait=540)
    # spawn raises if a rank is still in its group EXIT_GRACE s after the
    # last result: the graphs that captured NCCL collectives went first
    say(f"F4: the {world} ranks left their NCCL groups "
        f"{time.time() - max(r['done_at'] for r in results):.2f} s after "
        f"the last returned its result (spawn allows "
        f"{multihost.EXIT_GRACE} s)")
    res = results[0]
    ev = float(np.abs(res["vertex"] - got_p1.cpu().numpy()).max())
    want = want.cpu().numpy()
    e1 = float(np.abs(res["sync_tp1"] - want).max())
    e2 = float(np.abs(res["sync_tp2"] - want).max())
    cs = res["comm"]
    say(f"F4 {world} NCCL ranks ({time.perf_counter() - t0:.1f} s): vertex "
        f"P={world} vs P=1 max |dX| {ev:.3e}; sync vs one card: dp={world} "
        f"{e1:.3e}, dp={world // 2} tp=2 {e2:.3e} (each needs < {ITER_TOL}); "
        f"launches vertex {res['counts_v']}, sync dp {res['counts_tp1']}, "
        f"sync tp {res['counts_tp2']}; ms/iteration vertex "
        f"{res['ms_v']:.4f}, sync dp {res['ms_tp1']:.4f}, sync tp=2 "
        f"{res['ms_tp2']:.4f}; exchange "
        f"{cs['bytes_per_iter_per_shard'] / 1e6:.2f} MB/iteration/rank "
        f"(cold {cs['cold_alltoall_rows_sent']} rows, hot "
        f"{cs['hot_allgather_rows_recv']} rows) [{card}]")
    check(max(ev, e1, e2) < ITER_TOL, "F4: multi-rank iterations differ "
                                      "from one card's")
    check(res["counts_v"]["ell_edge_force"] >= 1
          and res["counts_tp1"]["ell_edge_force"] == 1
          and res["counts_tp1"]["grouped_rep_force"] == 1,
          "F4: the ranks did not launch the fused kernels")
    check(res["counts_tp2"] == {**{k: 0 for k in res["counts_tp2"]},
                                **TP_ITERATION_COUNTS},
          f"F4: the tp ranks' launches {res['counts_tp2']}")
    counts = {}
    for k in ("counts_v", "counts_tp1", "counts_tp2"):
        add_counts(counts, res[k])
    errs = []
    f4_runner_report(world, [r["runners"] for r in results], card, errs)
    for e in errs:
        say(f"F4 FAILED: {e}")
    check(not errs, f"F4: {len(errs)} failures: {errs}")
    for r in res["runners"].values():
        for mode in ("counts_eager", "counts_graph", "counts_spans"):
            add_counts(counts, {k: v for k, v in r[mode].items()
                                if k in fk.launch_counts})
    f4_cli(world, mtx, tmp, card)
    return counts


def f4_cli(world, mtx, tmp, card) -> None:
    """``python -m force2vec_tpu_torch --devices world`` on NCCL, the
    batch (default) and vertex schedules: exit code 0, rank 0's output
    written, and the seconds from its last write (``Results.txt``) to the
    command's return, which spawn's ranks spend leaving their groups."""
    for extra, what in (([], "batch"), (["--schedule", "vertex"], "vertex")):
        out = os.path.join(tmp, f"devices_{what}")
        t0 = time.perf_counter()
        rc = cli.main(["-input", mtx, "-output", out, "-option", "5",
                       "-iter", str(VERTEX_CLI_ITERS), "--devices",
                       str(world), *extra])
        seconds = time.perf_counter() - t0
        check(rc == 0, f"F4 cli --devices {world} {what}: exit code {rc}")
        embd = [f for f in os.listdir(out) if f.endswith(".embd")]
        check(len(embd) == 1, f"F4 cli --devices {world} {what}: {embd}")
        left = time.time() - os.path.getmtime(
            os.path.join(out, "Results.txt"))
        say(f"F4 cli --devices {world} --schedule {what} "
            f"({VERTEX_CLI_ITERS} iterations): exit 0 in {seconds:.1f} s, "
            f"the ranks gone {left:.2f} s after rank 0's last write "
            f"[{card}]")


# -- F5: the dp × tp sync runner on one card --------------------------------


def tp_partial_ratio(model, x, xg, table, got, rtol=SUM_RTOL, skip=None):
    """``tp_pair_partial``'s ``got`` against its plain version: (max
    |err|, the max over slots of |got - plain| / (rtol · Σ_d |term|),
    0 where they agree).  With ``skip`` a column, the plain version with
    that column's terms left out (a planted fault the bound must reject),
    the scale still the true terms'."""
    err = ratio = 0.0
    for rb, nb, _, rows, width in table.entries.tolist():
        if rows * width == 0:
            continue
        nbr = table.nbr[nb: nb + rows * width].view(rows, width)
        xi = x[table.xi_row[rb: rb + rows].long()][:, None, :]
        xj = xg[nbr.long()].float()
        v = xi * xj if model.a_kind == "dot" else (xi - xj) ** 2
        scale = rtol * v.abs().sum(dim=-1)
        if skip is not None:
            v[..., skip] = 0.0
        real = fk._slot_mask(nbr, table.deg[rb: rb + rows])[:, :, 0]
        want = torch.where(real, v.sum(dim=-1), 0.0)
        e = (got[nb: nb + rows * width].view(rows, width) - want).abs()
        err = max(err, float(e.max()))
        ratio = max(ratio, float(torch.where(e == 0, 0.0, e / scale).max()))
    return err, ratio


def tp_force_ratio(model, kind, x, xg, table, a, invd, step, got):
    """``tp_pair_force``'s ``got`` against the plain terms from the same
    reduced scalars ``a``: (max |err|, bound ratio)."""
    err = ratio = 0.0
    for (rb, nb, ob, rows, width), (nbr, deg, xi_row, _) in zip(
            table.entries.tolist(), table.parts()):
        av = a[nb: nb + rows * width].view(rows, width, 1)

        def rsum(_v, av=av):
            return av

        terms = (fk.ell_edge_force_terms(model, x, xg, nbr, deg, xi_row,
                                         invd, step, rsum) if kind == "edge"
                 else fk.ell_sample_force_terms(model, x, xg, nbr, deg,
                                                xi_row, step, rsum))
        part = got[ob: ob + rows]
        err = max(err, max_err(part, terms.sum(dim=1)))
        ratio = max(ratio, bound_ratio(part, terms))
    return err, ratio


def tp_tables(fv, negs):
    """A tp iteration's work tables, as ``SyncForce2Vec._tp_tables`` lays
    them end to end, from a runner of one rank: (the concatenated table,
    [(kind, view, first slot)] for the attraction (``edge_table``) and the
    repulsion (each row with its group's ids))."""
    cat, views = fk.concat_work_tables([fv.edge_table, fk.EdgeWorkTable.single(
        negs[fv._gid], fv._ns_deg, fv._all_rows, fv.layout.n_pad)])
    first = views[0].nbr.shape[0]
    return cat, [("edge", views[0], 0), ("sample", views[1], first)]


def tp_checks(model, x, xg, cat, halves, invd, step, reduce=None):
    """The tp iteration's launches on its tables, each against its plain
    version: one ``tp_pair_partial`` over ``cat``, the scalars reduced
    (``reduce``, an ``all_reduce`` over tp, in place), then
    ``tp_pair_force`` for each half on its slice.  {kernel: (max |err|,
    bound ratio)}, the worst over the launches."""
    part = fk.tp_pair_partial(model, x, xg, cat)
    res = {"tp_pair_partial": tp_partial_ratio(model, x, xg, cat, part)}
    if reduce is not None:
        reduce(part)
    errs = []
    for kind, t, s in halves:
        a = part[s: s + t.nbr.shape[0]]
        got = fk.tp_pair_force(model, kind, x, xg, t, a, invd, step)
        errs.append(tp_force_ratio(model, kind, x, xg, t, a, invd, step, got))
    res["tp_pair_force"] = tuple(max(e[i] for e in errs) for i in (0, 1))
    return res


def _tp_rank(rank, world, x_host, negs):
    """F5, one of ``world`` gloo ranks on this one card, tp = world: one
    sync iteration through the split-dim kernels with its launch and
    all_reduce counts, then the iteration's launches on its operands (the
    runner's own tables, holding that iteration's ids) against their
    plain versions.  Rank 0 returns the results."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fv = SyncForce2Vec(synth_powerlaw_graph(), BENCH_CONFIG, MIN_WIDTH,
                       HUB_WIDTH, spmd=multihost.pod_mesh(world), device=dev)
    x = fv.pad_embedding(x_host)
    x0, negs = x.clone(), torch.as_tensor(negs, device=dev)
    reset_counts()
    fv.run_iteration(x, negs)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    got = fv.unpad_embedding(x)
    first = fv._tp_att.nbr.shape[0]
    checks = tp_checks(
        fv.model, x0, x0.to(torch.bfloat16), fv._tp_cat,
        [("edge", fv._tp_att, 0), ("sample", fv._tp_rep, first)],
        fv.inv_deg, fv.lr,
        reduce=lambda part: dist.all_reduce(part, group=fv.spmd.tp))
    if rank:
        return None
    return dict(got=got.cpu().numpy(), counts=counts, checks=checks)


def tp_partial_work(model, x, xg, table):
    """(call, plain call, bytes, operations) of ``tp_pair_partial`` over
    ``table`` on this rank's columns of ``x``: the x and gather rows it
    reads, the real slots' ids, deg and xi_row, every slot's scalar
    written; and its f32 operations."""
    launches = [(nbr, deg, xi) for nbr, deg, xi, _ in table.parts()]
    nbytes, real = ell_work(launches, x, xg, False)
    out_bytes = (sum(r.numel() for _, _, r in launches) * x.shape[1]
                 * x.element_size())
    scalar = (2 if model.a_kind == "dot" else 3) * x.shape[1]
    return (lambda: fk.tp_pair_partial(model, x, xg, table),
            lambda: fk.tp_pair_partial_plain(model, x, xg, table),
            nbytes - out_bytes + table.nbr.numel() * 4, real * scalar)


def tp_force_work(model, kind, x, xg, table, a, invd, step):
    """(call, plain call, bytes, operations) of ``tp_pair_force`` over
    ``table``: the rows, ids and output an ``ell_*_force`` over it moves,
    the real slots' scalars read; and its f32 operations without the
    scalars'."""
    d = x.shape[1]
    launches = [(nbr, deg, xi) for nbr, deg, xi, _ in table.parts()]
    with_invd = kind == "edge" and model.a_kind == "dot"
    nbytes, real = ell_work(launches, x, xg, with_invd)
    scalar = (2 if model.a_kind == "dot" else 3) * d
    return (lambda: fk.tp_pair_force(model, kind, x, xg, table, a, invd,
                                     step),
            lambda: fk.tp_pair_force_plain(model, kind, x, xg, table, a,
                                           invd, step),
            nbytes + real * 4, real * (term_flops(model, kind, d) - scalar))


def tp_timing(one, x, negs, card, errs):
    """The two split-dim kernels timed on this card at the shapes a tp = 2
    rank gives them on the main path (its half of the columns, bf16
    gathers, or X itself for a bf16 or f16 X), back to back and queued
    ahead of the device, beside their plain versions and their bounds:
    ``tp_pair_partial`` over the attraction's work table, over the
    repulsion's and over the two laid end to end (the launch an iteration
    makes), ``tp_pair_force`` over each; then the three launches of an
    iteration summed.  Returns the kernels' ``kernels`` line records (the
    attraction's launches)."""
    model, step = one.model, one.lr

    def gathers(t):  # the bench's bf16 replica of an f32 X, else X itself
        return t if t.dtype != torch.float32 else t.to(torch.bfloat16)

    d = x.shape[1] // F_TP
    half = x[:, :d].contiguous()
    xg = gathers(half)
    cat, halves = tp_tables(one, negs)
    cols = [x[:, c: c + d].contiguous() for c in range(0, x.shape[1], d)]
    a = sum(fk.tp_pair_partial(model, h, gathers(h), cat) for h in cols)
    work = [("tp_pair_partial", "both", tp_partial_work(model, half, xg,
                                                        cat))]
    for kind, t, s in halves:
        work.append(("tp_pair_partial", kind,
                     tp_partial_work(model, half, xg, t)))
        work.append(("tp_pair_force", kind, tp_force_work(
            model, kind, half, xg, t, a[s: s + t.nbr.shape[0]],
            one.inv_deg, step)))
    rec, lines, per_iter = {}, [], [0.0, 0.0]
    for name, kind, (kern, plain, b, ops) in work:
        k_ms = cuda_ms(kern, reps=20)
        q_ms = queued_device_ms(kern, reps=20)
        p_ms = cuda_ms(plain, reps=3)
        b_ms, by = bound_ms(b, ops)
        lines.append(f"{name} ({kind}, d={d}): {k_ms:.4f} ms (queued "
                     f"{q_ms:.4f}), plain {p_ms:.4f}, bound {b_ms:.4f} "
                     f"({by})")
        if name == "tp_pair_force" or kind == "both":
            per_iter = [per_iter[0] + k_ms, per_iter[1] + q_ms]
        if kind == "edge":  # the record: the attraction's launch
            rec[name] = {"max_abs_err": errs[name], "ms": k_ms,
                         "queued_ms": q_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": by}
    say("split-dim kernels at tp=2, one card: " + "; ".join(lines)
        + f"; an iteration's launches (partial over both tables, the two "
          f"forces): {per_iter[0]:.4f} ms back to back, {per_iter[1]:.4f} "
          f"queued [{card}]")
    for r in rec.values():
        r["iteration_ms"], r["iteration_queued_ms"] = per_iter
    return rec


def sharded_sync_phase(graph, dev, card):
    """F5: the sync runner's dp slices and tp ranks on this one card, at
    the main path's configuration, from one X and random per-group
    negatives, against the single-card iteration:

    * dp: the F_DP ranks' runners built with ``SpmdAxes(n_dp=F_DP,
      dp_index=k)`` and no group; each rank's edge launch (its bucket
      slices) and repulsion launch (its rows, from the group boundary
      before them), counted; each held to its plain version; the slices
      concatenated in rank order (as ``all_gather_into_tensor`` would),
      put in place by the runner's permutation, against the single-card
      update;
    * tp: F_TP gloo ranks sharing this card (gloo reduces CUDA tensors
      through the host), one iteration each through the split-dim
      kernels, counted, each launch against its plain version, the
      gathered X against the single-card one.

    Returns (dp counts, tp counts, the split-dim kernels' records, (X, the
    negatives, the single-card result) for F4)."""
    cfg = BENCH_CONFIG
    one = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
    model, step, group = one.model, one.lr, cfg.batch_size
    x = one.init_embedding(seed=2)
    x_host = one.unpad_embedding(x)
    negs = np.random.default_rng(11).integers(
        0, graph.n - 1, one._neg_shape).astype(np.int32)
    negs_t = torch.as_tensor(negs, device=dev)
    want = one.unpad_embedding(one.run_iteration(x.clone(), negs_t))
    xg = x.to(torch.bfloat16)

    t0 = time.perf_counter()
    ranks = [SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH,
                           spmd=SpmdAxes(n_dp=F_DP, dp_index=k), device=dev)
             for k in range(F_DP)]
    check(all(r.layout.n_pad == one.layout.n_pad for r in ranks),
          "the dp runners' layout differs from the single card's")
    build_s = time.perf_counter() - t0
    reset_counts()
    outs = [r._edge_table_launch(x, xg, step, False) for r in ranks]
    reps = [r._rank_repulsion(x, xg, negs_t, step, False) for r in ranks]
    torch.cuda.synchronize(dev)
    dp_counts = read_counts()
    check(dp_counts == {**{k: 0 for k in dp_counts}, "ell_edge_force": F_DP,
                        "grouped_rep_force": F_DP},
          f"dp slices' launches {dp_counts}")
    err = ratio = 0.0
    for r, out, rep in zip(ranks, outs, reps):
        for nbr, deg, xi_row, ob in r.edge_table.parts():
            terms = fk.ell_edge_force_terms(model, x, xg, nbr, deg, xi_row,
                                            r.inv_deg, step)
            part = out[ob: ob + nbr.shape[0]]
            err = max(err, max_err(part, terms.sum(dim=1)))
            ratio = max(ratio, bound_ratio(part, terms))
        r0, r1 = r._dp_rows()
        a0 = r0 // group * group
        sg = xg[negs_t[a0 // group: -(-r1 // group)].long()]
        terms = fk.grouped_rep_force_terms(model, group, x[a0:r1], sg,
                                           step)[r0 - a0:]
        err = max(err, max_err(rep, terms.sum(dim=1)))
        ratio = max(ratio, bound_ratio(rep, terms))
    g = torch.cat(outs + [torch.zeros_like(outs[0][:1])])
    new = x + ranks[0]._dp_place(g).add_(torch.cat(reps))
    e_dp = max_err(one.unpad_embedding(new), want)
    say(f"F5 dp={F_DP} slices on one card (runners built in {build_s:.1f} "
        f"s): launches {dp_counts}; each launch vs plain max_abs_err="
        f"{err:.3e} bound_ratio={ratio:.4f}; the slices put in place vs the "
        f"single-card iteration max |dX| {e_dp:.3e} [{card}]")
    check(ratio <= 1.0, f"a dp slice's launch exceeds its bound by "
                        f"{ratio:.3f}x")
    check(e_dp < ITER_TOL, "the dp slices' update differs from one card's")

    t0 = time.perf_counter()
    res = multihost.spawn(_tp_rank, F_TP, "gloo",
                          args=(x_host.cpu().numpy(), negs), timeout=300)[0]
    e_tp = float(np.abs(res["got"] - want.cpu().numpy()).max())
    tp_counts, checks = res["counts"], res["checks"]
    say(f"F5 tp={F_TP}, {F_TP} gloo ranks on this card "
        f"({time.perf_counter() - t0:.1f} s): rank 0 launches {tp_counts}; "
        + "; ".join(f"{k} max_abs_err={c[0]:.3e} bound_ratio={c[1]:.4f}"
                    for k, c in checks.items())
        + f"; the iteration vs one card max |dX| {e_tp:.3e} [{card}]")
    check(tp_counts == {**{k: 0 for k in tp_counts}, **TP_ITERATION_COUNTS},
          f"the tp ranks' launches {tp_counts}")
    check(all(c[1] <= 1.0 for c in checks.values()),
          "a split-dim launch exceeds its bound")
    check(e_tp < ITER_TOL, "the tp iteration differs from one card's")
    rec = tp_timing(one, x, negs_t, card,
                    {k: c[0] for k, c in checks.items()})
    return dp_counts, tp_counts, rec, (x_host, negs, want)


def vertex_path(graph, dev, card, mtx, tmp, main_queued_ms):
    """Path F: F1-F3, F5 (one card), then F4 (several).  Returns the
    launch counts of F1-F4 and of F5's dp and tp drives, and F5's records
    of the split-dim kernels."""
    counts = {}
    t0 = time.perf_counter()
    x_host, pool, want, got_p1, c = vertex_single_card_phase(
        graph, dev, card, main_queued_ms)
    add_counts(counts, c)
    say(f"path F1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vertex_shards_phase(graph, dev, card, x_host, pool, want)
    say(f"path F2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(counts, vertex_cli_phase(mtx, tmp, card))
    say(f"path F3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dp_counts, tp_counts, tp_rec, sync_ref = sharded_sync_phase(graph, dev,
                                                                card)
    say(f"path F5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(counts, multi_rank_phase(dev, card, x_host, pool, got_p1,
                                        sync_ref, mtx, tmp))
    say(f"path F4: {time.perf_counter() - t0:.1f} s")
    return counts, dp_counts, tp_counts, tp_rec


# -- path G: every width ------------------------------------------------------


def width_rtol(dim: int) -> float:
    """The elementwise bound at rows of ``dim`` columns: SUM_RTOL up to
    dim 128, and above it scaled with the dim, since each pair's scalar is
    a sum over the dim whose reordering moves it by up to ~dim·2^-24 of
    its size (1024·2^-24 = 6.1e-5 against 1e-5 · 1024/128 = 8e-5)."""
    return SUM_RTOL * max(1.0, dim / 128)


def width_ratio(got, terms_of, model, dim, interval=True) -> float:
    """``got`` against ``terms_of(model)`` at width ``dim``: ``held_ratio``
    with ``width_rtol``, every dot model (the sigmoid family, exact or
    table σ) held to the interval of its terms with each pair's a moved by
    TABLE_A_SHIFT scaled as ``width_rtol`` is: where σ(a) is near 1, exact
    σ's 1 - σ cancels, and a dot product summed in another order moves it
    by more than the elementwise bound.  ``interval=False``: the bound
    alone (the scalars are given)."""
    if not interval:
        return bound_ratio(got, terms_of(model), width_rtol(dim))
    return held_ratio(got, terms_of, model, width_rtol(dim),
                      TABLE_A_SHIFT * max(1.0, dim / 128), dot=True)


def padded_x(n_pad, dim, seed, dev):
    """``[n_pad, padded_dim(dim)]``: the symmetric init's draw of ``[n_pad,
    dim]`` from ``seed``, then 0 columns, as the trainers hold X."""
    x = torch.rand((n_pad, dim), device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    return F.pad(x.mul_(2.0).sub_(1.0), (0, fk.padded_dim(dim) - dim))


@dataclasses.dataclass
class Part:
    """Rows of one launch's output and their plain terms: ``terms(model,
    r0, r1)`` gives rows [r0, r1)'s ``[r1 - r0, K, D]``; chunks of rows
    start at multiples of ``align`` (a repulsion's group)."""

    out: torch.Tensor
    per_row: int  # elements of a row's terms
    terms: object
    align: int = 1


def g_ratio(model, dim, parts, fault=False, interval=True):
    """(max |err|, worst ratio) over ``parts``, in chunks of at most
    G_TERMS term elements: ``width_ratio``, or with ``fault`` the excess
    over the plain terms with the last real column skipped, in units of
    the bound (``width_rtol`` of the true terms' Σ|terms|, so that the
    ratio stays finite where the skipped column's terms are 0)."""
    err = ratio = 0.0
    for p in parts:
        rows = p.out.shape[0]
        step = max(p.align, G_TERMS // max(p.per_row, 1) // p.align * p.align)
        for r0 in range(0, rows, step):
            r1 = min(rows, r0 + step)
            got = p.out[r0:r1]
            if fault:
                t = p.terms(model, r0, r1)
                scale = width_rtol(dim) * t.abs().sum(dim=1) + half_ulp(got)
                t[..., dim - 1] = 0.0
                e = (got - t.sum(dim=1)).abs()
                ratio = max(ratio, float(torch.where(e == 0, 0.0,
                                                     e / scale).max()))
                continue
            err = max(err, max_err(got, p.terms(model, r0, r1).sum(dim=1)))
            ratio = max(ratio, width_ratio(
                got, lambda m, r0=r0, r1=r1, p=p: p.terms(m, r0, r1), model,
                dim, interval))
    return err, ratio


def edge_parts(table, x, xg, invd, step, got):
    parts = []
    for nbr, deg, xi_row, ob in table.parts():
        def terms(m, r0, r1, nbr=nbr, deg=deg, xi_row=xi_row):
            return fk.ell_edge_force_terms(m, x, xg, nbr[r0:r1], deg[r0:r1],
                                           xi_row[r0:r1], invd, step)
        parts.append(Part(got[ob: ob + nbr.shape[0]],
                          max(nbr.shape[1], 1) * x.shape[1], terms))
    return parts


def sample_parts(x, xg, idx, deg, rows, step, got):
    def terms(m, r0, r1):
        return fk.ell_sample_force_terms(m, x, xg, idx[r0:r1], deg[r0:r1],
                                         rows[r0:r1], step)
    return [Part(got, idx.shape[1] * x.shape[1], terms)]


def rep_parts(group, xi, sg, step, got):
    def terms(m, r0, r1):  # r0 a multiple of group
        return fk.grouped_rep_force_terms(m, group, xi[r0:r1],
                                          sg[r0 // group:], step)
    return [Part(got, sg.shape[1] * xi.shape[1], terms, align=group)]


def tp_parts(model, kind, x, xg, table, a, invd, step, got):
    """A ``tp_pair_force`` launch's plain terms, from the same scalars."""
    parts = []
    for (rb, nb, ob, rows, width), (nbr, deg, xi_row, _) in zip(
            table.entries.tolist(), table.parts()):
        av = a[nb: nb + rows * width].view(rows, width, 1)

        def terms(m, r0, r1, nbr=nbr, deg=deg, xi_row=xi_row, av=av):
            def rsum(_v):
                return av[r0:r1]
            sl = (nbr[r0:r1], deg[r0:r1], xi_row[r0:r1])
            if kind == "edge":
                return fk.ell_edge_force_terms(m, x, xg, *sl, invd, step,
                                               rsum)
            return fk.ell_sample_force_terms(m, x, xg, *sl, step, rsum)
        parts.append(Part(got[ob: ob + rows], max(width, 1) * x.shape[1],
                          terms))
    return parts


def row_class(dim: int, dtype) -> str:
    """csrc/common.cuh::with_row_class's class of a row of ``dim``
    (padded) elements of ``dtype``: "lanes x pieces a lane", and "full"
    where the row fills it (D fixed at compile time)."""
    pieces = fk.padded_dim(dim) * (4 if dtype == torch.float32 else 2) // 16
    lanes, per = ((1 << (pieces - 1).bit_length(), 1) if pieces <= 32
                  else (32, -(-pieces // 32)))
    return f"{lanes}x{per}" + (" full" if pieces == lanes * per else "")


def width_kernels(fv, dim, dtype, dev, faults, x_dtype=torch.float32):
    """G1 at one width and gather dtype: each kernel and the tp pair
    against its plain version, on X at ``padded_dim(dim)`` columns in
    ``x_dtype`` (a bf16 or f16 X its own gather table, ``dtype``).  tdist
    at the bench shapes: the edge kernel over the layout's work table, the
    repulsion over every row's 256-row group, ``ell_sample_force`` over
    ``[n_pad, ns]`` samples (and adding into an update, bit for bit
    ``out.add_``), the split-dim pair over the edge table; every other
    model on the widest bucket and its rows.  Each launch's padding
    columns must stay 0; with ``faults`` each kernel's tdist launch is held
    to its plain terms with the last real column skipped, which must fail.
    Returns ({kernel: [worst ratio, max |err|]}, {kernel: fault ratio})."""
    n_pad, ns, step = fv.layout.n_pad, BENCH_CONFIG.ns, 0.02
    group = BENCH_CONFIG.batch_size
    x = padded_x(n_pad, dim, seed=dim, dev=dev).to(x_dtype)
    xg = x.to(dtype)
    table, invd = fv.edge_table, fv.inv_deg.to(x_dtype)
    sg = bench_samples(fv, xg, seed=5)
    idx = torch.randint(0, fv.layout.n - 1, (n_pad, ns), dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(11),
                        device=dev)
    deg = torch.full((n_pad,), ns, dtype=torch.int32, device=dev)
    rows = torch.arange(n_pad, dtype=torch.int32, device=dev)
    res = {k: [0.0, 0.0] for k in ("ell_edge_force", "grouped_rep_force",
                                   "ell_sample_force", "tp_pair_partial",
                                   "tp_pair_force")}
    fault = {}

    def note(kernel, got, model, parts):
        what = (f"{kernel} {model.name} dim {dim} {str(dtype)[6:]} X "
                f"{str(x_dtype)[6:]}")
        check(not bool(got[:, dim:].any()),
              f"path G {what}: a padding column of the output is not 0")
        interval = kernel != "tp_pair_force"  # its scalars are given
        e, r = g_ratio(model, dim, parts, interval=interval)
        check(r <= 1.0, f"path G {what}: |err| exceeds the bound by "
                        f"{r:.3f}x")
        res[kernel] = [max(res[kernel][0], r), max(res[kernel][1], e)]
        # the split-dim pair's fault at every row class, the others' at
        # G_FAULT_DIM
        if (faults or kernel.startswith("tp_")) and model.name == "tdist":
            f = g_ratio(model, dim, parts, fault=True)[1]
            check(f > 1.0, f"path G {what}: the bound passed the last real "
                           f"column skipped ({f:.3f})")
            fault[kernel] = f

    def tp_pair(model, kind, tab):
        part = fk.tp_pair_partial(model, x, xg, tab)
        e, r = tp_partial_ratio(model, x, xg, tab, part, width_rtol(dim))
        check(r <= 1.0, f"path G tp_pair_partial {model.name} dim {dim}: "
                        f"bound ratio {r:.3f}")
        res["tp_pair_partial"] = [max(res["tp_pair_partial"][0], r),
                                  max(res["tp_pair_partial"][1], e)]
        if model.name == "tdist":
            f = tp_partial_ratio(model, x, xg, tab, part, width_rtol(dim),
                                 skip=dim - 1)[1]
            check(f > 1.0, f"path G tp_pair_partial dim {dim}: the bound "
                           f"passed the last real column skipped ({f:.3f})")
            fault["tp_pair_partial"] = f
        got = fk.tp_pair_force(model, kind, x, xg, tab, part, invd, step)
        note("tp_pair_force", got, model,
             tp_parts(model, kind, x, xg, tab, part, invd, step, got))

    tdist = get_model("tdist")
    got = fk.ell_edge_force_table(tdist, x, xg, table, invd, step)
    note("ell_edge_force", got, tdist, edge_parts(table, x, xg, invd, step,
                                                  got))
    got = fk.grouped_rep_force(tdist, group, x, sg, step)
    note("grouped_rep_force", got, tdist, rep_parts(group, x, sg, step, got))
    got = fk.ell_sample_force(tdist, x, xg, idx, deg, rows, step)
    note("ell_sample_force", got, tdist,
         sample_parts(x, xg, idx, deg, rows, step, got))
    base = padded_x(n_pad, dim, seed=19, dev=dev).to(x_dtype)
    check(torch.equal(fk.ell_sample_force(tdist, x, xg, idx, deg, rows, step,
                                          out=base.clone(), accumulate=True),
                      base.add_(got)),
          f"path G ell_sample_force dim {dim}: accumulate=True differs from "
          "out.add_")
    tp_pair(tdist, "edge", table)

    # every other model on the widest bucket and its rows (the repulsion
    # from the group boundary at or before the bucket's first row)
    b = widest_bucket(fv)
    c = b.nbr.shape[0]
    br = b.xi_row.long()
    a0 = b.start // group * group
    one = fk.EdgeWorkTable.single(b.nbr, b.deg, b.xi_row, n_pad)
    per_row = fk.EdgeWorkTable.single(idx[br].contiguous(), deg[br],
                                      b.xi_row, n_pad)
    for name in EDGE_MODELS[1:]:
        m = model_by(name)
        got = fk.ell_edge_force(m, x, xg, b.nbr, b.deg, b.xi_row, invd, step)
        note("ell_edge_force", got, m, edge_parts(one, x, xg, invd, step,
                                                  got))
        if name != "sigmoid_table":
            tp_pair(m, "edge", one)
    for name in SAMPLE_MODELS[1:]:
        m = model_by(name)
        got = fk.ell_sample_force(m, x, xg, per_row.nbr.view(c, ns), deg[br],
                                  b.xi_row, step)
        note("ell_sample_force", got, m, sample_parts(
            x, xg, per_row.nbr.view(c, ns), deg[br], b.xi_row, step, got))
        xr = x[a0: b.start + c]
        got = fk.grouped_rep_force(m, group, xr, sg[a0 // group:], step)
        note("grouped_rep_force", got, m,
             rep_parts(group, xr, sg[a0 // group:], step, got))
        tp_pair(m, "sample", per_row)
    # more samples than a launch's shared memory holds at this width: a
    # launch a chunk, the later ones adding into the rows
    per = fk._MAX_SAMPLE_BYTES // (fk.padded_dim(dim) * 4)
    if G_MANY_SAMPLES > per:
        many = xg[torch.randint(0, fv.layout.n - 1,
                                (sg.shape[0], G_MANY_SAMPLES), device=dev,
                                generator=torch.Generator(dev).manual_seed(23))]
        xr = x[a0: b.start + c]
        before = fk.launch_counts["grouped_rep_force"]
        got = fk.grouped_rep_force(tdist, group, xr, many[a0 // group:], step)
        launches = fk.launch_counts["grouped_rep_force"] - before
        check(dev.type == "cpu" or launches == -(-G_MANY_SAMPLES // per),
              f"path G grouped_rep_force dim {dim}: {launches} launches for "
              f"{G_MANY_SAMPLES} samples of {per} a launch")
        note("grouped_rep_force", got, tdist,
             rep_parts(group, xr, many[a0 // group:], step, got))
    torch.cuda.synchronize(dev)
    return res, fault


def width_refusals(fv, dev, card):
    """G1's refusals: on the card every kernel, the split-dim pair as the
    fused ones, takes rows of a multiple of ROW_ALIGN elements at 16-byte
    aligned bases (the trainers hold X so); each wrapper must refuse x of
    12 columns and x whose base is one f32 off that alignment with a
    ValueError, launching nothing."""
    n_pad, step, model = fv.layout.n_pad, 0.02, get_model("tdist")
    b = widest_bucket(fv)
    one = fk.EdgeWorkTable.single(b.nbr, b.deg, b.xi_row, n_pad)
    a = torch.zeros(one.nbr.shape[0], device=dev)
    group, rows = BENCH_CONFIG.batch_size, b.nbr.shape[0]

    def calls(x):
        xg = x.to(torch.bfloat16)
        sg = xg[b.nbr[: -(-rows // group), :BENCH_CONFIG.ns].long()]
        return {
            "ell_edge_force": lambda: fk.ell_edge_force(
                model, x, xg, b.nbr, b.deg, b.xi_row, fv.inv_deg, step),
            "grouped_rep_force": lambda: fk.grouped_rep_force(
                model, group, x[:rows], sg, step),
            "ell_sample_force": lambda: fk.ell_sample_force(
                model, x, xg, b.nbr, b.deg, b.xi_row, step),
            "tp_pair_partial": lambda: fk.tp_pair_partial(model, x, xg, one),
            "tp_pair_force": lambda: fk.tp_pair_force(
                model, "edge", x, xg, one, a, fv.inv_deg, step)}

    before = dict(fk.launch_counts)
    cases = (("12 columns", padded_x(n_pad, 12, 3, dev)[:, :12].contiguous()),
             ("a base 4 bytes off alignment",
              torch.zeros(n_pad * 16 + 1, device=dev)[1:].view(n_pad, 16)))
    for what, x in cases:
        for name, call in calls(x).items():
            try:
                call()
            except ValueError:
                continue
            check(False, f"path G1: {name} took x of {what} on the card")
    check(fk.launch_counts == before, "path G1: a refused call launched")
    say(f"path G1 refusals: each of {list(calls(cases[0][1]))} refuses x of "
        f"{' and of '.join(w for w, _ in cases)} (ValueError, no launch) "
        f"[{card}]")


def width_times(fv, dim, dtype, dev, x_dtype=torch.float32) -> dict:
    """G4 at one width and gather dtype, tdist at the bench shapes: the
    three kernels as ``time_kernels`` times them and the split-dim pair
    over the edge table, each queued ahead of the device beside its bound
    and its plain version, X in ``x_dtype`` (a bf16 or f16 X its own
    gather table).  {kernel: (ms, bound_ms, plain_ms, bound_by)}."""
    n_pad, ns = fv.layout.n_pad, BENCH_CONFIG.ns
    x = padded_x(n_pad, dim, seed=dim, dev=dev).to(x_dtype)
    xg = x.to(dtype)
    sg = bench_samples(fv, xg, seed=5)
    idx = torch.randint(0, fv.layout.n - 1, (n_pad, ns), dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(11),
                        device=dev)
    deg = torch.full((n_pad,), ns, dtype=torch.int32, device=dev)
    rows = torch.arange(n_pad, dtype=torch.int32, device=dev)
    model = get_model("tdist")
    out = time_kernels(model, fv, x, xg, sg, idx, deg, rows, 0.02)
    a = fk.tp_pair_partial(model, x, xg, fv.edge_table)
    for name, (kern, plain, nbytes, ops) in (
            ("tp_pair_partial", tp_partial_work(model, x, xg,
                                                fv.edge_table)),
            ("tp_pair_force", tp_force_work(model, "edge", x, xg,
                                            fv.edge_table, a,
                                            fv.inv_deg.to(x.dtype), 0.02))):
        b_ms, by = bound_ms(nbytes, ops)
        out[name] = (queued_device_ms(kern, reps=10), b_ms,
                     cuda_ms(plain, reps=2, warmup=1), by)
    return out


def width_train_phase(graph, dev, card):
    """G2: 50 sync iterations at four widths on the bench graph, exact
    launch counts, X finite, the statistic of each model against the JAX
    package's at the same width; rwalk's walk attraction at the trained X
    against its plain version.  Returns the runs' counts."""
    total = {}
    for what, over, stat, jax_value in G2_RUNS:
        cfg = dataclasses.replace(BENCH_CONFIG, **over)
        fv = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
        pv = cfg.per_vertex_samples
        walk = fv.model.attraction == "walk"
        emb, counts = train_phase(fv, sync_counts(fv, TRAIN_ITERS, {
            "ell_edge_force": TRAIN_ITERS,
            "grouped_rep_force": 0 if pv else TRAIN_ITERS,
            "ell_sample_force": TRAIN_ITERS if pv else 0,
            "walk_steps": TRAIN_ITERS if walk else 0}), card)
        add_counts(total, counts)
        q = quality(graph, emb)
        gap = (q["dot_edge"] - q["dot_rand"] if stat == "dot"
               else q["d_rand"] - q["d_edge"])
        kind = "x_i.x_j" if stat == "dot" else "distance"
        if stat == "fr":
            ok, need = (abs(gap - jax_value) <= 0.5 * abs(jax_value),
                        f"within {0.5 * abs(jax_value):.4f} of it")
        else:
            ok, need = gap > 0.5 * jax_value, f"> {0.5 * jax_value:.4f}"
        say(f"path G2 {what} (row width {fv.row_width}), {TRAIN_ITERS} "
            f"iterations: {kind} gap {gap:.4f} (JAX {jax_value:.4f}; needs "
            f"{need}) [{card}]")
        check(ok, f"path G2 {what}: the {kind} gap strays from the JAX "
                  "package's")
        if fv.model.attraction == "walk":
            x = fv.pad_embedding(emb)
            xg = x.to(torch.bfloat16)
            walks = fv.draw_walks(torch.Generator(dev).manual_seed(13))
            got = fk.ell_edge_force(fv.model, x, xg, walks, fv._walk_deg,
                                    fv._all_rows, fv.inv_deg, fv.lr)
            check(bool(got.abs().max() > 0), "path G2: the walk attraction "
                                             "is 0: the check is vacuous")
            e, r = g_ratio(fv.model, cfg.dim, edge_parts(
                fk.EdgeWorkTable.single(walks, fv._walk_deg, fv._all_rows,
                                        fv.layout.n_pad),
                x, xg, fv.inv_deg, fv.lr, got))
            say(f"path G2 {what}: the walk attraction at the trained X vs "
                f"plain max_abs_err={e:.3e} bound_ratio={r:.4f}")
            check(r <= 1.0, f"path G2 {what}: walk attraction bound ratio "
                            f"{r:.3f}")
    return total


def width_cli_phase(graph, mtx, tmp, card):
    """G3: ``--schedule sync -dim 100`` and ``--schedule vertex --devices 1
    -dim 24`` through the command line, each with a checkpoint at its end:
    exact launch counts, the JAX CLI's output name and ``Results.txt`` row,
    an ``.embd`` and a checkpoint of ``dim`` columns that agree."""
    total = {}
    it = G_CLI_ITERS
    for schedule, dim, expect in (
            ("sync", 100, {"ell_edge_force": it, "grouped_rep_force": it}),
            ("vertex", 24, {"ell_edge_force": 2 * it,
                            "grouped_rep_force": it})):
        out = os.path.join(tmp, f"width_{schedule}_{dim}")
        counts, _ = cli_run(["-input", mtx, "-output", out, "-option", "5",
                             "-iter", str(it), "-dim", str(dim),
                             "--schedule", schedule, "--devices", "1",
                             "--checkpoint-every", str(it)],
                            expect, f"--schedule {schedule} -dim {dim}", card)
        add_counts(total, counts)
        embd, _ = cli_outputs(
            out, f"bench.mtxF2VTDIST256D{dim}IT{it}NS5.embd",
            ["tdist", "Init", f"Iteration:{it}", "Numofthreads:0",
             "BatchSize:256", f"Dimension:{dim}"])
        emb, at = load_checkpoint(os.path.join(out, f"ckpt_{it:07d}.npz"))
        check(at == it and emb.shape == (graph.n, dim)
              and np.isfinite(emb).all(),
              f"G3 {schedule} -dim {dim}: checkpoint {emb.shape} at {at}")
        check_embd_head(embd, emb)
        say(f"path G3 --schedule {schedule} -dim {dim}: "
            f"{os.path.basename(embd)} of {dim} columns, the checkpoint's "
            f"values [{card}]")
    return total


def widths_path(graph, dev, card):
    """Path G: G1 and G4 at every width of G_DIMS and both gather dtypes
    (the planted faults at G_FAULT_DIM), G2 and G3.  Returns (the launch
    counts of G2 and G3, {kernel: [row class records]})."""
    fv = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev)
    classes = {k: [] for k in ("ell_edge_force", "grouped_rep_force",
                               "ell_sample_force", "tp_pair_partial",
                               "tp_pair_force")}
    t0 = time.perf_counter()
    width_refusals(fv, dev, card)
    for dim in G_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            res, fault = width_kernels(fv, dim, dtype, dev,
                                       faults=dim == G_FAULT_DIM)
            times = width_times(fv, dim, dtype, dev)
            t = str(dtype)[6:]
            for k, (ratio, err) in res.items():
                ms, b_ms, p_ms, by = times[k]
                # the repulsion's samples and x_i are f32 in its kernel
                cls = row_class(dim, torch.float32
                                if k == "grouped_rep_force" else dtype)
                classes[k].append(dict(
                    dim=dim, gather=t, row_class=cls,
                    row_width=fk.padded_dim(dim), max_abs_err=err,
                    bound_ratio=ratio, ms=ms, bound_ms=b_ms, plain_ms=p_ms,
                    bound_by=by,
                    **({"fault_ratio": fault[k]} if k in fault else {})))
            say(f"path G1/G4 dim {dim} {t}: " + "; ".join(
                f"{k} [{row_class(dim, dtype)}] ratio {r:.4f} err {e:.2e} "
                f"queued {times[k][0]:.4f} ms (bound {times[k][1]:.4f}, "
                f"plain {times[k][2]:.4f})" for k, (r, e) in res.items())
                + (f"; planted faults (last real column skipped) "
                   f"{json.dumps({k: round(v, 1) for k, v in fault.items()})}"
                   if fault else "") + f" [{card}]")
    say(f"path G1/G4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = width_train_phase(graph, dev, card)
    say(f"path G2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mtx = os.path.join(tmp, "bench.mtx")
        write_mtx(graph, mtx)
        add_counts(counts, width_cli_phase(graph, mtx, tmp, card))
    say(f"path G3: {time.perf_counter() - t0:.1f} s")
    return counts, classes


# -- path I: X held in bf16 ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def big_graph():
    """``synth_powerlaw_graph`` at BIG_N vertices (its bf16 replica past
    the L2), built once for the paths that time it."""
    return synth_powerlaw_graph(n=BIG_N)


def x_bf16_fault_ratios(model, x, table, invd, step, got):
    """Bound ratios of a storing table launch's output ``got`` against two
    faulty plain versions: each row's last slot skipped, and x_i read as
    zeros (the gather rows kept).  Both must be above 1."""
    skip = zero = 0.0
    for nbr, deg, xi_row, ob in table.parts():
        part = got[ob: ob + nbr.shape[0]]
        skip = max(skip, bound_ratio(part, fk.ell_edge_force_terms(
            model, x, x, nbr, (deg - 1).clamp(min=0), xi_row, invd, step)))
        zero = max(zero, bound_ratio(part, fk.ell_edge_force_terms(
            model, torch.zeros_like(x), x, nbr, deg, xi_row, invd, step)))
    return skip, zero


def x_bf16_tp_phase(fv, x, negs_t, step, card, tag="I1"):
    """The split-dim pair at bf16 (or f16) X over main's tables, as a tp =
    2 rank runs it (its half of the columns, X its own gather table): each
    rank's
    ``tp_pair_partial`` over the attraction's and repulsion's tables laid
    end to end, the two summed (the all_reduce, in f32), then
    ``tp_pair_force`` on each table on each half, every launch against
    its plain version; then both kernels timed (``tp_timing``).  Returns
    their ``kernels`` line records."""
    model = fv.model
    cat, halves = tp_tables(fv, negs_t)
    d = x.shape[1] // F_TP
    cols = [x[:, c: c + d].contiguous() for c in range(0, x.shape[1], d)]
    parts = [fk.tp_pair_partial(model, h, h, cat) for h in cols]
    errs = {"tp_pair_partial": max(
        (tp_partial_ratio(model, h, h, cat, p) for h, p in zip(cols, parts)),
        key=lambda r: r[1])}
    a = sum(parts)
    worst = (0.0, 0.0)
    for kind, t, s in halves:
        for h in cols:
            got = fk.tp_pair_force(model, kind, h, h, t,
                                   a[s: s + t.nbr.shape[0]], fv.inv_deg, step)
            check(got.dtype == x.dtype, f"tp_pair_force wrote {got.dtype} "
                                        f"for a {x.dtype} X")
            r = tp_force_ratio(model, kind, h, h, t, a[s: s + t.nbr.shape[0]],
                               fv.inv_deg, step, got)
            worst = max(worst, r, key=lambda v: v[1])
    errs["tp_pair_force"] = worst
    say(f"{tag} split-dim pair at {x.dtype} X (tp=2 halves, one card): "
        + "; ".join(f"{k} max_abs_err={e:.3e} bound_ratio={r:.4f}"
                    for k, (e, r) in errs.items()))
    check(all(r <= 1.0 for _, r in errs.values()),
          f"a split-dim launch at {x.dtype} X exceeds its bound")
    return tp_timing(fv, x, negs_t, card, {k: e for k, (e, _) in
                                             errs.items()})


def x_bf16_kernels_phase(fv, x, negs_t, card, tag="I1"):
    """I1 (K1 with an f16 X): every kernel of the bf16-X paths at the
    bench shapes, on X and the tables it gathers from itself, against its
    plain version elementwise (1e-5 of Σ|terms| plus half an ulp of the
    output):
    the edge table launch (tdist; sigmoid, fr, linlog and forceatlas on
    the widest bucket), ``grouped_rep_force``, ``ell_sample_force``
    adding, and the split-dim pair; two planted faults; each timed beside
    its bound and plain version.  Returns {kernel: record}."""
    model, step = fv.model, round_to(fv.lr, x.dtype)
    t, invd = fv.edge_table, fv.inv_deg
    xt = str(x.dtype)[6:]
    check(x.dtype == invd.dtype != torch.float32, f"path {tag[0]} holds X "
                                                  "and inv_deg in 2 bytes")
    rec = {}
    e, ratio = check_table(model, x, x, t, invd, step, f"{xt} X tdist")
    got = fk.ell_edge_force_table(model, x, x, t, invd, step)
    check(got.dtype == x.dtype, f"the edge launch wrote {got.dtype}")
    skip, zero = x_bf16_fault_ratios(model, x, t, invd, step, got)
    say(f"{tag} planted faults: each row's last slot skipped bound_ratio="
        f"{skip:.2f}, x_i read as zeros bound_ratio={zero:.2f} (must be > 1)")
    check(skip > 1.0, f"the {xt}-X bound passed a launch that skips each "
                      "row's last slot")
    check(zero > 1.0, f"the {xt}-X bound passed a launch that reads x_i as "
                      "0")
    args = (model, x, x, t, invd, step)
    nbytes, terms = ell_work([p[:3] for p in t.parts()], x, x, True)
    b_ms, by = bound_ms(nbytes, terms * term_flops(model, "edge", x.shape[1]))
    rec["ell_edge_force"] = dict(
        max_abs_err=e, bound_ratio=ratio,
        ms=cuda_ms(lambda: fk.ell_edge_force_table(*args), reps=20),
        queued_ms=queued_device_ms(lambda: fk.ell_edge_force_table(*args),
                                   reps=20),
        plain_ms=cuda_ms(lambda: fk.ell_edge_force_table_plain(*args),
                         reps=3),
        bound_ms=b_ms, bound_by=by)

    sg = bench_samples(fv, x, seed=5)
    e, ratio = check_rep(model, x, sg, step, f"{xt} X tdist")
    n, dim = x.shape
    rargs = (model, BENCH_CONFIG.batch_size, x, sg, step)
    b_ms, by = bound_ms(2 * n * dim * 2 + sg.numel() * 2,
                        n * sg.shape[1] * term_flops(model, "sample", dim))
    rec["grouped_rep_force"] = dict(
        max_abs_err=e, bound_ratio=ratio,
        ms=cuda_ms(lambda: fk.grouped_rep_force(*rargs), reps=20),
        queued_ms=queued_device_ms(lambda: fk.grouped_rep_force(*rargs),
                                   reps=20),
        plain_ms=cuda_ms(lambda: fk.grouped_rep_force_plain(*rargs), reps=3),
        bound_ms=b_ms, bound_by=by)

    n_pad, ns = fv.layout.n_pad, BENCH_CONFIG.ns
    idx = torch.randint(0, fv.graph.n - 1, (n_pad, ns), dtype=torch.int32,
                        generator=torch.Generator(x.device).manual_seed(11),
                        device=x.device)
    deg = torch.full((n_pad,), ns, dtype=torch.int32, device=x.device)
    rows = torch.arange(n_pad, dtype=torch.int32, device=x.device)
    e, ratio = check_sample(model, x, x, idx, deg, rows, step,
                            f"{xt} X tdist")
    accumulate_check(model, x, x, idx, deg, rows, step, f"{xt} X")
    upd = torch.zeros_like(x)
    sargs = (model, x, x, idx, deg, rows, step)
    kw = dict(out=upd, accumulate=True)
    nbytes, terms = ell_work([(idx, deg, rows)], x, x, False, reads_out=True)
    b_ms, by = bound_ms(nbytes, terms * term_flops(model, "sample", dim))
    rec["ell_sample_force"] = dict(
        max_abs_err=e, bound_ratio=ratio,
        ms=cuda_ms(lambda: fk.ell_sample_force(*sargs, **kw), reps=20),
        queued_ms=queued_device_ms(lambda: fk.ell_sample_force(*sargs, **kw),
                                   reps=20),
        plain_ms=cuda_ms(lambda: fk.ell_sample_force_plain(*sargs, **kw),
                         reps=3),
        bound_ms=b_ms, bound_by=by)

    b = widest_bucket(fv)
    sub = torch.arange(b.nbr.shape[0], device=x.device)
    for name in ("sigmoid", "fr", "linlog", "forceatlas"):
        m = get_model(name)
        e_e, r_e = check_edge(m, x, x, b, invd, 0.02, f"{xt} X {name}")
        e_r, r_r = check_rep(m, x, sg, 0.02, f"{xt} X {name}")
        e_s, r_s = check_sample(m, x, x, idx[sub], deg[sub],
                                b.xi_row, 0.02, f"{xt} X {name}")
        say(f"{tag} {name} at {xt} X: edge (widest bucket) max_abs_err="
            f"{e_e:.3e} bound_ratio={r_e:.4f}; repulsion {e_r:.3e} / "
            f"{r_r:.4f}; sample (the bucket's rows) {e_s:.3e} / {r_s:.4f}")
    for k, r in rec.items():
        say(f"{tag} {k} at {xt} X: max_abs_err={r['max_abs_err']:.3e} "
            f"bound_ratio={r['bound_ratio']:.4f} kernel_ms={r['ms']:.4f} "
            f"queued={r['queued_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]")
    rec.update(x_bf16_tp_phase(fv, x, negs_t, step, card, tag))
    return rec


def x_casts(fn, x) -> int:
    """How many times ``fn()`` casts a tensor of ``x``'s shape
    (``aten::_to_copy``): the f32-X iteration's bf16 replica of X."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name == "aten::_to_copy"
               and e.input_shapes and list(e.input_shapes[0]) == list(x.shape))


def rounding_bound(fv, x0, negs_t):
    """``[n_pad, D]`` f32: per element, how far two bf16-X (or f16-X)
    iterations of ``fv`` from ``x0`` and the same negatives may lie apart
    when their f32 sums agree but each rounds its own way: one ulp of X's
    dtype each of the attraction, the repulsion, the update (their sum)
    and X + update, and for a hub owner one of each partial row summed
    into its attraction; each at the plain versions' values."""
    def ulp(t):
        return 2 * half_ulp(t)

    step = round_to(fv.lr, x0.dtype)
    out = fv._edge_table_launch(x0, x0, step, True)
    hub = torch.zeros(x0.shape, device=x0.device)
    if fv._hub is not None:
        h, n_pad = fv._hub, fv.layout.n_pad
        hub_owner_sum(hub[h.start: fv.layout.n],
                      ulp(out[n_pad: n_pad + h.n_virtual]), h.owner_off)
    att = fv._place_attraction(out)
    rep = fv._rank_repulsion(x0, x0, negs_t, step, True)
    upd = (att.float() + rep.float()).to(x0.dtype)
    new = (x0.float() + upd.float()).to(x0.dtype)
    return ulp(att) + ulp(rep) + ulp(upd) + ulp(new) + hub


def ulp_ratio(got, want, bound):
    """max over elements of |got - want| / ``bound`` (``rounding_bound``);
    at most 1 passes."""
    d = (got.float() - want.float()).abs()
    return float(torch.where(d == 0, 0.0, d / bound).max())


def x_bf16_iteration_phase(fv, x0, negs_t, card, tag="I2"):
    """I2 (K2 with an f16 X): one bf16-X iteration through the kernels and
    through the plain
    versions, from one X and negatives: no cast of X (no ``_to_copy`` of
    its shape; the f32-X iteration makes one), no ``add_`` (the repulsion
    launch applies X += update + repulsion), each element within the
    roundings the two
    may each make their own way (``rounding_bound``); then against the
    f32-X iteration (bf16 gathers) from the same X, its difference stated.
    Returns the bf16 iteration's max |dX| from the f32 one."""
    run = lambda xx, **kw: fv.run_iteration(xx, negs_t, **kw)  # noqa: E731
    casts = x_casts(lambda: run(x0.clone()), x0)
    adds = count_ops(lambda: run(x0.clone()), "aten::add_")
    f32 = SyncForce2Vec(fv.graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH,
                        device=x0.device)
    x32 = x0.float()
    f32_casts = x_casts(lambda: f32.run_iteration(x32.clone(), negs_t), x32)
    xt = str(x0.dtype)[6:]
    say(f"{tag} a {xt}-X iteration: {casts} casts of X, {adds} add_ calls "
        f"(an f32-X iteration: {f32_casts} casts of X)")
    check(f32_casts == 1, f"an f32-X iteration casts X {f32_casts} times")
    check(casts == 0, f"a {xt}-X iteration casts {casts} times, not 0")
    check(adds == 0, f"a {xt}-X iteration calls add_ {adds} times, not 0")
    a, b = run(x0.clone()), run(x0.clone(), plain=True)
    check(a.dtype == x0.dtype and bool(torch.isfinite(a).all()),
          f"the {xt}-X iteration: {a.dtype}, finite "
          f"{bool(torch.isfinite(a).all())}")
    ratio = ulp_ratio(a, b, rounding_bound(fv, x0, negs_t))
    say(f"{tag} iteration kernels vs plain at {xt} X: max |dX| "
        f"{max_err(a, b):.3e}, rounding ratio {ratio:.4f} (needs <= 1)")
    check(ratio <= 1.0, f"the {xt}-X iteration differs from its plain "
                        "version by more than their roundings")
    c = f32.run_iteration(x32.clone(), negs_t)
    d = (a.float() - c).abs()
    say(f"{tag} {xt}-X iteration vs the f32-X iteration (bf16 gathers) "
        f"from the same X: max |dX| {float(d.max()):.3e}, mean "
        f"{float(d.mean()):.3e}")
    check(bool(torch.isfinite(c).all()), "the f32-X iteration is not finite")
    return float(d.max())


def x_bf16_train_phase(graph, dev, card, config=I_CONFIG,
                       gaps=(JAX_TDIST_X_BF16_GAP, JAX_TDIST_PV_X_BF16_GAP,
                             JAX_TDIST_BATCH_X_BF16_GAP), tag="I3"):
    """I3 (K3 with ``K_CONFIG``): 50 iterations at bf16 X with exact launch
    counts (one edge and one repulsion launch an iteration, no cast of
    X), group-shared and ``-bs 1``; the batch schedule at bf16
    for CLI_ITERS iterations; each with half the JAX package's distance
    gap at that X (``gaps``: main, ``-bs 1``, batch).  Returns the launch
    counts."""
    counts = {}
    xt = config.dtype
    for what, over, gap in (
            ("main", {}, gaps[0]),
            ("-bs 1", dict(per_vertex_samples=True), gaps[1])):
        fv = SyncForce2Vec(graph, dataclasses.replace(config, **over),
                           MIN_WIDTH, HUB_WIDTH, device=dev)
        xs = fv.init_embedding(seed=1)
        casts = x_casts(lambda: fv.run_span(xs, 1, 1), xs)
        check(casts == 0, f"a {xt}-X training iteration ({what}) casts "
                          f"{casts} times")
        pv = bool(over)
        emb, c = train_phase(fv, {
            "ell_edge_force": TRAIN_ITERS,
            "grouped_rep_force": 0 if pv else TRAIN_ITERS,
            "ell_sample_force": TRAIN_ITERS if pv else 0}, card)
        add_counts(counts, c)
        distance_gap_check(graph, emb.float(), 0.5 * gap,
                           f"{xt} X {what} (JAX {gap:.4f})")
    fv = Force2Vec(graph, config, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    emb = fv.train(iters=CLI_ITERS, seed=1)
    wall = time.perf_counter() - t0
    c = read_counts()
    check(not any(c.values()), f"the batch schedule launched a kernel: {c}")
    check(str(emb.dtype) == f"torch.{xt}"
          and bool(torch.isfinite(emb).all()), f"the {xt}-X batch run's X")
    say(f"{tag} batch schedule at {xt} X: {CLI_ITERS} iterations in "
        f"{wall:.2f} s [{card}]")
    distance_gap_check(graph, emb.float(), 0.5 * gaps[2],
                       f"{xt} X batch (JAX {gaps[2]:.4f})", iters=CLI_ITERS)
    return counts


def x_bf16_vertex_phase(graph, dev, card, fv, x0, negs_t, tag="I4"):
    """I4 (K4 with an f16 X): ``VertexShardedForce2Vec`` at P = 1 with
    bf16 X, its iteration against the bf16 sync iteration (every group
    sharing the pool), each
    element within their roundings (``rounding_bound``); its exchange bytes
    at X's itemsize (P = 1, and a P = 4 layout of the bench graph); then
    the sync runner's dp = 2 slices on this card against one card.
    Returns the dp launch counts."""
    cfg, ns = fv.config, BENCH_CONFIG.ns
    xt = cfg.dtype
    v = VertexShardedForce2Vec(graph, cfg, min_width=MIN_WIDTH,
                               hub_width=HUB_WIDTH, device=dev)
    x_host = fv.unpad_embedding(x0)
    pool = np.random.default_rng(7).integers(0, graph.n - 1, ns).astype(
        np.int32)
    ng = -(-fv.layout.n_pad // cfg.batch_size)
    shared = torch.as_tensor(np.broadcast_to(pool, (ng, ns)).copy(),
                             device=dev)
    want = fv.unpad_embedding(fv.run_iteration(x0.clone(), shared))
    xv = v.pad_embedding(x_host)
    check(xv.dtype == x0.dtype, f"the vertex X is {xv.dtype}")
    got = v.unpad_embedding(v.run_iteration(xv, pool))
    ratio = ulp_ratio(got, want, fv.unpad_embedding(
        rounding_bound(fv, x0, shared)))
    stats = {}
    for P in (1, 4):
        runner = copy.copy(v)
        if P > 1:
            runner.layout = VertexShardLayout.build(
                graph, P, min_width=MIN_WIDTH, hub_width=HUB_WIDTH)
        cs = runner.comm_stats()
        emb_rows = sum(val for k, val in cs.items() if k.endswith(
            ("_rows_sent", "_rows_recv", "_rows")))
        check(cs["bytes_per_iter_per_shard"] == emb_rows * v.row_width * 2,
              f"P={P} exchange bytes {cs['bytes_per_iter_per_shard']} are "
              f"not {emb_rows} rows of {xt}")
        stats[P] = cs["bytes_per_iter_per_shard"]
    say(f"{tag} vertex P=1 at {xt} X vs the {xt} sync iteration: max |dX| "
        f"{max_err(got, want):.3e}, rounding ratio {ratio:.4f} (needs <= 1); "
        f"exchange bytes per iteration per rank at {xt}: P=1 {stats[1]}, "
        f"P=4 layout {stats[4]} ({stats[4] / 1e6:.2f} MB)")
    check(ratio <= 1.0, f"the {xt} vertex iteration differs from sync")

    step = round_to(fv.lr, x0.dtype)
    ranks = [SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH,
                           spmd=SpmdAxes(n_dp=SLICE_DP, dp_index=k),
                           device=dev)
             for k in range(SLICE_DP)]
    reset_counts()
    outs = [r._edge_table_launch(x0, x0, step, False) for r in ranks]
    reps = [r._rank_repulsion(x0, x0, negs_t, step, False) for r in ranks]
    torch.cuda.synchronize(dev)
    counts = read_counts()
    check(counts == {**{k: 0 for k in counts}, "ell_edge_force": SLICE_DP,
                     "grouped_rep_force": SLICE_DP},
          f"the {xt} dp slices' launches {counts}")
    g = torch.cat(outs + [torch.zeros_like(outs[0][:1])])
    new = x0 + ranks[0]._dp_place(g).add_(torch.cat(reps))
    one = fv.run_iteration(x0.clone(), negs_t)
    ratio = ulp_ratio(new, one, rounding_bound(fv, x0, negs_t))
    say(f"{tag} dp={SLICE_DP} slices at {xt} X on one card: launches "
        f"{counts}; put in place vs one card max |dX| "
        f"{max_err(new, one):.3e}, rounding ratio {ratio:.4f} [{card}]")
    check(ratio <= 1.0, f"the {xt} dp slices' update differs from one "
                        "card's")
    return counts


def x_bf16_timing_phase(graph, dev, card):
    """I5: main queued ahead of the device with f32 X (bf16 gathers) and
    with bf16 X, in turns (f32, bf16, bf16, f32), at the bench graph and
    at BIG_N vertices; the batch schedule at f32 and bf16 X, back to
    back, in turns.  Returns the record."""
    out = {}
    for g in (graph, big_graph()):
        runners = {dt: SyncForce2Vec(g, c, MIN_WIDTH, HUB_WIDTH, device=dev)
                   for dt, c in (("float32", BENCH_CONFIG),
                                 ("bfloat16", I_CONFIG))}
        ng = -(-runners["float32"].layout.n_pad // BENCH_CONFIG.batch_size)
        negs = torch.randint(0, g.n - 1, (ng, BENCH_CONFIG.ns),
                             dtype=torch.int32, device=dev,
                             generator=torch.Generator(dev).manual_seed(3))
        xs = {dt: fv.init_embedding(seed=1) for dt, fv in runners.items()}
        times = {"float32": [], "bfloat16": []}
        for dt in ("float32", "bfloat16", "bfloat16", "float32"):
            fv = runners[dt]
            times[dt].append(queued_device_ms(
                lambda: fv.run_iteration(xs[dt], negs), reps=10))
        for dt, x in xs.items():
            check(bool(torch.isfinite(x).all()), f"n={g.n} {dt}: X is not "
                                                 "finite")
        say(f"I5 main at n={g.n}, queued ms/iteration in turns: f32 X "
            f"{times['float32']}, bf16 X {times['bfloat16']} [{card}]")
        out[g.n] = times
    batch = {"float32": [], "bfloat16": []}
    runners = {dt: Force2Vec(graph, dataclasses.replace(
        BENCH_CONFIG, gather_dtype=None, dtype=dt), device=dev)
        for dt in batch}
    xs = {dt: fv.init_embedding(seed=1) for dt, fv in runners.items()}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        fv = runners[dt]
        batch[dt].append(cuda_ms(lambda: fv.run_span(xs[dt], 1, 1), reps=2,
                                 warmup=1))
    say(f"I5 batch schedule at the bench graph, ms/iteration back to back in "
        f"turns: f32 X {batch['float32']}, bf16 X {batch['bfloat16']} "
        f"[{card}]")
    out["batch"] = batch
    return out


def x_bf16_refusals(graph, dev, fv, x):
    """The dtype the kernels lack (float64) is refused by name in the sync
    and vertex constructors, and a bf16 X beside an f32 gather table by
    the wrappers, with no launch."""
    reset_counts()
    for dtype in ("float64",):
        cfg = dataclasses.replace(I_CONFIG, dtype=dtype)
        for make in (lambda: SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH,
                                           device=dev),
                     lambda: VertexShardedForce2Vec(graph, cfg, device=dev)):
            try:
                make()
            except ValueError as e:
                check(dtype in str(e), f"the refusal of {dtype} says: {e}")
            else:
                raise RuntimeError(f"a {dtype} X was not refused")
    try:
        fk.ell_edge_force_table(fv.model, x, x.float(), fv.edge_table,
                                fv.inv_deg, fv.lr)
    except ValueError as e:
        check("gathers from bf16" in str(e), f"the wrapper said: {e}")
    else:
        raise RuntimeError("a bf16 X beside an f32 gather table ran")
    check(not any(read_counts().values()), "a refused call launched")
    say("I0 float64 X refused by name before any launch; a bf16 X beside an "
        "f32 gather table refused")


def x_bf16_path(graph, dev, card):
    """Path I: X held in bf16 (``TrainConfig(dtype="bfloat16")``) at the
    main path's configuration.  Returns (each kernel's bf16-X record, the
    launch counts of its drives, the timing record)."""
    t0 = time.perf_counter()
    fv = SyncForce2Vec(graph, I_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev)
    x0 = fv.init_embedding(seed=1)
    negs_t = torch.as_tensor(np.random.default_rng(7).integers(
        0, graph.n - 1, size=fv._neg_shape).astype(np.int32), device=dev)
    x_bf16_refusals(graph, dev, fv, x0)
    rec = x_bf16_kernels_phase(fv, x0, negs_t, card)
    say(f"path I1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["vs_f32_iteration_max_dx"] = x_bf16_iteration_phase(fv, x0, negs_t,
                                                            card)
    say(f"path I2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = x_bf16_train_phase(graph, dev, card)
    say(f"path I3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(counts, x_bf16_vertex_phase(graph, dev, card, fv, x0, negs_t))
    say(f"path I4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timing = x_bf16_timing_phase(graph, dev, card)
    say(f"path I5: {time.perf_counter() - t0:.1f} s")
    return rec, counts, timing


# -- path K: X held in f16, and the f16 gather replica ------------------------


def x_f16_refusals(fv, x):
    """K0: the (X, gather) pairs the kernels lack, refused by the wrappers
    by name with no launch: an f16 X beside a bf16 or an f32 table, a bf16
    X beside an f16 one."""
    reset_counts()
    t, invd = fv.edge_table, fv.inv_deg
    for xx, xg, name in ((x, x.bfloat16(), "f16"), (x, x.float(), "f16"),
                         (x.bfloat16(), x, "bf16")):
        try:
            fk.ell_edge_force_table(fv.model, xx, xg, t, invd.to(xx.dtype),
                                    fv.lr)
        except ValueError as e:
            check(f"gathers from {name}" in str(e), f"the wrapper said: {e}")
        else:
            raise RuntimeError(f"a {xx.dtype} X beside a {xg.dtype} table "
                               "ran")
    check(not any(read_counts().values()), "a refused call launched")
    say("K0 an f16 X beside a bf16 or f32 gather table, and a bf16 X beside "
        "an f16 one, refused by name before any launch")


def x_f16_widths_phase(dev, card, fv):
    """K1 at every width: each kernel and the split-dim pair with f16 X
    and with the f16 replica of an f32 X, every model (``width_kernels``;
    the planted faults at G_FAULT_DIM); each f16-X class timed
    (``width_times``); ``grouped_rep_force``'s modes with f16 X and with
    f16 samples beside an f32 X (``rep_mode_check``; its planted faults at
    J_FAULT_DIMS).  Returns {kernel: [row class records]} of the f16-X
    classes."""
    classes = {k: [] for k in ("ell_edge_force", "grouped_rep_force",
                               "ell_sample_force", "tp_pair_partial",
                               "tp_pair_force")}
    f16 = torch.float16
    for dim in G_DIMS:
        res = {}
        for x_dtype in (f16, torch.float32):
            res[x_dtype], fault = width_kernels(fv, dim, f16, dev,
                                                faults=dim == G_FAULT_DIM,
                                                x_dtype=x_dtype)
            say(f"K1 dim {dim} f16 gathers, X {str(x_dtype)[6:]}: "
                + "; ".join(f"{k} ratio {r:.4f} err {e:.2e}"
                            for k, (r, e) in res[x_dtype].items())
                + (f"; planted faults (last real column skipped) "
                   f"{json.dumps({k: round(v, 1) for k, v in fault.items()})}"
                   if fault else "") + f" [{card}]")
        times = width_times(fv, dim, f16, dev, x_dtype=f16)
        for k, (ratio, err) in res[f16].items():
            ms, b_ms, p_ms, by = times[k]
            classes[k].append(dict(
                dim=dim, x="f16", row_class=row_class(dim, f16),
                row_width=fk.padded_dim(dim), max_abs_err=err,
                bound_ratio=ratio, ms=ms, bound_ms=b_ms, plain_ms=p_ms,
                bound_by=by))
        say(f"K1 dim {dim} f16 X [{row_class(dim, f16)}], queued: "
            + "; ".join(f"{k} {v[0]:.4f} ms (bound {v[1]:.4f}, plain "
                        f"{v[2]:.4f})" for k, v in times.items())
            + f" [{card}]")
    for dim in J_DIMS:
        for x_dtype in (f16, torch.float32):
            ratios, caught = rep_mode_check(fv, dim, x_dtype, f16, dev,
                                            faults=dim in J_FAULT_DIMS)
            say(f"K1 grouped_rep_force modes dim {dim} X "
                f"{str(x_dtype)[6:]} f16 samples: "
                + ", ".join(f"{m} {r:.4f}" for m, r in ratios.items())
                + (f"; planted faults {json.dumps(caught)}" if caught
                   else ""))
    return classes


def x_f16_replica_phase(graph, dev, card, x0, negs_t):
    """K2 and K3 of the f16 replica beside an f32 X: one iteration through
    the kernels against the plain versions (one cast of X, to the replica;
    no ``add_``), within ITER_TOL; then 50 iterations with exact launch
    counts and half the JAX package's gap.  Returns the launch counts."""
    fv = SyncForce2Vec(graph, K_REPLICA_CONFIG, MIN_WIDTH, HUB_WIDTH,
                       device=dev)
    x32 = x0.float()
    check(fv._replica(x32).dtype == torch.float16, "the replica is not f16")
    run = lambda xx, **kw: fv.run_iteration(xx, negs_t, **kw)  # noqa: E731
    casts = x_casts(lambda: run(x32.clone()), x32)
    adds = count_ops(lambda: run(x32.clone()), "aten::add_")
    a, b = run(x32.clone()), run(x32.clone(), plain=True)
    e = max_err(a, b)
    say(f"K2 an f32-X iteration with the f16 replica: {casts} casts of X, "
        f"{adds} add_ calls; kernels vs plain max |dX| {e:.3e} (needs < "
        f"{ITER_TOL})")
    check(casts == 1 and adds == 0, "the f16-replica iteration's casts and "
                                    "adds")
    check(bool(torch.isfinite(a).all()) and e < ITER_TOL,
          "the f16-replica iteration differs from its plain version")
    emb, counts = train_phase(fv, sync_counts(fv, TRAIN_ITERS, {
        "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS}),
        card)
    distance_gap_check(graph, emb, 0.5 * JAX_TDIST_G_F16_GAP,
                       f"f32 X, f16 replica (JAX {JAX_TDIST_G_F16_GAP:.4f})")
    return counts


def x_f16_timing_phase(graph, dev, card):
    """K5: main queued ahead of the device with f32 X (the bench's bf16
    replica), bf16 X, f16 X and f32 X with the f16 replica, in turns (each
    in that order, then in reverse), at the bench graph and at BIG_N
    vertices.  Returns {n: {config: [ms, ms]}}."""
    configs = {"f32 X": BENCH_CONFIG, "bf16 X": I_CONFIG, "f16 X": K_CONFIG,
               "f32 X f16 replica": K_REPLICA_CONFIG}
    out = {}
    for g in (graph, big_graph()):
        runners = {k: SyncForce2Vec(g, c, MIN_WIDTH, HUB_WIDTH, device=dev)
                   for k, c in configs.items()}
        ng = -(-runners["f32 X"].layout.n_pad // BENCH_CONFIG.batch_size)
        negs = torch.randint(0, g.n - 1, (ng, BENCH_CONFIG.ns),
                             dtype=torch.int32, device=dev,
                             generator=torch.Generator(dev).manual_seed(3))
        xs = {k: fv.init_embedding(seed=1) for k, fv in runners.items()}
        for k, fv in runners.items():  # each runner's buffers allocated
            fv.run_iteration(xs[k], negs)
        torch.cuda.synchronize(dev)
        times = {k: [] for k in configs}
        for k in list(configs) + list(configs)[::-1]:
            fv = runners[k]
            times[k].append(queued_device_ms(
                lambda: fv.run_iteration(xs[k], negs), reps=10))
        for k, x in xs.items():
            check(bool(torch.isfinite(x).all()), f"n={g.n} {k}: X is not "
                                                 "finite")
        say(f"K5 main at n={g.n}, queued ms/iteration in turns: "
            + "; ".join(f"{k} {v}" for k, v in times.items()) + f" [{card}]")
        out[g.n] = times
    return out


def x_f16_path(graph, dev, card):
    """Path K: X held in f16 (``TrainConfig(dtype="float16")``) and the
    f16 replica of an f32 X, at the main path's configuration.  Returns
    (each kernel's f16-X record with its row classes, the launch counts of
    its drives, the timing record)."""
    t0 = time.perf_counter()
    fv = SyncForce2Vec(graph, K_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev)
    x0 = fv.init_embedding(seed=1)
    check(x0.dtype == fv.inv_deg.dtype == torch.float16,
          "path K holds X and inv_deg in f16")
    negs_t = torch.as_tensor(np.random.default_rng(7).integers(
        0, graph.n - 1, size=fv._neg_shape).astype(np.int32), device=dev)
    x_f16_refusals(fv, x0)
    rec = x_bf16_kernels_phase(fv, x0, negs_t, card, tag="K1")
    fv32 = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH,
                         device=dev)
    for k, c in x_f16_widths_phase(dev, card, fv32).items():
        rec[k]["row_classes"] = c
    say(f"path K1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["vs_f32_iteration_max_dx"] = x_bf16_iteration_phase(
        fv, x0, negs_t, card, tag="K2")
    counts = x_f16_replica_phase(graph, dev, card, x0, negs_t)
    say(f"path K2 and the replica's K3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(counts, x_bf16_train_phase(
        graph, dev, card, K_CONFIG, (JAX_TDIST_X_F16_GAP,
                                     JAX_TDIST_PV_X_F16_GAP,
                                     JAX_TDIST_BATCH_X_F16_GAP), tag="K3"))
    say(f"path K3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(counts, x_bf16_vertex_phase(graph, dev, card, fv, x0, negs_t,
                                           tag="K4"))
    say(f"path K4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timing = x_f16_timing_phase(graph, dev, card)
    say(f"path K5: {time.perf_counter() - t0:.1f} s")
    return rec, counts, timing


# -- path J: grouped_rep_force's three modes -----------------------------------


def rounding_half_ulp(t):
    """The most one add in f32, rounded to ``t``'s dtype (f32, bf16 or
    f16), moved each element of ``t``, as f32: half an ulp of f32, and for
    bf16 or f16 half an ulp of t more (the f32 sum rounded again); 0 where
    t is 0, which these adds give only exactly."""
    _, e = torch.frexp(t.float())  # |t| in [2^(e-1), 2^e)
    one = torch.ones_like(e, dtype=torch.float32)
    h = torch.ldexp(one, e - 25) + half_ulp(t)
    return torch.where(t == 0, 0.0, h)


def rep_modes(model, group, xi, sg, step, out0, upd):
    """One launch of each mode from the same inputs: (store's result, add's
    into a copy of ``out0``, apply's X from a copy of ``xi`` with
    ``upd``)."""
    store = fk.grouped_rep_force(model, group, xi, sg, step)
    add = fk.grouped_rep_force(model, group, xi, sg, step, mode="add",
                               out=out0.clone())
    x = xi.clone()
    fk.grouped_rep_force(model, group, x, sg, step, mode="apply", upd=upd)
    return store, add, x


def rep_mode_ratios(model, group, xi, sg, step, out0, upd, got, rtol,
                    fault=None):
    """{mode: bound ratio} of ``got`` (``rep_modes``' three results)
    against each mode composed exactly (f64) from the plain terms:
    |got - ref| ≤ rtol·Σ|terms| plus half an ulp of each rounding the mode
    makes (the repulsion's to a bf16 X; add: the sum's; apply: upd + rep's
    and X + it's).  ``fault``, a planted one the ratio must catch: "store"
    skips each group's last sample, "add" leaves out0 out, "apply" upd."""
    rows = xi.shape[0]
    chunk = max(group, G_TERMS // (sg.shape[1] * xi.shape[1]) // group
                * group)
    worst = dict.fromkeys(fk.REP_MODES, 0.0)
    store, add, apply = got
    for r0 in range(0, rows, chunk):
        r = slice(r0, min(rows, r0 + chunk))
        t = fk.grouped_rep_force_terms(model, group, xi[r], sg[r0 // group:],
                                       step)
        scale = rtol * t.abs().sum(dim=1) + half_ulp(store[r])
        s = (t[:, :-1] if fault == "store" else t).double().sum(dim=1)
        x, u = xi[r].double(), upd[r].double()
        refs = {"store": s,
                "add": s if fault == "add" else out0[r].double() + s,
                "apply": x + s if fault == "apply" else x + (u + s)}
        u_rep = upd[r].clone().add_(store[r])
        scales = {"store": scale,
                  "add": scale + rounding_half_ulp(add[r]),
                  "apply": (scale + rounding_half_ulp(u_rep)
                            + rounding_half_ulp(apply[r]))}
        for m, g in zip(fk.REP_MODES, (store, add, apply)):
            e = (g[r].double() - refs[m]).abs()
            worst[m] = max(worst[m], float(torch.where(
                e == 0, 0.0, e / scales[m].double()).max()))
    return worst


def rep_mode_inputs(n_pad, dim, x_dtype, seed, dev):
    """X at ``padded_dim(dim)`` columns in ``x_dtype``, and an out and an
    update of its shape and dtype, small as an iteration's (padding
    columns 0)."""
    x = padded_x(n_pad, dim, seed, dev).to(x_dtype)
    out0 = (padded_x(n_pad, dim, seed + 1, dev) * 0.01).to(x_dtype)
    upd = (padded_x(n_pad, dim, seed + 2, dev) * 0.01).to(x_dtype)
    return x, out0, upd


def rep_mode_check(fv, dim, x_dtype, sg_dtype, dev, faults):
    """J1 at one width and pair of dtypes: tdist over every row's 256-row
    group of the bench layout, each mode against its exact composition
    (``rep_mode_ratios``), add and apply bit for bit against store then
    ``out.add_`` (``upd.add_(rep); x.add_(upd)``), every output's padding
    columns 0; with ``faults`` each mode's planted fault, which must fail.
    Returns ({mode: ratio}, {mode: fault ratio})."""
    n_pad, group, step = fv.layout.n_pad, BENCH_CONFIG.batch_size, 0.02
    x, out0, upd = rep_mode_inputs(n_pad, dim, x_dtype, dim, dev)
    xg = x if x_dtype != torch.float32 else x.to(sg_dtype)
    sg = bench_samples(fv, xg, seed=5)
    tdist = get_model("tdist")
    got = rep_modes(tdist, group, x, sg, step, out0, upd)
    what = (f"grouped_rep_force dim {dim} X {str(x_dtype)[6:]} samples "
            f"{str(sg_dtype)[6:]}")
    store, add, apply = got
    check(torch.equal(add, out0.clone().add_(store)),
          f"path J {what}: add differs from out.add_ of the stored result")
    check(torch.equal(apply, x.clone().add_(upd.clone().add_(store))),
          f"path J {what}: apply differs from upd.add_(rep); x.add_(upd)")
    for m, g in zip(fk.REP_MODES, got):
        check(not bool(g[:, dim:].any()),
              f"path J {what} {m}: a padding column is not 0")
    ratios = rep_mode_ratios(tdist, group, x, sg, step, out0, upd, got,
                             width_rtol(dim))
    for m, r in ratios.items():
        check(r <= 1.0, f"path J {what} {m}: |err| exceeds the bound by "
                        f"{r:.3f}x")
    caught = {}
    if faults:
        for m in fk.REP_MODES:
            caught[m] = rep_mode_ratios(tdist, group, x, sg, step, out0, upd,
                                        got, width_rtol(dim), fault=m)[m]
            check(caught[m] > 1.0, f"path J {what}: the bound passed the "
                                   f"planted {m} fault ({caught[m]:.3f})")
    return ratios, caught


def rep_chunked_check(fv, dim, x_dtype, dev):
    """J1 with more samples a group than a launch's shared memory holds
    (G_MANY_SAMPLES): a launch a chunk in each mode, the sums passed on in
    f32; store within its bound, add and apply bit for bit store then the
    adds.  Returns the store's ratio."""
    n_pad, group, step = fv.layout.n_pad, BENCH_CONFIG.batch_size, 0.02
    x, out0, upd = rep_mode_inputs(n_pad, dim, x_dtype, dim + 7, dev)
    xg = x.to(torch.bfloat16)
    ng = -(-n_pad // group)
    sg = xg[torch.randint(0, fv.layout.n - 1, (ng, G_MANY_SAMPLES),
                          device=dev,
                          generator=torch.Generator(dev).manual_seed(23))]
    tdist = get_model("tdist")
    per = fk._MAX_SAMPLE_BYTES // (fk.padded_dim(dim) * 4)
    before = fk.launch_counts["grouped_rep_force"]
    got = rep_modes(tdist, group, x, sg, step, out0, upd)
    launches = fk.launch_counts["grouped_rep_force"] - before
    check(dev.type == "cpu" or launches == 3 * -(-G_MANY_SAMPLES // per),
          f"path J chunked dim {dim}: {launches} launches for 3 modes of "
          f"{G_MANY_SAMPLES} samples, {per} a launch")
    store, add, apply = got
    check(torch.equal(add, out0.clone().add_(store))
          and torch.equal(apply, x.clone().add_(upd.clone().add_(store))),
          f"path J chunked dim {dim}: add or apply differs from store and "
          "the adds")
    ratio = rep_mode_ratios(tdist, group, x, sg, step, out0, upd, got,
                            width_rtol(dim))["store"]
    check(ratio <= 1.0, f"path J chunked dim {dim}: bound ratio {ratio:.3f}")
    return ratio


def rep_models_check(fv, dev):
    """Every sample model (tdist, sigmoid exact and table, layout) at the
    bench dim, both X dtypes: add and apply bit for bit store then the
    adds; apply refused with an energy model, no launch."""
    n_pad, group = fv.layout.n_pad, BENCH_CONFIG.batch_size
    for x_dtype in (torch.float32, torch.bfloat16):
        x, out0, upd = rep_mode_inputs(n_pad, BENCH_CONFIG.dim, x_dtype, 31,
                                       dev)
        sg = bench_samples(fv, x.to(torch.bfloat16), seed=5)
        for name in SAMPLE_MODELS:
            m = model_by(name)
            store, add, apply = rep_modes(
                m if m.update != "energy" else dataclasses.replace(
                    m, update="add"), group, x, sg, 0.02, out0, upd)
            check(torch.equal(add, out0.clone().add_(store))
                  and torch.equal(apply,
                                  x.clone().add_(upd.clone().add_(store))),
                  f"path J {name} X {x_dtype}: add or apply differs from "
                  "store and the adds")
    linlog = get_model("linlog")
    reset_counts()
    try:
        fk.grouped_rep_force(linlog, group, x, sg, 0.02, mode="apply",
                             upd=upd)
    except ValueError as e:
        check("energy" in str(e), f"the refusal says: {e}")
    else:
        raise RuntimeError("apply with an energy model was not refused")
    check(not any(read_counts().values()), "a refused call launched")


def rep_mode_times(model, x, sg, step, out0, upd, card, what) -> dict:
    """Each mode at these inputs back to back (CUDA events) and queued
    ahead of the device, beside its bound (bytes: x read, out read and
    written for add, upd read and X written for apply, the samples read;
    f32 operations of the terms) and its plain version."""
    group = BENCH_CONFIG.batch_size
    n, dim = x.shape
    ns = sg.shape[1]
    xs = x.element_size()
    rec = {}
    for mode in fk.REP_MODES:
        kw = ({"out": out0.clone()} if mode == "add" else
              {"upd": upd} if mode == "apply" else {})
        xw = x.clone() if mode == "apply" else x

        def run(plain=False, mode=mode, kw=kw, xw=xw):
            fn = fk.grouped_rep_force_plain if plain else fk.grouped_rep_force
            return fn(model, group, xw, sg, step, mode=mode, **kw)

        nbytes = ((2 if mode == "store" else 3) * n * dim * xs
                  + sg.numel() * sg.element_size())
        b_ms, by = bound_ms(nbytes, n * ns * term_flops(model, "sample", dim))
        rec[mode] = dict(
            ms=cuda_ms(run, reps=20), queued_ms=queued_device_ms(run, reps=20),
            plain_ms=cuda_ms(lambda: run(plain=True), reps=3),
            bound_ms=b_ms, bound_by=by, mbytes=nbytes / 1e6)
        r = rec[mode]
        say(f"J {what} {mode}: kernel_ms={r['ms']:.4f} queued="
            f"{r['queued_ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms="
            f"{b_ms:.4f} ({by}: {nbytes / 1e6:.1f} MB; queued at "
            f"{b_ms / r['queued_ms']:.0%} of it) [{card}]")
    return rec


def composed_rep(model, group, xi, sg, step, *, mode="store", out=None,
                 upd=None, real=fk.grouped_rep_force):
    """``grouped_rep_force`` in ``mode`` composed the way the trainer ran
    it before the modes: the store launch (``real``, the wrapper even where
    ``rep_replaced`` stands in for it), then ``out.add_(rep)``, or
    ``upd.add_(rep); xi.add_(upd)`` (which leaves upd changed)."""
    rep = real(model, group, xi, sg, step)
    if mode == "store":
        return rep
    if mode == "add":
        return out.add_(rep)
    return xi.add_(upd.add_(rep))


@contextlib.contextmanager
def rep_replaced(fn):
    """``force_kernels.grouped_rep_force`` is ``fn`` inside the block (the
    trainer looks it up at every call)."""
    real = fk.grouped_rep_force
    fk.grouped_rep_force = fn
    try:
        yield real
    finally:
        fk.grouped_rep_force = real


def last_launch(fv, x0, negs, walks, what):
    """An iteration's ``grouped_rep_force`` call must be its last launch:
    no launch count moves after the call returns, the host trace shows no
    torch operation after it (marked by a ``record_function`` range), and
    the device's last kernel is the repulsion's.  The profiler must record
    the device's kernels (it does in a fresh process: ``--path J``).
    Returns (the last kernel's name, kernels)."""
    at_return = []

    def marked(*args, real=fk.grouped_rep_force, **kw):
        with torch.profiler.record_function("f2v::grouped_rep_force"):
            res = real(*args, **kw)
        at_return.append(read_counts())
        return res

    torch.cuda.synchronize()
    with rep_replaced(marked), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fv.run_iteration(x0.clone(), negs, walks=walks)
        torch.cuda.synchronize()
    check(len(at_return) == 1,
          f"path J {what}: {len(at_return)} repulsion calls")
    check(read_counts() == at_return[0],
          f"path J {what}: kernels launched after the repulsion: "
          f"{read_counts()} against {at_return[0]} at its return")
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    # the host's range of the marker (its device range is on the kernels'
    # timeline) and the operations of the thread that ran the iteration
    rep = next(e for e in events
               if e.name == "f2v::grouped_rep_force" and e.device_type == cpu)
    after = [(e.name, e.time_range.start) for e in events
             if e.device_type == cpu and e.thread == rep.thread
             and e.name.startswith("aten::")
             and e.time_range.start >= rep.time_range.end]
    check(not after, f"path J {what}: torch operations after the "
                     f"repulsion (its host range {rep.time_range.start}–"
                     f"{rep.time_range.end} us, thread {rep.thread}): "
                     f"{after}")
    # (the marker's range shows on the device's timeline too)
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.name != rep.name
                      and not e.name.startswith(("Memset", "Memcpy"))),
                     key=lambda e: e.time_range.start)
    check(kernels, f"path J {what}: the profiler recorded no device kernel")
    last = kernels[-1].name
    check("grouped_rep_force_kernel" in last,
          f"path J {what}: the iteration's last kernel is {last}")
    return last, len(kernels)


def rep_iteration_check(fv, x0, negs, walks, what):
    """J3: one iteration in the trainer's repulsion mode against the store
    launch and the ``add_``s composed from copies of the launch's own
    operands (the attraction it adds to, X, the samples, the step): bit
    for bit, and with ``apply`` the iteration's X is the launch's.  An
    ``apply`` iteration calls no ``add_`` and the repulsion is its last
    launch (``last_launch``).  Returns the iteration's ``add_`` count."""
    seen = []

    def spy(model, group, xi, sg, step, *, mode="store", out=None,
            upd=None, real=fk.grouped_rep_force):
        ops = [None if t is None else t.clone() for t in (xi, out, upd)]
        got = real(model, group, xi, sg, step, mode=mode, out=out, upd=upd)
        seen.append((mode, got.clone(), composed_rep(
            model, group, ops[0], sg, step, mode=mode, out=ops[1],
            upd=ops[2])))
        return got

    with rep_replaced(spy):
        a = fv.run_iteration(x0.clone(), negs, walks=walks)
    check(len(seen) == 1 and seen[0][0] == fv.rep_mode,
          f"path J {what}: repulsion calls {[m for m, *_ in seen]}, the "
          f"trainer's mode {fv.rep_mode}")
    _, got, want = seen[0]
    check(torch.equal(got, want), f"path J {what}: the {fv.rep_mode} launch "
                                  f"differs from store and the adds by "
                                  f"{max_err(got, want):.3e}")
    check(fv.rep_mode != "apply" or torch.equal(a, want),
          f"path J {what}: the iteration's X is not the apply launch's")
    adds = count_ops(lambda: fv.run_iteration(x0.clone(), negs, walks=walks),
                     "aten::add_")
    if fv.rep_mode == "apply":
        check(adds == 0, f"path J {what}: an apply iteration calls add_ "
                         f"{adds} times")
        last, kernels = last_launch(fv, x0, negs, walks, what)
        say(f"J3 {what}: the apply launch = store + add_s bit for bit; "
            f"add_ calls 0; no launch and no torch operation after the "
            f"repulsion's wrapper; last kernel {last[:80]}; {kernels} "
            "kernels")
    else:
        say(f"J3 {what}: the {fv.rep_mode} launch = store + add_ bit for "
            f"bit; add_ calls {adds}")
    return adds


def rep_modes_path(graph, dev, card):
    """Path J: ``grouped_rep_force``'s store, add and apply modes.  Returns
    (the record, the launch counts of its training runs)."""
    t0 = time.perf_counter()
    fv = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev)
    rec = {"J1": {}, "faults": {}, "chunked": {}}
    for dim in J_DIMS:
        for x_dtype, sg_dtype in J_DTYPES:
            key = f"{dim} {str(x_dtype)[6:]} {str(sg_dtype)[6:]}"
            rec["J1"][key], caught = rep_mode_check(
                fv, dim, x_dtype, sg_dtype, dev, dim in J_FAULT_DIMS)
            if caught:
                rec["faults"][key] = caught
        if dim * 4 * G_MANY_SAMPLES > fk._MAX_SAMPLE_BYTES:
            for x_dtype in (torch.float32, torch.bfloat16):
                rec["chunked"][f"{dim} {str(x_dtype)[6:]}"] = (
                    rep_chunked_check(fv, dim, x_dtype, dev))
    rep_models_check(fv, dev)
    worst = {m: max(r[m] for r in rec["J1"].values()) for m in fk.REP_MODES}
    say(f"J1 every row class, both X dtypes: worst bound ratios {worst}; "
        f"planted faults {rec['faults']}; chunked {rec['chunked']} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    ng = -(-fv.layout.n_pad // BENCH_CONFIG.batch_size)
    negs = torch.as_tensor(np.random.default_rng(7).integers(
        0, graph.n - 1, size=(ng, BENCH_CONFIG.ns)).astype(np.int32),
        device=dev)
    rw_cfg = dataclasses.replace(BENCH_CONFIG, model="rwalk")
    for what, cfg, mode in (
            ("main f32 X", J_CONFIG, "apply"),
            ("main bf16 X", I_CONFIG, "apply"),
            ("rwalk", rw_cfg, "apply"),
            ("linlog", dataclasses.replace(BENCH_CONFIG, model="linlog"),
             "add")):
        fv_j = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
        check(fv_j.rep_mode == mode,
              f"path J {what}: the trainer runs {fv_j.rep_mode}, not {mode}")
        walks = (fv_j.draw_walks(torch.Generator(dev).manual_seed(13))
                 if cfg.model == "rwalk" else None)
        rec[f"J3 {what} add_ calls"] = rep_iteration_check(
            fv_j, fv_j.init_embedding(seed=1), negs, walks, what)
    dp = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev,
                       spmd=SpmdAxes(n_dp=2, dp_index=0))
    check(dp.rep_mode == "store", f"path J: dp runs {dp.rep_mode}")
    say(f"J3 ({time.perf_counter() - t0:.1f} s); dp stores")

    t0 = time.perf_counter()
    counts = {}
    for what, cfg, margin, stat in (
            ("main f32 X", J_CONFIG, QUALITY_MARGIN, "dist"),
            ("main bf16 X", I_CONFIG, 0.5 * JAX_TDIST_X_BF16_GAP, "dist"),
            ("rwalk", rw_cfg, RWALK_DOT_MARGIN, "dot")):
        run = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
        emb, c = train_phase(run, {
            "ell_edge_force": TRAIN_ITERS, "grouped_rep_force": TRAIN_ITERS,
            "walk_steps": TRAIN_ITERS if cfg.model == "rwalk" else 0}, card)
        add_counts(counts, c)
        q = quality(graph, emb.float())
        gap = (q["d_rand"] - q["d_edge"] if stat == "dist"
               else q["dot_edge"] - q["dot_rand"])
        say(f"J4 {what} ({run.rep_mode}) after {TRAIN_ITERS} iterations: "
            f"{stat} gap {gap:.4f} (needs > {margin:.4f})")
        check(gap > margin, f"path J {what}: gap {gap:.4f} <= {margin:.4f}")
        rec[f"J4 {what} gap"] = gap
    say(f"J4 ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    tdist = get_model("tdist")
    n_pad = fv.layout.n_pad
    rec["J5"], rec["J5 classes"] = {}, {}
    for x_dtype in (torch.float32, torch.bfloat16):
        x, out0, upd = rep_mode_inputs(n_pad, BENCH_CONFIG.dim, x_dtype, 41,
                                       dev)
        sg = bench_samples(fv, x.to(torch.bfloat16), seed=5)
        rec["J5"][str(x_dtype)[6:]] = rep_mode_times(
            tdist, x, sg, fv.lr, out0, upd, card,
            f"bench shape X {str(x_dtype)[6:]}")
        for dim in J_DIMS:
            x, out0, upd = rep_mode_inputs(n_pad, dim, x_dtype, 43, dev)
            sg = bench_samples(fv, x.to(torch.bfloat16), seed=5)
            times = {}
            for mode in ("store", "apply"):
                kw = {"upd": upd} if mode == "apply" else {}
                xw = x.clone()
                nbytes = ((2 if mode == "store" else 3) * x.numel()
                          * x.element_size() + sg.numel() * sg.element_size())
                times[mode] = [queued_device_ms(
                    lambda: fk.grouped_rep_force(
                        tdist, BENCH_CONFIG.batch_size, xw, sg, 0.02,
                        mode=mode, **kw), reps=20),
                    bound_ms(nbytes, n_pad * BENCH_CONFIG.ns
                             * term_flops(tdist, "sample", dim))[0]]
            rec["J5 classes"][f"{dim} {str(x_dtype)[6:]}"] = times
            say(f"J5 dim {dim} ({row_class(dim, x_dtype)}) X "
                f"{str(x_dtype)[6:]}: store queued {times['store'][0]:.4f} "
                f"bound {times['store'][1]:.4f}; apply queued "
                f"{times['apply'][0]:.4f} bound {times['apply'][1]:.4f} "
                f"[{card}]")
    # main's iteration with the sequence before the modes (the store
    # launch, then the add_s: composed_rep) and with apply, queued, in turns
    for what, cfg in (("f32 X", J_CONFIG), ("bf16 X", I_CONFIG)):
        run = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
        x = run.init_embedding(seed=1)
        times = {"store": [], "apply": []}
        for m in ("store", "apply", "apply", "store"):
            with (rep_replaced(composed_rep) if m == "store"
                  else contextlib.nullcontext()):
                times[m].append(queued_device_ms(
                    lambda: run.run_iteration(x, negs), reps=10))
        rec[f"J5 main {what} queued"] = times
        say(f"J5 main {what}, queued ms/iteration in turns: store + add_s "
            f"{times['store']}, apply {times['apply']} [{card}]")
    say(f"J5 ({time.perf_counter() - t0:.1f} s)")
    return rec, counts


# -- path M: the fused pass ----------------------------------------------------


def separate_iteration(fv, x, negs, step):
    """The separate passes' iteration of the sync trainer ``fv`` on X in
    place, composed from the kernel wrappers: the replica, the edge
    launch over ``edge_table``, the hub's ordered owner sums, then the
    grouped repulsion's ``apply`` (a gather of the groups' samples first)
    or, with per-vertex negatives, ``ell_sample_force`` adding into the
    update and ``X += update``."""
    lay, hub, model = fv.layout, fv._hub, fv.model
    xg = x.to(fv._gdt)
    out = fk.ell_edge_force_table(model, x, xg, fv.edge_table, fv.inv_deg,
                                  step)
    upd = out[: lay.n_pad]
    if hub is not None:
        hub_owner_sum(upd[hub.start: lay.n],
                      out[lay.n_pad: lay.n_pad + hub.n_virtual],
                      hub.owner_off)
    if fv.config.per_vertex_samples:
        fk.ell_sample_force(model, x, xg, negs, fv._ns_deg, fv._all_rows,
                            step, out=upd, accumulate=True)
        return x.add_(upd)
    return fk.grouped_rep_force(model, fv.config.batch_size, x,
                                xg[negs.long()], step, mode="apply",
                                upd=upd)


def m_iterations(fv, what, errs) -> dict:
    """M1: M_ITERS iterations of ``fv``'s fused iteration, each from the
    fused run's X against ``separate_iteration`` and against itself again,
    on the same X, draws and step: the same bits, or for group-shared
    negatives the update within M_UPD_ERR of the separate passes' and the
    same bits again; the fused launches each iteration makes."""
    dev = fv.device
    x = fv.init_embedding(seed=1)
    gen = torch.Generator(dev)
    same = again = True
    worst = 0.0
    reset_counts()
    for it in range(M_ITERS):
        gen.manual_seed(iteration_seed(1, it))
        negs, _ = fv._draw(gen)
        step = fv._step(it)
        sep, fused, rerun = x.clone(), x.clone(), x.clone()
        separate_iteration(fv, sep, negs, step)
        before = fk.launch_counts["ell_edge_apply"]
        fv.run_iteration(fused, negs, step=step)
        launches = fk.launch_counts["ell_edge_apply"] - before
        fv.run_iteration(rerun, negs, step=step)
        same &= torch.equal(fused, sep)
        again &= torch.equal(fused, rerun)
        d_sep = sep - x
        worst = max(worst, float(torch.linalg.norm(fused - sep)
                                 / torch.linalg.norm(d_sep)))
        x = fused
    pv = fv.config.per_vertex_samples
    want = 2 if fv._hub is not None else 1
    rec = dict(same_bits=same, run_to_run=again, upd_err=worst,
               launches_per_iteration=launches)
    say(f"M1 {what}: {M_ITERS} iterations, fused vs separate passes "
        f"{'the same bits' if same else f'upd_err {worst:.3e}'}, fused run "
        f"to run {'the same bits' if again else 'DIFFERENT'}, "
        f"{launches} fused launches an iteration; X finite "
        f"{bool(torch.isfinite(x).all())}")
    if pv and not same:
        errs.append(f"{what}: -bs 1 fused differs from the separate passes "
                    f"(upd_err {worst:.3e})")
    if not pv and worst > M_UPD_ERR:
        errs.append(f"{what}: upd_err {worst:.3e} > {M_UPD_ERR}")
    if not again:
        errs.append(f"{what}: two fused runs differ")
    if launches != want:
        errs.append(f"{what}: {launches} fused launches, not {want}")
    if not bool(torch.isfinite(x).all()):
        errs.append(f"{what}: X is not finite")
    return rec


def apply_work(fv, x, xg, negs):
    """(bytes, operations) that the fused main launch (``fv.apply_table``)
    must move and compute: ``ell_work``'s count of its entries (the x_i
    rows read, X's applied rows and the hub's partial rows written once,
    the replica rows the slots gather, ids, deg, xi_row, invd), with the
    sample rows no slot gathers and the draws' ids read once; its edge
    terms, the applied rows' ns sample terms and their two adds."""
    table, apply = fv.apply_table
    parts = [p[:3] for p in table.parts()]
    nbytes, terms = ell_work(parts, x, xg, True)
    dim = x.shape[1]
    real = torch.cat([idx[torch.arange(idx.shape[1], device=idx.device)
                          [None, :] < deg[:, None]] for idx, deg, _ in parts])
    slots = real.unique()
    extra = torch.cat([slots, negs.unique()]).unique().numel() - slots.numel()
    nbytes += extra * dim * xg.element_size() + negs.numel() * 4
    applied = fk.applied_rows(table, apply).numel()
    flops = (terms * term_flops(fv.model, "edge", dim)
             + applied * negs.shape[1] * term_flops(fv.model, "sample", dim)
             + applied * 2 * dim)
    return nbytes, flops


def m_timing(fv, what, card) -> dict:
    """M2: the fused main launch against its plain version on copies of
    one X (max |err| over X and the hub's partial rows), timed back to
    back and queued with its least time (``apply_work``); then, queued,
    warm, beside the launches it replaces: the edge launch and the
    repulsion's (grouped ``apply`` of gathered samples, or
    ``ell_sample_force`` adding and ``X += update``), and the whole fused
    iteration against ``separate_iteration``."""
    x0 = fv.init_embedding(seed=1)
    gen = torch.Generator(fv.device).manual_seed(3)
    negs, _ = fv._draw(gen)
    step, model, pv = fv.lr, fv.model, fv.config.per_vertex_samples
    xg = x0.to(fv._gdt)
    group = 1 if pv else fv.config.batch_size
    rest = (xg, *fv.apply_table, fv.inv_deg, negs, group, step)
    xk, xp = x0.clone(), x0.clone()
    got = fk.ell_edge_apply(model, xk, *rest)
    want = fk.ell_edge_apply_plain(model, xp, *rest)
    err = max(max_err(xk, xp), max_err(got, want) if got is not None else 0)
    check(err <= EDGE_TOL + REP_TOL, f"ell_edge_apply {what}: max |err| "
                                     f"{err:.3e} > {EDGE_TOL + REP_TOL}")
    x = x0.clone()
    res = {"max_abs_err": err}
    res["ms"] = cuda_ms(lambda: fk.ell_edge_apply(model, x, *rest), reps=20)
    res["fused"] = queued_device_ms(
        lambda: fk.ell_edge_apply(model, x, *rest), reps=20)
    res["plain_ms"] = cuda_ms(
        lambda: fk.ell_edge_apply_plain(model, x, *rest), reps=3)
    nbytes, flops = apply_work(fv, x0, xg, negs)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
    res["bytes"] = nbytes
    say(f"M2 {what}: ell_edge_apply max_abs_err={err:.3e} kernel_ms="
        f"{res['ms']:.4f} queued={res['fused']:.4f} plain_ms="
        f"{res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} "
        f"({res['bound_by']}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} "
        f"GFLOP) [{card}]")
    x.copy_(x0)
    out = fk.ell_edge_force_table(model, x, xg, fv.edge_table, fv.inv_deg,
                                  step)
    upd = out[: fv.layout.n_pad]
    res["edge"] = queued_device_ms(lambda: fk.ell_edge_force_table(
        model, x, xg, fv.edge_table, fv.inv_deg, step, out=out), reps=20)
    if pv:
        res["repulsion"] = queued_device_ms(lambda: x.add_(
            fk.ell_sample_force(model, x, xg, negs, fv._ns_deg,
                                fv._all_rows, step, out=upd,
                                accumulate=True)), reps=20)
    else:
        sg = xg[negs.long()]
        res["repulsion"] = queued_device_ms(lambda: fk.grouped_rep_force(
            model, group, x, sg, step, mode="apply", upd=upd), reps=20)
    its = {"fused": [], "separate": []}
    for m in ("separate", "fused", "fused", "separate"):
        fn = ((lambda: fv.run_iteration(x, negs, step=step)) if m == "fused"
              else (lambda: separate_iteration(fv, x, negs, step)))
        its[m].append(queued_device_ms(fn, reps=10))
    res["iteration"] = its
    say(f"M2 {what}, queued ms: fused launch {res['fused']:.4f} against "
        f"edge {res['edge']:.4f} + repulsion "
        f"{'(sample, X += update)' if pv else '(apply)'} "
        f"{res['repulsion']:.4f} = {res['edge'] + res['repulsion']:.4f}; "
        f"iteration fused {its['fused']} separate {its['separate']} [{card}]")
    return res


def fused_path(graph, dev, card):
    """Path M: the fused pass (``ell_edge_apply``) at every dim of M_DIMS,
    both replicas, both sample modes, against the separate passes (M1),
    then timed beside them (M2) at dim 128 on the bench graph and on the
    1,048,576-vertex graph (its replica past the L2).  Returns (record,
    launch counts)."""
    errs, rec, total = [], {"M1": {}, "M2": {}}, {}
    for dim in M_DIMS:
        for gdt in M_GATHERS:
            for pv in (False, True):
                cfg = dataclasses.replace(
                    BENCH_CONFIG, dim=dim, gather_dtype=str(gdt)[6:],
                    per_vertex_samples=pv)
                fv = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH,
                                   device=dev)
                check(fv.fused_apply, f"path M: dim {dim} {gdt} does not "
                                      "engage the fused pass")
                what = (f"dim {dim} ({row_class(dim, gdt)}) "
                        f"{str(gdt)[6:]} replica "
                        f"{'-bs 1' if pv else 'group-shared'}")
                rec["M1"][what] = m_iterations(fv, what, errs)
                add_counts(total, read_counts())
                del fv
    for name, g in (("bench", graph), ("n 1,048,576", big_graph())):
        for pv in (False, True):
            cfg = dataclasses.replace(BENCH_CONFIG, per_vertex_samples=pv)
            fv = SyncForce2Vec(g, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
            what = f"{name} graph, dim 128, {'-bs 1' if pv else 'group'}"
            rec["M2"][what] = m_timing(fv, what, card)
            del fv
    for e in errs:
        say(f"M FAILED: {e}")
    check(not errs, f"path M: {len(errs)} failures: {errs}")
    # the kernels line's figures: the main path's shapes (the bench
    # graph, dim 128, group-shared negatives)
    main = rec["M2"]["bench graph, dim 128, group"]
    rec.update(max_abs_err=main["max_abs_err"], ms=main["ms"],
               queued_ms=main["fused"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"])
    return rec, total


# -- path N: the carried replica ------------------------------------------------


def carry_counts() -> dict:
    """The carried replica's counters and the replays, in the span
    registry since its last reset."""
    c = profiling.snapshot()["counters"]
    return {k: int(c.get(k, 0)) for k in ("replica.casts", "replica.carried",
                                          "span.replays")}


def cast_each_iteration(fv, x, its):
    """Iterations ``its`` of seed 1 on X in place, eagerly, each gathering
    from a fresh cast of X (``_replica``): the iteration before the
    carry."""
    for it in its:
        fv._span_gen.manual_seed(iteration_seed(1, it))
        negs, walks = fv._draw(fv._span_gen)
        fv._iteration(x, negs, walks, fv._step(it), plain=False)
    return x


def carry_runs(fv, what, replicas, errs) -> dict:
    """N1: ``fv``'s run_span with the carried replica, three ways, each
    from ``init_embedding(seed=1)`` on a new X, against
    ``cast_each_iteration``: one span of N_ITERS; N_ITERS spans of one
    (the benchmark's calls); two halves with X rewritten in place between
    them (``copy_`` of its own values: a new version, which must cast
    again).  Each bit for bit, the next replica ``x.to(gather_dtype)``,
    and the counters exact."""
    k = fv.replica_carry
    check(k == replicas, f"path N {what}: {k} replicas, not {replicas}")
    x0 = fv.init_embedding(seed=1)
    want = cast_each_iteration(fv, x0.clone(), range(N_ITERS))
    half = N_ITERS // 2
    rec = {}

    def one(x):
        fv.run_span(x, 1, N_ITERS)

    def each(x):
        for it in range(N_ITERS):
            fv.run_span(x, 1, 1, it)

    def rewritten(x):
        fv.run_span(x, 1, half)
        x.copy_(x.clone())
        fv.run_span(x, 1, N_ITERS - half, half)

    expect = {"one span": (1, N_ITERS - 1), "a span an iteration":
              (1, N_ITERS - 1), "X rewritten": (2, N_ITERS - 2)}
    for name, run in (("one span", one), ("a span an iteration", each),
                      ("X rewritten", rewritten)):
        profiling.reset()
        x = x0.clone()
        run(x)
        torch.cuda.synchronize()
        c = carry_counts()
        same = torch.equal(x, want)
        nxt = torch.equal(fv._replicas[N_ITERS % k], x.to(fv._gdt))
        casts, carried = expect[name]
        rec[name] = dict(same_bits=same, next_replica=nxt, **c)
        say(f"N1 {what}, {name}: X after {N_ITERS} iterations vs a cast "
            f"each iteration {'the same bits' if same else 'DIFFERENT'} "
            f"(max |err| {max_err(x, want):.3e}); next replica = cast "
            f"{nxt}; casts {c['replica.casts']}, carried "
            f"{c['replica.carried']}, replays {c['span.replays']}")
        if not same:
            errs.append(f"{what} {name}: X differs from a cast each "
                        "iteration")
        if not nxt:
            errs.append(f"{what} {name}: the next replica is not X's cast")
        if (c["replica.casts"], c["replica.carried"]) != (casts, carried):
            errs.append(f"{what} {name}: casts, carried {c} != "
                        f"{(casts, carried)}")
        if c["replica.carried"] != c["span.replays"] - (name == "X rewritten"):
            errs.append(f"{what} {name}: carried != replays: {c}")
    return rec


def carry_timing(fv, what, card) -> dict:
    """N2: queued, warm, in turns: the launches of ``fv``'s iteration that
    write X with the next replica's store and without, and the cast that
    the store replaces."""
    x0 = fv.init_embedding(seed=1)
    gen = torch.Generator(fv.device).manual_seed(3)
    negs, walks = fv._draw(gen)
    model, step, gdt = fv.model, fv.lr, fv._gdt
    x, xg = x0.clone(), x0.to(gdt)
    nxt = torch.empty_like(xg)
    if fv.fused_apply:
        group = 1 if fv.config.per_vertex_samples else fv.config.batch_size
        rest = (xg, *fv.apply_table, fv.inv_deg, negs, group, step)
        launch = {"store": lambda: fk.ell_edge_apply(model, x, *rest,
                                                     xg_next=nxt),
                  "none": lambda: fk.ell_edge_apply(model, x, *rest)}
    else:
        upd = fk.ell_edge_force(model, x, xg, walks, fv._walk_deg,
                                fv._all_rows, fv.inv_deg, step)
        sg = xg[negs.long()]
        group = fv.config.batch_size
        launch = {"store": lambda: fk.grouped_rep_force(
                      model, group, x, sg, step, mode="apply", upd=upd,
                      xg_next=nxt),
                  "none": lambda: fk.grouped_rep_force(
                      model, group, x, sg, step, mode="apply", upd=upd)}
    times = {"store": [], "none": []}
    for m in ("none", "store", "store", "none"):
        times[m].append(queued_device_ms(launch[m], reps=20))
    cast = queued_device_ms(lambda: x.to(gdt), reps=20)
    name = "ell_edge_apply" if fv.fused_apply else "grouped_rep_force apply"
    say(f"N2 {what}: {name} queued ms with the replica's store "
        f"{times['store']}, without {times['none']}; the cast "
        f"{cast:.4f} [{card}]")
    return {"launch": name, **times, "cast": cast}


def carry_path(graph, dev, card):
    """Path N: the carried replica (N1) at the bench graph and at
    com-Youtube's vertex count, and its stores timed there (N2).  Returns
    (record, launch counts)."""
    errs, rec = [], {"N1": {}, "N2": {}}
    reset_counts()
    big = synth_powerlaw_graph(n=WALK_BIG_N, avg_deg=WALK_BIG_DEG)
    for gname, g in (("bench", graph), (f"n={WALK_BIG_N}", big)):
        for what, kw, replicas in N_CONFIGS:
            fv = SyncForce2Vec(g, dataclasses.replace(BENCH_CONFIG, **kw),
                               MIN_WIDTH, HUB_WIDTH, device=dev)
            tag = f"{what} @ {gname}"
            rec["N1"][tag] = carry_runs(fv, tag, replicas, errs)
            if g is big:
                rec["N2"][tag] = carry_timing(fv, tag, card)
            del fv
    counts = read_counts()
    for e in errs:
        say(f"N FAILED: {e}")
    check(not errs, f"path N: {len(errs)} failures: {errs}")
    return rec, counts


# -- path L: run_span and train() as a CUDA graph --------------------------------


def l_runs(fv, x0):
    """From ``x0`` (``init_embedding(seed=1)``): two eager runs of L_ITERS
    iterations (``_run_span_eager``), ``train()`` (the graph: a capture on
    its own X, then replays) and ``run_span`` in spans of L_SPANS on a new
    X, with each run's launch counts.  Returns (eager Xs, train's [n, dim]
    embedding, the spans' X, what the spans are held to, counts): the
    first eager run, or with ``halo_stale``, where each span primes its
    first iteration's exchange, the eager loop in the same spans."""
    eager, counts = [], []
    for _ in range(2):
        reset_counts()
        x = x0.clone()
        fv._run_span_eager(x, 1, L_ITERS)
        eager.append(x)
        counts.append(read_counts())
    reset_counts()
    emb = fv.train(iters=L_ITERS, seed=1)
    counts.append(read_counts())
    xs, done = x0.clone(), 0
    reset_counts()
    for k in L_SPANS:
        fv.run_span(xs, 1, k, done)
        done += k
    counts.append(read_counts())
    want = eager[0]
    if getattr(fv, "halo_stale", False):
        want, done = x0.clone(), 0
        for k in L_SPANS:
            fv._run_span_eager(want, 1, k, done)
            done += k
    return eager, emb, xs, want, counts


@contextlib.contextmanager
def deterministic():
    """torch's deterministic mode, with uninitialised memory left
    unfilled, as the default mode leaves it."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def l_check(fv, what, errs, card) -> dict:
    """Path L's checks of one configuration (``l_runs``) in torch's
    default mode, and for the sync schedule again under
    ``deterministic``: ``train()`` and the spans against the eager loop,
    and the two eager runs, bit for bit; the same launch counts in all
    four runs; X finite.  Failures go to ``errs``.  Returns the default
    mode's record, the deterministic mode's under ``deterministic``."""
    x0 = fv.init_embedding(seed=1)
    sync = isinstance(fv, SyncForce2Vec)
    recs = {}
    for mode in ("default", "deterministic") if sync else ("default",):
        with deterministic() if mode == "deterministic" else (
                contextlib.nullcontext()):
            eager, emb, xs, want, counts = l_runs(fv, x0)
        fv.span_graph.reset()  # captured in this mode
        spread = max_err(eager[0], eager[1])
        held = (" (the eager loop in those spans)" if want is not eager[0]
                else "")
        e_train = max_err(emb, fv.unpad_embedding(eager[0]))
        e_spans = max_err(xs, want)
        g = fv.span_graph
        recs[mode] = dict(
            eager_spread=spread, train_vs_eager=e_train,
            spans_vs_eager=e_spans, moved=max_err(eager[0], x0),
            launches=counts[0], launches_per_replay=g.counts,
            capture_s=g.capture_seconds, pool_mb=g.pool_bytes / 2**20,
            captures=g.captures)
        say(f"L {what}: {L_ITERS} iterations ({mode} mode), eager vs eager "
            f"{spread:.3e}, train() (graph) vs eager {e_train:.3e}, "
            f"run_span in spans {L_SPANS} vs eager{held} {e_spans:.3e} "
            f"(X moved up to {recs[mode]['moved']:.3e}); "
            f"launches {nonzero(counts[0])}, per replay {g.counts}; "
            f"{g.captures} captures, the last {g.capture_seconds:.3f} s, "
            f"graph pool {recs[mode]['pool_mb']:.1f} MB [{card}]")
        for name, e in (("eager", spread), ("train()", e_train),
                        ("spans", e_spans)):
            if e != 0.0:
                errs.append(f"{what} ({mode} mode): {name} vs eager "
                            f"{e:.3e}, not bit for bit")
        if any(c != counts[0] for c in counts):
            errs.append(f"{what} ({mode} mode): launch counts differ: "
                        f"{counts}")
        if not (bool(torch.isfinite(emb).all())
                and bool(torch.isfinite(xs).all())):
            errs.append(f"{what} ({mode} mode): X is not finite")
    rec = recs["default"]
    if sync:
        rec["deterministic"] = recs["deterministic"]
    return rec


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def l_stale_step(fv, reseed):
    """A planted fault: a graph span's host step that writes the step
    buffer at its first iteration and never again (and re-seeds the draws
    with ``reseed(seed, it)``)."""
    written = []

    def prepare(seed, it):
        if not written:
            fv._step_buf.write(fv._step(it))
            written.append(it)
        reseed(seed, it)
    return prepare


def l_stale_draws(fv, gen):
    """A planted fault: a captured iteration that reads the negatives (and
    walks) of iteration 0, drawn once outside the graph, at every replay."""
    gen.manual_seed(iteration_seed(1, 0))
    negs, walks = fv._draw(gen)
    if isinstance(fv, SyncForce2Vec):
        return lambda x: fv._iteration(x, negs, walks, fv._step_buf.tensor,
                                       plain=False)
    return lambda x: fv._iteration(x, negs, walks, fv._step_buf.tensor)


def l_faults(graph, small, dev, card, errs) -> dict:
    """The planted faults, each on a fresh trainer of the three
    schedules: the step buffer not refreshed (fr, decay999; the sync, batch
    and vertex schedules) and the negatives not redrawn (tdist; sync and
    batch).  Each must move X off the eager run, which path L holds the
    graph to bit for bit."""
    out = {}
    for what, make in (
            ("sync fr", lambda: SyncForce2Vec(
                graph, dataclasses.replace(BENCH_CONFIG, model="fr"),
                MIN_WIDTH, HUB_WIDTH, device=dev)),
            ("sync tdist", lambda: SyncForce2Vec(
                graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev)),
            ("batch fr", lambda: Force2Vec(
                small, dataclasses.replace(L_BATCH_CONFIG, model="fr"),
                device=dev)),
            ("batch tdist", lambda: Force2Vec(small, L_BATCH_CONFIG,
                                              device=dev)),
            ("vertex fr", lambda: VertexShardedForce2Vec(
                graph, dataclasses.replace(vertex_cfg(), model="fr"),
                min_width=MIN_WIDTH, hub_width=HUB_WIDTH, device=dev))):
        fv = make()
        vertex = isinstance(fv, VertexShardedForce2Vec)
        gen = (fv._gen if isinstance(fv, Force2Vec) else fv._span_gen)
        x0 = fv.init_embedding(seed=1)
        e1, x = x0.clone(), x0.clone()
        reseed = (fv._seed if vertex else
                  lambda seed, it: gen.manual_seed(iteration_seed(seed, it)))
        fault, name = ((l_stale_step(fv, reseed), "step not refreshed")
                       if "fr" in what else
                       (l_stale_draws(fv, gen), "negatives not redrawn"))
        if "fr" in what:
            fv.span_graph._prepare = fault
        else:
            fv.span_graph._bodies = (fault,)
        fv._run_span_eager(e1, 1, L_ITERS)
        fv.run_span(x, 1, L_ITERS)
        e = max_err(x, e1)
        out[f"{what}: {name}"] = e
        say(f"L planted fault, {what}, {name}: graph vs eager {e:.3e} "
            f"({'caught' if e > 0.0 else 'MISSED'})")
        if not e > 0.0:
            errs.append(f"planted fault {what} {name} not caught")
    return out


def l_timing(fv, what, card) -> dict:
    """The graph against the eager loop on one trainer, in turns (eager,
    graph, graph, eager): back-to-back ms per iteration (CUDA events over
    a span), host enqueue ms per iteration, queued device ms per iteration
    (the eager batch schedule cannot be queued: its enqueue outlasts the
    sleep), a profiled window of each, the capture's seconds and pool, and
    the eager iteration's peak of allocated memory."""
    sync = not isinstance(fv, Force2Vec)  # the sync or vertex schedule
    n = L_ITERS if sync else 3
    x = fv.init_embedding(seed=1)
    fv.span_graph.reset()
    fv.run_span(x, 1, 1)  # the capture on x
    run = {"graph": lambda k: fv.run_span(x, 1, k, 1),
           "eager": lambda k: fv._run_span_eager(x, 1, k, 1)}
    res = {"b2b_ms": {"graph": [], "eager": []},
           "enqueue_ms": {"graph": [], "eager": []}}
    for mode in ("eager", "graph", "graph", "eager"):
        res["b2b_ms"][mode].append(
            cuda_ms(lambda: run[mode](n), reps=1, warmup=1) / n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run[mode](n)
        res["enqueue_ms"][mode].append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
    res["queued_ms"] = {
        "graph": queued_device_ms(lambda: run["graph"](1),
                                  reps=10 if sync else 2),
        "eager": (queued_device_ms(lambda: run["eager"](1), reps=10)
                  if sync else None)}
    res["profile"] = {mode: profile_window(lambda: run[mode](n), n)[0]
                      for mode in ("graph", "eager")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run["eager"](1)
    torch.cuda.synchronize()
    res["eager_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    g = fv.span_graph
    res["capture_s"], res["pool_mb"] = g.capture_seconds, g.pool_bytes / 2**20
    prof = res["profile"]
    say(f"L timing {what}: ms/iteration back to back graph "
        f"{res['b2b_ms']['graph']} eager {res['b2b_ms']['eager']}; host "
        f"enqueue graph {res['enqueue_ms']['graph']} eager "
        f"{res['enqueue_ms']['eager']}; queued graph "
        f"{res['queued_ms']['graph']} eager {res['queued_ms']['eager']}; "
        f"host launches/iteration graph {prof['graph']['host_launches']:.1f} "
        f"eager {prof['eager']['host_launches']:.1f}; device busy graph "
        f"{prof['graph']['busy_ms']:.4f} eager {prof['eager']['busy_ms']:.4f}"
        f", idle share graph {prof['graph']['idle_share']} eager "
        f"{prof['eager']['idle_share']}; capture {res['capture_s']:.3f} s, "
        f"graph pool {res['pool_mb']:.1f} MB, eager peak "
        f"{res['eager_peak_mb']:.1f} MB [{card}]")
    for mode in ("graph", "eager"):
        kernels = {name[:48]: round(k["ms_per_iter"], 5)
                   for name, k in prof[mode].pop("kernels").items()
                   if "f2v" in name}
        say(f"L timing {what} {mode}, our kernels' device ms/iteration: "
            f"{json.dumps(kernels)} [{card}]")
    return res


def graph_path(graph, dev, card):
    """Path L: every single-card configuration of the three schedules,
    its ``train()`` and ``run_span`` (the CUDA graph) against the eager
    loop (``l_check``), the planted faults (``l_faults``), and the timed
    configurations (``l_timing``).  Returns (record, launch counts)."""
    small = synth_powerlaw_graph(**SMALL_GRAPH)
    graphs = {"bench": graph, "small": small,
              "exact": synth_powerlaw_graph(**EXACT_GRAPH)}
    errs, rec, total = [], {"configs": {}, "timing": {}}, {}
    for what, kw in L_SYNC:
        fv = SyncForce2Vec(graph, dataclasses.replace(BENCH_CONFIG, **kw),
                           MIN_WIDTH, HUB_WIDTH, device=dev)
        r = rec["configs"][what] = l_check(fv, what, errs, card)
        add_counts(total, r["launches"])
        if what in L_TIMED:
            rec["timing"][what] = l_timing(fv, what, card)
        del fv
    for what, vkw, kw in L_VERTEX:
        fv = VertexShardedForce2Vec(
            graph, dataclasses.replace(vertex_cfg(), **kw),
            min_width=MIN_WIDTH, hub_width=HUB_WIDTH, device=dev, **vkw)
        r = rec["configs"][what] = l_check(fv, what, errs, card)
        add_counts(total, r["launches"])
        if what in L_TIMED:
            rec["timing"][what] = l_timing(fv, what, card)
        del fv
    for what, kw, g in L_BATCH:
        fv = Force2Vec(graphs[g], dataclasses.replace(L_BATCH_CONFIG, **kw),
                       device=dev)
        rec["configs"][what] = l_check(fv, what, errs, card)
        if what in L_TIMED:
            rec["timing"][what] = l_timing(fv, what, card)
        del fv
    rec["faults"] = l_faults(graph, small, dev, card, errs)
    for e in errs:
        say(f"L FAILED: {e}")
    check(not errs, f"path L: {len(errs)} failures: {errs}")
    return rec, total


def path_l_process():
    """Path L as ``--path L`` in a fresh process (its profiled windows
    read the device's kernels, as path J's do).  Echoes its L lines;
    returns (its record, its launch counts)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--path", "L"], capture_output=True, text=True,
                         timeout=900)
    lines = res.stdout.splitlines()
    for line in lines:
        if line.startswith(("L ", "path L")):
            say(line)
    check(res.returncode == 0,
          f"path L exited {res.returncode}: {res.stderr[-4000:]}")
    rec = json.loads(lines[-2])
    return rec["graph"], rec["path_L_launches"]


def path_j_process():
    """Path J as ``--path J`` in a fresh process: in a process that has
    run the other paths the profiler records no device kernel, and J3
    reads them.  Echoes its J lines; returns (its record, its launch
    counts)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--path", "J"], capture_output=True, text=True,
                         timeout=600)
    lines = res.stdout.splitlines()
    for line in lines:
        if line.startswith(("J", "path J")):
            say(line)
    check(res.returncode == 0,
          f"path J exited {res.returncode}: {res.stderr[-4000:]}")
    rec = json.loads(lines[-2])
    return rec["rep_modes"], rec["path_J_launches"]


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
    names = [line.split(":")[0] for line in ptxas]
    missing = [k for k in MAIN_INSTANCES if k not in names]
    check(not missing, f"main-path instances missing from the ptxas report: "
                       f"{missing}")
    spilling = [line for line in ptxas
                if (line.split(":")[0] in RING_INSTANCES
                    or line.startswith(FORCE_KERNELS))
                and " 0 bytes spill stores" not in line]
    check(not spilling, f"force-kernel or ring instances spill: {spilling}")
    force = [n for n in names if n.startswith(FORCE_KERNELS)]
    f16 = [n for n in force if re.search(r"[<, ]f16[,>]", n)]
    say(f"build: {len(force)} force-kernel instances, {len(f16)} of them "
        f"with f16 X or f16 gathers; none spills")
    others = [line.split(":")[0] for line in ptxas
              if " 0 bytes spill stores" not in line]
    say(f"instances that spill (probes on no training path): "
        f"{others or 'none'}")
    missing = [k for k in RING_INSTANCES
               if not any(line.startswith(k + ":") for line in ptxas)]
    check(not missing, f"ring instances missing from the ptxas report: "
                       f"{missing}")

    graph = synth_powerlaw_graph()
    if sys.argv[1:] == ["--path", "B"]:
        t0 = time.perf_counter()
        counts, walk = rwalk_path(graph, dev, card)
        say(f"path B (rwalk): {time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_B_launches": counts, "walk_steps": walk}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "M"]:
        t0 = time.perf_counter()
        rec, counts = fused_path(graph, dev, card)
        say(f"path M (the fused pass): {time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_M_launches": counts, "fused": rec}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "N"]:
        t0 = time.perf_counter()
        rec, counts = carry_path(graph, dev, card)
        say(f"path N (the carried replica): {time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_N_launches": counts, "carry": rec}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "L"]:
        t0 = time.perf_counter()
        rec, counts = graph_path(graph, dev, card)
        say(f"path L (train() as a CUDA graph): "
            f"{time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_L_launches": counts, "graph": rec}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "J"]:
        t0 = time.perf_counter()
        rec, counts = rep_modes_path(graph, dev, card)
        say(f"path J (repulsion modes): {time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_J_launches": counts, "rep_modes": rec}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "K"]:
        t0 = time.perf_counter()
        rec, counts, timing = x_f16_path(graph, dev, card)
        say(f"path K (f16 X and the f16 replica): "
            f"{time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_K_launches": counts, "x_f16": rec,
                        "timing": {str(k): v for k, v in timing.items()}}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "I"]:
        t0 = time.perf_counter()
        rec, counts, timing = x_bf16_path(graph, dev, card)
        say(f"path I (bf16 X): {time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_I_launches": counts, "x_bf16": rec,
                        "timing": {str(k): v for k, v in timing.items()}}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "G"]:
        t0 = time.perf_counter()
        counts, classes = widths_path(graph, dev, card)
        say(f"path G (every width): {time.perf_counter() - t0:.1f} s")
        say(json.dumps({"path_G_launches": counts, "row_classes": classes}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--path", "F"]:
        with tempfile.TemporaryDirectory() as tmp:
            mtx = os.path.join(tmp, "bench.mtx")
            write_mtx(graph, mtx)
            counts, dp, tp, _ = vertex_path(graph, dev, card, mtx, tmp,
                                            float("nan"))
        say(json.dumps({"path_F_launches": counts, "dp": dp, "tp": tp}))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.perf_counter()
    edge, rep, counts_main, buckets, main_q_ms = main_path(graph, dev, card)
    say(f"main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sample, counts_pv = per_vertex_path(graph, dev, card)
    say(f"path A (-bs 1): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_rw, walk = rwalk_path(graph, dev, card)
    say(f"path B (rwalk): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_probes = probes_path(graph, dev, card, buckets)
    measured = {"take_sum": take_sum_phase(dev, card),
                "tile_force_tc": tile_force_tc_phase(graph, dev, card),
                "resident_gather": resident_gather_phase(dev, card),
                "read_sum": read_sum_phase(graph, dev, card)}
    say(f"path C (probes): {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        counts_file = file_path(graph, dev, card, tmp)
        say(f"path D (file): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        counts_cli, batch, ms64, sigmoid_ms = cli_path(
            graph, os.path.join(tmp, "bench.mtx"), dev, card)
        say(f"path E (command line): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        counts_vertex, counts_dp, counts_tp, tp_rec = vertex_path(
            graph, dev, card, os.path.join(tmp, "bench.mtx"), tmp, main_q_ms)
        say(f"path F (vertex and sharded schedules): "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_widths, classes = widths_path(graph, dev, card)
    say(f"path G (every width): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    x_bf16, counts_bf16, x_bf16_timing = x_bf16_path(graph, dev, card)
    say(f"path I (bf16 X): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    x_f16, counts_f16, x_f16_timing = x_f16_path(graph, dev, card)
    say(f"path K (f16 X and the f16 replica): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fused, counts_fused = fused_path(graph, dev, card)
    say(f"path M (the fused pass): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, counts_carry = carry_path(graph, dev, card)
    say(f"path N (the carried replica): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rep["modes"], counts_modes = path_j_process()
    say(f"path J (repulsion modes, --path J): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graph_rec, counts_graph = path_l_process()
    say(f"path L (train() as a CUDA graph, --path L): "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"train() as a CUDA graph, timed: {json.dumps(graph_rec['timing'])} "
        f"[{card}]")
    timing = {str(k): v for k, v in x_bf16_timing.items()}
    say(f"bf16 X timing: {json.dumps(timing)} [{card}]")
    timing = {str(k): v for k, v in x_f16_timing.items()}
    say(f"f16 X and f16 replica timing: {json.dumps(timing)} [{card}]")
    say(f"batch schedule (bench graph, -batch 256 -dim 128): "
        f"{json.dumps(batch)} [{card}]")

    paths = {"main": counts_main, "per_vertex": counts_pv,
             "rwalk": counts_rw, "probes": counts_probes,
             "file": counts_file, "cli": counts_cli,
             "vertex": counts_vertex, "dp": counts_dp, "tp": counts_tp,
             "widths": counts_widths,
             "x_bf16": counts_bf16, "x_f16": counts_f16,
             "rep_modes": counts_modes, "graph": counts_graph,
             "fused": counts_fused, "carry": counts_carry}
    for name, m in (("ell_edge_force", edge), ("grouped_rep_force", rep),
                    ("ell_sample_force", sample)):
        (m["queued_ms_dim64"], m["bound_ms_dim64"],
         m["plain_ms_dim64"]) = ms64[name][:3]
        (m["queued_ms_sigmoid_table"], _,
         m["plain_ms_sigmoid_table"]) = sigmoid_ms["table"][name][:3]
        m["queued_ms_sigmoid_exact"] = sigmoid_ms["exact"][name][0]
    for name, m in (("ell_edge_force", edge), ("grouped_rep_force", rep),
                    ("ell_sample_force", sample), *tp_rec.items()):
        m["row_classes"] = classes[name]
        m["x_bf16"] = x_bf16[name]
        m["x_f16"] = x_f16[name]

    def entry(name, source, replaces, measured):
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "library_ms": None, **measured}

    say(json.dumps({"kernels": [
        entry("ell_edge_force", EDGE_SOURCE, EDGE_REPLACES, edge),
        entry("grouped_rep_force", REP_SOURCE, REP_REPLACES, rep),
        entry("ell_sample_force", SAMPLE_SOURCE, SAMPLE_REPLACES, sample),
        entry("ell_edge_apply", APPLY_SOURCE, APPLY_REPLACES, fused),
        entry("walk_steps", WALK_SOURCE, WALK_REPLACES, walk),
    ] + [entry(name, *PROBES[name], m) for name, m in measured.items()]
      + [entry(name, TP_SOURCE, TP_REPLACES, m)
         for name, m in tp_rec.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
