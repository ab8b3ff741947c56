"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py        # from the repository root, one card

Drives ``force2vec_tpu_torch``'s main path — the sync tForce2Vec trainer at
the ``bench.py`` configuration (131,072-vertex power-law graph, dim 128,
ns 5, 256-row negative groups, bf16 gathers, min_width 8, hub_width 128):

1. checks for a card and prints its name and power limit;
2. builds the CUDA kernels from ``force2vec_tpu_torch/ops/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, elementwise and for every separable
   model, and times both; then shows that the same bound rejects two
   planted faults;
4. runs one iteration through the kernels and through the plain versions
   from the same X and negatives, and times both;
5. trains 50 iterations through the kernels, checks the launch counts, that
   X is finite, and that edges end closer than random pairs.

Every phase raises on failure, so any failure exits non-zero.  The line
before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import re
import sys
import time

import numpy as np
import torch

from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.models.forces import MAXBOUND, get_model
from force2vec_tpu_torch.ops import _build, force_kernels as fk
from force2vec_tpu_torch.tools import (BENCH_CONFIG, HUB_WIDTH, MIN_WIDTH,
                                      card_name_and_power, cuda_ms,
                                      queued_device_ms)
from force2vec_tpu_torch.train.sync import SyncForce2Vec

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
# be exactly 0.  ``planted_fault_phase`` shows it rejects 1%-size faults.
EDGE_TOL = 1e-4
REP_TOL = 1e-5
SUM_RTOL = 1e-5
ITER_TOL = 1e-3  # bench.py's on-chip kernel-vs-plain bound
# Mean random-pair minus mean edge distance after 50 iterations must exceed
# this: half of the 0.8205 that the JAX package reaches on the CPU with the
# same configuration, graph and pair sample (PERF.md §9.6).
QUALITY_MARGIN = 0.41
QUALITY_PAIRS = 100_000

EDGE_SOURCE = "force2vec_tpu_torch/ops/csrc/ell_edge_force.cu"
REP_SOURCE = "force2vec_tpu_torch/ops/csrc/grouped_rep_force.cu"
EDGE_REPLACES = "force2vec_tpu/ops/pallas_force.py:218"
REP_REPLACES = "force2vec_tpu/ops/pallas_force.py:103"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def say(*args):
    print(*args, flush=True)


def ptxas_summary(log: str) -> list:
    """One line per kernel instance from nvcc's ``-Xptxas=-v`` output:
    ``kernel<replica, lanes' elements, model>: registers; spills``."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d([a-z_]+_kernel)I(\w+?)EEEv",
                      line)
        if m:
            args = re.sub(r"Li(\d+)E?", r", \1", m[2])
            args = args.replace("13__nv_bfloat16", "bf16")
            name, spill = f"{m[1]}<{re.sub('^f,', 'f32,', args)}>", ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def bound_ratio(got, terms) -> float:
    """max over elements of |got - Σ terms| / (SUM_RTOL · Σ |terms|), the
    sums over dim 1; at most 1 passes.  An element whose terms are all 0
    gives inf unless ``got`` is exactly 0 there."""
    err = (got - terms.sum(dim=1)).abs()
    scale = SUM_RTOL * terms.abs().sum(dim=1)
    return float(torch.where(err == 0, 0.0, err / scale).max())


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


def edge_phase(fv, x, xg, card):
    """Edge kernel vs plain for every bucket of the bench layout."""
    err = k_ms = p_ms = 0.0
    for b in fv.device_buckets:
        kind = "hub" if b.owner_local is not None else "bucket"
        what = f"{kind} width {b.nbr.shape[1]}"
        e, ratio = check_edge(fv.model, x, xg, b, fv.inv_deg, fv.lr, what)
        check(e <= EDGE_TOL, f"ell_edge_force {what}: max |err| {e:.3e} > "
                             f"{EDGE_TOL}")
        args = (fv.model, x, xg, b.nbr, b.deg, b.xi_row, fv.inv_deg, fv.lr)
        km = cuda_ms(lambda: fk.ell_edge_force(*args))
        pm = cuda_ms(lambda: fk.ell_edge_force_plain(*args), reps=3)
        say(f"ell_edge_force {kind} width={b.nbr.shape[1]} rows="
            f"{b.nbr.shape[0]} max_abs_err={e:.3e} bound_ratio={ratio:.4f} "
            f"kernel_ms={km:.4f} plain_ms={pm:.4f} [{card}]")
        err, k_ms, p_ms = max(err, e), k_ms + km, p_ms + pm
    return err, k_ms, p_ms


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
    say(f"grouped_rep_force rows={x.shape[0]} groups={sg.shape[0]} "
        f"max_abs_err={e:.3e} bound_ratio={ratio:.4f} kernel_ms={km:.4f} "
        f"plain_ms={pm:.4f} [{card}]")
    return e, km, pm


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


def planted_fault_phase(fv, x, xg):
    """The elementwise bound rejects plausible kernel faults."""
    rep_ratio, edge_ratio = planted_fault_ratios(
        fv.model, BENCH_CONFIG.batch_size, x, xg, widest_bucket(fv),
        fv.inv_deg, bench_samples(fv, xg, seed=5), fv.lr)
    say(f"planted faults: repulsion 2/r^2 bound_ratio={rep_ratio:.2f}, "
        f"attraction with bf16 x_i bound_ratio={edge_ratio:.2f} (must be > 1)")
    check(rep_ratio > 1.0, "the bound passed a repulsion with 2/r^2")
    check(edge_ratio > 1.0, "the bound passed an attraction with bf16 x_i")


def iteration_phase(fv, x0, card):
    """One iteration through the kernels and through the plain versions."""
    ng = -(-fv.layout.n_pad // BENCH_CONFIG.batch_size)
    negs = np.random.default_rng(7).integers(
        0, fv.graph.n - 1, size=(ng, BENCH_CONFIG.ns)).astype(np.int32)
    a = fv.run_iteration(x0.clone(), negs)
    b = fv.run_iteration(x0.clone(), negs, plain=True)
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
            lambda: fv.run_iteration(xw, negs_t, plain=mode == "plain"),
            reps=10 if mode == "kernels" else 3))
    k_ms, p_ms = np.mean(times["kernels"]), np.mean(times["plain"])
    say(f"iteration_ms kernels={times['kernels']} plain={times['plain']} "
        f"[{card}]")
    # the same iterations queued ahead of the device: the time once the
    # host's launch cost, which varies with the host's load, is out of it
    q_ms = queued_device_ms(lambda: fv.run_iteration(xk, negs_t), reps=10)
    say(f"iteration_ms kernels queued ahead of the device={q_ms:.4f} "
        f"[{card}]")
    return k_ms, p_ms


def quality(graph, emb):
    dev = emb.device
    src = torch.repeat_interleave(
        torch.arange(graph.n, device=dev),
        torch.as_tensor(graph.degrees, device=dev))
    dst = torch.as_tensor(graph.colids, device=dev).long()
    emb = emb.double()
    d_edge = float((emb[src] - emb[dst]).norm(dim=1).mean())
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(0, graph.n, QUALITY_PAIRS), device=dev)
    b = torch.as_tensor(rng.integers(0, graph.n, QUALITY_PAIRS), device=dev)
    d_rand = float((emb[a] - emb[b]).norm(dim=1).mean())
    return d_edge, d_rand


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
    for line in ptxas_summary(lib_path.with_suffix(".log").read_text()):
        say(f"  ptxas: {line}")

    t0 = time.perf_counter()
    graph = synth_powerlaw_graph()
    fv = SyncForce2Vec(graph, BENCH_CONFIG, MIN_WIDTH, HUB_WIDTH, device=dev)
    lay = fv.layout
    say(f"graph n={graph.n} nnz={graph.nnz} n_pad={lay.n_pad} "
        f"padded_slots={lay.padded_edges} buckets={len(lay.buckets)} "
        f"hub_rows={sum(b.count for b in lay.buckets if b.owners is not None)}"
        f" setup_s={time.perf_counter() - t0:.2f}")
    edge_launches = len(fv.device_buckets)

    x0 = fv.init_embedding(seed=1)
    xg = x0.to(torch.bfloat16)
    edge_err, edge_ms, edge_plain_ms = edge_phase(fv, x0, xg, card)
    rep_err, rep_ms, rep_plain_ms = rep_phase(fv, x0, xg, card)
    other_models_phase(fv, x0, xg)
    planted_fault_phase(fv, x0, xg)
    iter_ms, iter_plain_ms = iteration_phase(fv, x0, card)
    updates = graph.nnz + graph.n * BENCH_CONFIG.ns  # bench.py:158-161
    say(f"ms_per_iteration kernels={iter_ms:.4f} plain={iter_plain_ms:.4f} "
        f"(CUDA events) [{card}]")
    say(f"edge_force_updates_per_s kernels={updates / iter_ms / 1e3:.2f} M "
        f"plain={updates / iter_plain_ms / 1e3:.2f} M [{card}]")

    fk.reset_launch_counts()
    emb = fv.train(iters=TRAIN_ITERS, seed=1)
    counts = dict(fk.launch_counts)
    train_ms = fv.last_train_seconds * 1e3 / TRAIN_ITERS
    say(f"train {TRAIN_ITERS} iterations: {fv.last_train_seconds:.3f} s, "
        f"{train_ms:.4f} ms/iteration (host clock), launches {counts} "
        f"[{card}]")
    check(counts["ell_edge_force"] == TRAIN_ITERS * edge_launches,
          f"ell_edge_force launches {counts['ell_edge_force']} != "
          f"{TRAIN_ITERS} x {edge_launches}")
    check(counts["grouped_rep_force"] == TRAIN_ITERS,
          f"grouped_rep_force launches {counts['grouped_rep_force']} != "
          f"{TRAIN_ITERS}")
    check(tuple(emb.shape) == (graph.n, BENCH_CONFIG.dim),
          f"embedding shape {tuple(emb.shape)}")
    check(bool(torch.isfinite(emb).all()), "trained X is not finite")
    d_edge, d_rand = quality(graph, emb)
    say(f"quality after {TRAIN_ITERS} iterations: mean edge distance "
        f"{d_edge:.4f}, mean random-pair distance {d_rand:.4f}, gap "
        f"{d_rand - d_edge:.4f} (needs > {QUALITY_MARGIN})")
    check(d_rand - d_edge > QUALITY_MARGIN, "edges are not closer than "
          "random pairs by the margin")

    say(json.dumps({"kernels": [
        {"name": "ell_edge_force", "route": "cuda", "source": EDGE_SOURCE,
         "replaces": EDGE_REPLACES, "launches": counts["ell_edge_force"],
         "max_abs_err": edge_err, "ms": edge_ms, "plain_ms": edge_plain_ms},
        {"name": "grouped_rep_force", "route": "cuda", "source": REP_SOURCE,
         "replaces": REP_REPLACES, "launches": counts["grouped_rep_force"],
         "max_abs_err": rep_err, "ms": rep_ms, "plain_ms": rep_plain_ms},
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
