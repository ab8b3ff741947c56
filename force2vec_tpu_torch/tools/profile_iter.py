"""Where one sync or vertex iteration's time goes, at the bench
configuration.

    python3 -m force2vec_tpu_torch.tools.profile_iter [--iters 20]
        [--schedule sync|vertex]
        [--model tdist|sigmoid|rwalk|fr|linlog|forceatlas] [--per-vertex]
        [--n 131072] [--dim 128]
        [--dtype float32|bfloat16|float16]
        [--gather-dtype float32|bfloat16|float16] [--trace PATH]
        [--json PATH]

Needs one CUDA card.  Builds the same ``SyncForce2Vec`` as ``chip_smoke.py``
(``bench.py``'s graph and TrainConfig, with ``--model`` in place of tdist,
with ``--per-vertex`` ``-bs 1`` negatives, with ``--n`` the graph's
vertex count, as ``bench.py``'s ``BENCH_N``, and with ``--dim`` the
embedding width, any from 1 to ``force_kernels.KERNEL_MAX_DIM``, and with
``--dtype`` X's dtype: float32, the default, or bfloat16 or float16, and
with ``--gather-dtype`` the gather replica's: by default the bench's bf16
replica for an f32 X and X itself for the others, no cast;
``SyncForce2Vec._replica`` says what the other pairs gather) and measures,
on the kernel path, an iteration as ``run_iteration`` runs it and as
``train()`` runs it (for walk models, the walk engine's draw included).
With ``--schedule vertex`` it builds ``VertexShardedForce2Vec`` at P = 1
(one card, no process group) on the same graph and configuration instead
(``--per-vertex``: its ``pool`` sampling, as the CLI's ``-bs 1``; X's own
dtype is gathered, and ``--gather-dtype`` is refused; its layout's stats
are printed); its eager iteration is ``_iteration`` on fixed pool ids (and choices, and walks drawn each time),
as F1 of ``chip_smoke.py`` times it, and ``span_*`` its ``run_span``:

* three times each, since the host's speed varies from one moment to the
  next, for ``run_iteration`` (eager launches, injected negatives) and for
  ``run_span`` (what ``train()`` runs: one CUDA graph replay an iteration,
  drawing its own negatives; ``span``): ``ms_per_iter``, CUDA events over
  back-to-back iterations; ``host_enqueue_ms``, host time to enqueue one
  iteration, without a sync; ``queued_device_ms``, CUDA events over
  iterations queued behind a sleep kernel, so that the device never waits
  for the host: the iteration's time once launches are free;
* ``edge_wrapper_host_us``: host time of the iteration's one
  ``ell_edge_force`` call: over the layout's work table, or over the walk
  table (its checks, the device guard, the ctypes launch);
* ``device`` (``run_iteration``) and ``span_device`` (``run_span``): from
  ``torch.profiler``, each device kernel's time and launches per
  iteration, their sum ``busy_ms`` per iteration, the profiled wall time
  per iteration, ``idle_share = 1 - busy / wall``, and the host's launch
  calls per iteration (``host_launches``: kernel and graph launches,
  async copies and fills, ``LAUNCH_APIS``);
* ``edge_g_rows_per_s``: the edge kernel's neighbour rows (the graph's
  edges, or the walks' steps) per second of its device time.

Every line names the card and its power limit.  ``--trace`` writes the
profiler's Chrome trace of the ``run_span`` window; ``--json`` writes the
numbers.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from force2vec_tpu_torch.dist.vertex_sharded import VertexShardedForce2Vec
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.tools import (BENCH_CONFIG, HUB_WIDTH, MIN_WIDTH,
                                      card_name_and_power, cuda_ms,
                                      queued_device_ms)
from force2vec_tpu_torch.train.sync import SyncForce2Vec

# the host's launch calls a profiled window counts
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")


def host_ms(fn, reps: int) -> float:
    """Mean host ms per call of ``fn``, without waiting for the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_breakdown(prof, iters: int) -> dict:
    """Per-kernel device ms and launches per iteration from the profiler's
    device events."""
    ms = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name] += e.time_range.elapsed_us() / 1e3 / iters
            calls[e.name] += 1 / iters
    return {name: {"ms_per_iter": ms[name], "launches_per_iter": calls[name]}
            for name, _ in ms.most_common()}


def profile_window(fn, iters: int) -> dict:
    """``fn`` (``iters`` iterations) under ``torch.profiler``: each device
    kernel's ms and launches per iteration (``device_breakdown``), their
    sum ``busy_ms``, the window's wall ms per iteration, the idle share
    and the host's launch calls per iteration (``LAUNCH_APIS``)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kernels = device_breakdown(prof, iters)
    busy = sum(k["ms_per_iter"] for k in kernels.values())
    launches = sum(1 for e in prof.events() if e.name in LAUNCH_APIS)
    return {"kernels": kernels, "busy_ms": busy, "profiled_wall_ms": wall,
            "idle_share": 1.0 - busy / wall if kernels else None,
            "host_launches": launches / iters}, prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--schedule", default="sync", choices=("sync", "vertex"))
    ap.add_argument("--model", default=BENCH_CONFIG.model)
    ap.add_argument("--per-vertex", action="store_true")
    ap.add_argument("--n", type=int, default=131072,
                    help="vertices of the synthetic graph (bench.py's BENCH_N)")
    ap.add_argument("--dim", type=int, default=BENCH_CONFIG.dim,
                    help="embedding width (the kernels' rows are it "
                    "rounded up to 8)")
    ap.add_argument("--dtype", default="float32",
                    choices=[str(d).split(".")[1] for d in fk.X_DTYPES],
                    help="X's dtype (TrainConfig.dtype)")
    ap.add_argument("--gather-dtype", default=None,
                    choices=[str(d).split(".")[1] for d in fk.X_DTYPES],
                    help="the gather replica's dtype (TrainConfig."
                    "gather_dtype; default: bfloat16 for an f32 X, else "
                    "X itself)")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_iter: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power()
    print(card, flush=True)
    vertex = args.schedule == "vertex"
    if vertex and args.gather_dtype:
        print("profile_iter: the vertex schedule gathers X itself: no "
              "--gather-dtype", file=sys.stderr)
        return 2
    gather = args.gather_dtype or (BENCH_CONFIG.gather_dtype
                                   if args.dtype == "float32" and not vertex
                                   else None)
    print(f"schedule={args.schedule} model={args.model} "
          f"per_vertex={args.per_vertex} n={args.n} "
          f"dim={args.dim} dtype={args.dtype} "
          f"gather_dtype={gather}", flush=True)

    cfg = dataclasses.replace(BENCH_CONFIG, model=args.model, dim=args.dim,
                              per_vertex_samples=args.per_vertex,
                              dtype=args.dtype, gather_dtype=gather)
    t0 = time.perf_counter()
    graph = synth_powerlaw_graph(n=args.n)
    rng = np.random.default_rng(7)
    gen = torch.Generator(dev).manual_seed(7)
    if vertex:
        fv = VertexShardedForce2Vec(
            graph, cfg, min_width=MIN_WIDTH, hub_width=HUB_WIDTH,
            sampling="pool" if args.per_vertex else "shared", device=dev)
    else:
        fv = SyncForce2Vec(graph, cfg, MIN_WIDTH, HUB_WIDTH, device=dev)
    build_s = time.perf_counter() - t0
    layout = fv.layout.stats if vertex else None
    print(f"graph and trainer built in {build_s:.1f} s"
          + (f"; layout={json.dumps(layout)}" if vertex else ""), flush=True)
    x = fv.init_embedding(seed=1)
    is_walk = fv.model.attraction == "walk"
    if vertex:
        S = cfg.ns if fv.sampling == "shared" else fv.neg_pool
        pool = torch.as_tensor(rng.integers(0, graph.n - 1, S).astype(
            np.int32), device=dev)
        choice = (None if fv.sampling == "shared" else torch.as_tensor(
            rng.integers(0, S, (fv.layout.n_loc, cfg.ns)).astype(np.int32),
            device=dev))

        def iteration():
            fv._iteration(x, pool, choice,
                          fv.draw_walks(gen) if is_walk else None, fv.lr)
    else:
        n_pad = fv.layout.n_pad
        rows = n_pad if cfg.per_vertex_samples else -(-n_pad //
                                                      cfg.batch_size)
        negs = torch.as_tensor(rng.integers(
            0, graph.n - 1, size=(rows, cfg.ns)).astype(np.int32), device=dev)

        def iteration():
            fv.run_iteration(x, negs,
                             walks=fv.draw_walks(gen) if is_walk else None)

    xs, done = fv.init_embedding(seed=1), [0]

    def span_iteration():  # the next iteration of one run, as train() runs
        fv.run_span(xs, 1, 1, done[0])
        done[0] += 1

    for _ in range(5):  # build, load and warm up (the span: and capture)
        iteration()
        span_iteration()
    g = fv.span_graph
    res_graph = {"capture_s": g.capture_seconds,
                 "pool_mb": g.pool_bytes / 2**20, "launches": g.counts}
    print(f"run_span graph: captured in {g.capture_seconds:.3f} s, pool "
          f"{res_graph['pool_mb']:.1f} MB, launches per replay {g.counts} "
          f"[{card}]", flush=True)
    # the host cost of the path's edge launch
    xg = x if vertex else fv._replica(x)
    if vertex:  # the free slabs' table, or the walks' launch
        steps = graph.nnz
        t, out = fv.tables, None
        if is_walk:
            walks = fv.draw_walks(gen)
            steps = int((walks >= 0).sum())

            def edge_call():
                fv._walk_attraction(x, walks, fv.lr)
        else:
            out = torch.empty((t.out_rows, x.shape[1]), dtype=x.dtype,
                              device=dev)

            def edge_call():
                fk.ell_edge_force_table(fv.model, x, x, t.free, t.inv_deg,
                                        fv.lr, out=out)
    elif is_walk:  # over the walk table
        walks = fv.draw_walks(gen)
        steps = walks.numel()

        def edge_call():
            fk.ell_edge_force(fv.model, x, xg, walks, fv._walk_deg,
                              fv._all_rows, fv.inv_deg, fv.lr)
    else:  # over the layout's work table
        steps = fv.graph.nnz

        def edge_call():
            fk.ell_edge_force_table(fv.model, x, xg, fv.edge_table,
                                    fv.inv_deg, fv.lr)
    res = {"card": card, "schedule": args.schedule, "model": cfg.model,
           "n": args.n, "dim": cfg.dim,
           "dtype": cfg.dtype, "gather_dtype": cfg.gather_dtype,
           "per_vertex_samples": cfg.per_vertex_samples,
           "layout": layout, "span_graph": res_graph,
           "repeats": []}
    for _ in range(3):
        r = {}
        for tag, fn in (("", iteration), ("span_", span_iteration)):
            r[tag + "ms_per_iter"] = cuda_ms(fn, args.iters)
            r[tag + "host_enqueue_ms"] = host_ms(fn, args.iters)
            r[tag + "queued_device_ms"] = queued_device_ms(fn, args.iters)
        res["repeats"].append(r)
        print(" ".join(f"{k}={v:.4f}" for k, v in r.items()) + f" [{card}]",
              flush=True)
    res["edge_wrapper_host_us"] = 1e3 * host_ms(edge_call, 200)
    print(f"edge_wrapper_host_us={res['edge_wrapper_host_us']:.2f} [{card}]",
          flush=True)

    for key, fn in (("device", iteration), ("span_device", span_iteration)):
        res[key], prof = profile_window(
            lambda: [fn() for _ in range(args.iters)], args.iters)
        d, kernels = res[key], res[key]["kernels"]
        if not kernels:
            print("the profiler recorded no device events", flush=True)
        edge_ms = sum(k["ms_per_iter"] for name, k in kernels.items()
                      if "ell_edge_force_kernel" in name)
        d["edge_g_rows_per_s"] = steps / edge_ms / 1e6 if edge_ms else None
        print(f"{key}: edge kernel {edge_ms:.4f} ms/iter of device time for "
              f"{steps} neighbour rows, {d['edge_g_rows_per_s']} G rows/s "
              f"[{card}]", flush=True)
        for name, k in kernels.items():
            print(f"  device {k['ms_per_iter']:.4f} ms/iter  launches/iter "
                  f"{k['launches_per_iter']:.1f}  {name[:110]}", flush=True)
        print(f"{key}: profiled wall ms/iter={d['profiled_wall_ms']:.4f} "
              f"device busy ms/iter={d['busy_ms']:.4f} idle share="
              f"{d['idle_share']} host launches/iter={d['host_launches']:.1f}"
              f" [{card}]", flush=True)
    res["edge_g_rows_per_s"] = res["device"]["edge_g_rows_per_s"]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
