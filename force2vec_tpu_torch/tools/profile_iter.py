"""Where one sync iteration's time goes, at the bench configuration.

    python3 -m force2vec_tpu_torch.tools.profile_iter [--iters 20]
        [--model tdist|sigmoid|rwalk|fr|linlog|forceatlas] [--per-vertex]
        [--n 131072] [--trace PATH] [--json PATH]

Needs one CUDA card.  Builds the same ``SyncForce2Vec`` as ``chip_smoke.py``
(``bench.py``'s graph and TrainConfig, with ``--model`` in place of tdist,
with ``--per-vertex`` ``-bs 1`` negatives, and with ``--n`` the graph's
vertex count, as ``bench.py``'s ``BENCH_N``) and measures, on the kernel
path, an iteration as ``train()`` runs it (for walk models, the walk
engine's draw included):

* three times each, since the host's speed varies from one moment to the
  next: ``ms_per_iter``, CUDA events over back-to-back ``run_iteration``
  calls; ``host_enqueue_ms``, host time to enqueue one iteration, without
  a sync; ``queued_device_ms``, CUDA events over iterations queued behind
  a sleep kernel, so that the device never waits for the host: the
  iteration's time once launches are free;
* ``edge_wrapper_host_us``: host time of the iteration's one
  ``ell_edge_force`` call: over the layout's work table, or over the walk
  table (its checks, the device guard, the ctypes launch);
* ``device``: from ``torch.profiler``, each device kernel's time and
  launches per iteration, their sum ``busy_ms`` per iteration, the profiled
  wall time per iteration, and ``idle_share = 1 - busy / wall``;
* ``edge_g_rows_per_s``: the edge kernel's neighbour rows (the graph's
  edges, or the walks' steps) per second of its device time.

Every line names the card and its power limit.  ``--trace`` writes the
profiler's Chrome trace; ``--json`` writes the numbers.
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

from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.tools import (BENCH_CONFIG, HUB_WIDTH, MIN_WIDTH,
                                      card_name_and_power, cuda_ms,
                                      queued_device_ms)
from force2vec_tpu_torch.train.sync import SyncForce2Vec


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--model", default=BENCH_CONFIG.model)
    ap.add_argument("--per-vertex", action="store_true")
    ap.add_argument("--n", type=int, default=131072,
                    help="vertices of the synthetic graph (bench.py's BENCH_N)")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_iter: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power()
    print(card, flush=True)
    print(f"model={args.model} per_vertex={args.per_vertex} n={args.n}",
          flush=True)

    cfg = dataclasses.replace(BENCH_CONFIG, model=args.model,
                              per_vertex_samples=args.per_vertex)
    fv = SyncForce2Vec(synth_powerlaw_graph(n=args.n), cfg, MIN_WIDTH,
                       HUB_WIDTH, device=dev)
    n_pad = fv.layout.n_pad
    rows = n_pad if cfg.per_vertex_samples else -(-n_pad // cfg.batch_size)
    negs = torch.as_tensor(np.random.default_rng(7).integers(
        0, fv.graph.n - 1, size=(rows, cfg.ns)).astype(np.int32), device=dev)
    x = fv.init_embedding(seed=1)
    gen = torch.Generator(dev).manual_seed(7)
    is_walk = fv.model.attraction == "walk"

    def iteration():
        fv.run_iteration(x, negs,
                         walks=fv.draw_walks(gen) if is_walk else None)

    for _ in range(5):  # build, load and warm up
        iteration()
    # the host cost of the path's one edge launch
    xg = x.to(torch.bfloat16)
    if is_walk:  # over the walk table
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
    res = {"card": card, "model": cfg.model, "n": args.n,
           "per_vertex_samples": cfg.per_vertex_samples, "repeats": []}
    for _ in range(3):
        r = {"ms_per_iter": cuda_ms(iteration, args.iters),
             "host_enqueue_ms": host_ms(iteration, args.iters),
             "queued_device_ms": queued_device_ms(iteration, args.iters)}
        res["repeats"].append(r)
        print(" ".join(f"{k}={v:.4f}" for k, v in r.items()) + f" [{card}]",
              flush=True)
    res["edge_wrapper_host_us"] = 1e3 * host_ms(edge_call, 200)
    print(f"edge_wrapper_host_us={res['edge_wrapper_host_us']:.2f} [{card}]",
          flush=True)

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            iteration()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.iters
    kernels = device_breakdown(prof, args.iters)
    busy = sum(k["ms_per_iter"] for k in kernels.values())
    res["device"] = {"kernels": kernels, "busy_ms": busy,
                     "profiled_wall_ms": wall,
                     "idle_share": 1.0 - busy / wall if kernels else None}
    if not kernels:
        print("the profiler recorded no device events", flush=True)
    edge_ms = sum(k["ms_per_iter"] for name, k in kernels.items()
                  if "ell_edge_force_kernel" in name)
    res["edge_g_rows_per_s"] = steps / edge_ms / 1e6 if edge_ms else None
    print(f"edge kernel: {edge_ms:.4f} ms/iter of device time for {steps} "
          f"neighbour rows, {res['edge_g_rows_per_s']} G rows/s [{card}]",
          flush=True)
    for name, k in kernels.items():
        print(f"  device {k['ms_per_iter']:.4f} ms/iter  launches/iter "
              f"{k['launches_per_iter']:.1f}  {name[:110]}", flush=True)
    print(f"profiled wall ms/iter={wall:.4f} device busy ms/iter={busy:.4f} "
          f"idle share={res['device']['idle_share']} [{card}]", flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
