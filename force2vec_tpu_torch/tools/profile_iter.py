"""Where one sync iteration's time goes, at the bench configuration.

    python3 -m force2vec_tpu_torch.tools.profile_iter [--iters 20]
        [--model tdist|sigmoid|rwalk|fr|linlog|forceatlas] [--per-vertex]
        [--trace PATH] [--json PATH]

Needs one CUDA card.  Builds the same ``SyncForce2Vec`` as ``chip_smoke.py``
(``bench.py``'s graph and TrainConfig, with ``--model`` in place of tdist
and, with ``--per-vertex``, ``-bs 1`` negatives) and measures, on the
kernel path, an iteration as ``train()`` runs it (for walk models, the
walk engine's draw included):

* three times each, since the host's speed varies from one moment to the
  next: ``ms_per_iter``, CUDA events over back-to-back ``run_iteration``
  calls; ``host_enqueue_ms``, host time to enqueue one iteration, without
  a sync; ``queued_device_ms``, CUDA events over iterations queued behind
  a sleep kernel, so that the device never waits for the host: the
  iteration's time once launches are free;
* ``edge_wrapper_host_us``: host time of one ``ell_edge_force`` call on
  the smallest bucket, or on the walk table (its checks, the device
  guard, the ctypes launch);
* ``device``: from ``torch.profiler``, each device kernel's time and
  launches per iteration, their sum ``busy_ms`` per iteration, the profiled
  wall time per iteration, and ``idle_share = 1 - busy / wall``.

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
from force2vec_tpu_torch.train.sync import DeviceBucket, SyncForce2Vec


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
    ap.add_argument("--trace", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_iter: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_name_and_power()
    print(card, flush=True)
    print(f"model={args.model} per_vertex={args.per_vertex}", flush=True)

    cfg = dataclasses.replace(BENCH_CONFIG, model=args.model,
                              per_vertex_samples=args.per_vertex)
    fv = SyncForce2Vec(synth_powerlaw_graph(), cfg, MIN_WIDTH, HUB_WIDTH,
                       device=dev)
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
    # the edge wrapper's host cost, on the smallest launch of the path
    if is_walk:  # its one launch, over the walk table
        small = DeviceBucket(
            0, fv.draw_walks(gen),
            torch.full((n_pad,), cfg.walk_length, dtype=torch.int32,
                       device=dev),
            torch.arange(n_pad, dtype=torch.int32, device=dev))
    else:
        small = min(fv.device_buckets, key=lambda b: b.nbr.shape[0])
    xg = x.to(torch.bfloat16)
    wrapper_args = (fv.model, x, xg, small.nbr, small.deg, small.xi_row,
                    fv.inv_deg, fv.lr)
    res = {"card": card, "model": cfg.model,
           "per_vertex_samples": cfg.per_vertex_samples, "repeats": []}
    for _ in range(3):
        r = {"ms_per_iter": cuda_ms(iteration, args.iters),
             "host_enqueue_ms": host_ms(iteration, args.iters),
             "queued_device_ms": queued_device_ms(iteration, args.iters)}
        res["repeats"].append(r)
        print(" ".join(f"{k}={v:.4f}" for k, v in r.items()) + f" [{card}]",
              flush=True)
    res["edge_wrapper_host_us"] = 1e3 * host_ms(
        lambda: fk.ell_edge_force(*wrapper_args), 200)
    res["edge_wrapper_rows"] = int(small.nbr.shape[0])
    print(f"edge_wrapper_host_us={res['edge_wrapper_host_us']:.2f} "
          f"({res['edge_wrapper_rows']} rows) [{card}]", flush=True)

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
