"""Run one cell of the port's benchmark once, on the cards of this machine.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  It drives
``force2vec_tpu_torch`` only, as its command line trains a graph:

1. set-up: the cell's graph and initial X from the seed
   (``graphgen.py``), the runner built with the arguments the command
   line gives it for the cell's flags, and the run's first ``CHECKED``
   iterations through ``run_span``, X kept after each for the check (the
   first builds or loads the kernels and captures the iteration's CUDA
   graph);
2. the window: ``run_span`` one iteration a call, at most ``QUEUE``
   iterations queued ahead of the card, a CUDA event after each, for
   ``--seconds`` (``--trace 1``: a short window under ``torch.profiler``
   instead, for the per-layer metrics);
3. the check: the program's state freed, the reference runs the checked
   iterations again and ``check.py`` holds the program to it.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (iterations run), ``failed`` (checked iterations over a
limit), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` (each compared number with its limit), which also close
standard error.  Without a CUDA card, or with fewer than the cell asks
for, it prints no result and exits 2.  It exits 1, with no result, if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()  # the process's start, as set-up counts it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from portbench import check, graphgen, spec, trace, work  # noqa: E402

QUEUE = 4  # iterations enqueued ahead of the card in the window
TRACE_TARGET_S = 0.5  # device time a traced window aims at
# the top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "force2vec_tpu")
# the program's kernel caches, at fixed paths inside the checkout
CACHE = spec.ROOT / ".portbench_cache"
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")


class DeviceClock:
    """CUDA events on the current stream: one at the window's start, one
    after each iteration."""

    def __init__(self, torch):
        self._torch = torch
        self.events = []

    def _event(self):
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self.events = []
        self._event()

    def mark(self) -> None:
        """After an iteration: its event, then wait until no more than
        ``QUEUE`` iterations are ahead of the card."""
        self._event()
        if len(self.events) > QUEUE + 1:
            self.events[-1 - QUEUE].synchronize()

    def finish(self) -> None:
        self._torch.cuda.synchronize()

    def intervals_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                   self.events[1:])]


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def build_runner(graph, cell, device, dtype: str | None = None):
    """The runner the command line builds for the cell's flags
    (``cli.py``'s ``TrainConfig`` and constructor call, one rank), with X
    held in the traffic's ``x_dtype`` (float32 where it names none), or in
    ``dtype`` where one is given (``calibrate.py``'s control: bfloat16)."""
    from force2vec_tpu_torch.dist import multihost
    from force2vec_tpu_torch.train.trainer import Force2Vec, TrainConfig

    cfg, tr = cell.config, cell.traffic
    config = TrainConfig(dim=cfg["dim"], batch_size=cfg["batch"],
                         model=cfg["model"], ns=cfg["ns"], lr=cfg["lr"],
                         per_vertex_samples=tr["bs"] == 1,
                         gather_dtype=tr["gather_dtype"], sm_table=False,
                         dtype=dtype or tr.get("x_dtype", "float32"))
    spmd = multihost.pod_mesh(1)
    if tr["schedule"] == "sync":
        from force2vec_tpu_torch.train.sync import SyncForce2Vec

        return SyncForce2Vec(graph, config, spmd=spmd, device=device)
    if tr["schedule"] == "batch":
        return Force2Vec(graph, config, spmd=spmd, device=device)
    raise ValueError(f"unknown schedule {tr['schedule']!r}")


def make_x0(model: str, n: int, dim: int, seed: int, device):
    """The initial X, ``[n, dim]`` f32, as ``model``'s init draws it
    (``reference/models/<model>.py``), on ``device`` from ``seed``."""
    import torch

    from portbench.reference import force2vec

    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    return force2vec.model(model).init(n, dim, gen, device)


def program_graph(src, dst, n: int):
    """The program's ``Graph`` of the undirected edges ``(src, dst)``: each
    edge as two entries, through ``Graph.from_coo`` as a loaded graph file
    is."""
    from force2vec_tpu_torch.graphs.csr import Graph

    return Graph.from_coo(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), None, n=n)


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(runner, x, seed: int, it: int, seconds: float, clock) -> dict:
    """Iterations from ``it`` on, one ``run_span`` call each, until
    ``seconds`` of host time have passed; the window starts after a
    synchronize and ends with one."""
    clock.start()
    t0 = time.perf_counter()
    first = it
    while True:
        runner.run_span(x, seed, 1, it)
        it += 1
        clock.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    clock.finish()
    return {"iterations": it - first, "seconds": time.perf_counter() - t0,
            "next": it}


def traced_window(torch, runner, x, seed: int, it: int, clock) -> dict:
    """A short untraced lead to time an iteration, then about
    ``TRACE_TARGET_S`` of iterations (two at least) under the profiler in
    a ``trace.WINDOW`` span, after one profiled iteration that is not
    counted."""
    lead = window(runner, x, seed, it, 0.25, clock)
    it = lead["next"]
    per_iter = lead["seconds"] / lead["iterations"]
    k = max(2, round(TRACE_TARGET_S / per_iter))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner.run_span(x, seed, 1, it)
        it += 1
        clock.start()
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(k):
                runner.run_span(x, seed, 1, it)
                it += 1
                clock.mark()
            clock.finish()
    summary = trace.summarize(*trace.profiler_events(prof))
    summary["iterations"] = k
    summary["next"] = it
    return summary


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def set_up(cell: spec.Cell, seed: int, device, dtype: str | None = None):
    """The cell's graph, its runner (``build_runner``'s X type), the
    padded X and the run's first ``check.CHECKED`` iterations: ``(edges,
    runner, x, x0, program, spans)``, with ``edges`` the graph's ``(src,
    dst)`` arrays, ``x0`` and ``program`` (X after each checked iteration)
    host ``[n, dim]`` tensors and ``spans`` the host seconds of each
    step."""
    import torch

    cfg, spans = cell.config, {}
    t = time.perf_counter()
    edges = graphgen.edges(cfg["graph"], seed)
    g = program_graph(*edges, n=int(cfg["graph"]["vertices"]))
    spans["setup.graph"] = time.perf_counter() - t

    t = time.perf_counter()
    runner = build_runner(g, cell, device, dtype)
    _sync(torch, device)
    spans["setup.trainer"] = time.perf_counter() - t

    x0 = make_x0(cfg["model"], g.n, cfg["dim"], seed, device)
    x = runner.pad_embedding(x0)
    x0 = x0.to("cpu", copy=True)
    t = time.perf_counter()
    program = []
    for it in range(check.CHECKED):
        runner.run_span(x, seed, 1, it)
        program.append(runner.unpad_embedding(x).to("cpu", torch.float32,
                                                       copy=True))
    _sync(torch, device)
    spans["setup.checked_iterations"] = time.perf_counter() - t
    return edges, runner, x, x0, program, spans


def free() -> None:
    """Drop every CUDA graph of the program, the trainers that only a
    reference cycle keeps, and the cached device memory: after the caller
    has dropped its runner, the program's state goes before the reference
    runs on the card."""
    import torch

    from force2vec_tpu_torch.train import graph as span_graph

    span_graph.release_all()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_csr(cell: spec.Cell, edges) -> tuple:
    """The benchmark's own CSR of the cell's graph, which the reference
    reads."""
    return graphgen.csr(*edges, n=int(cell.config["graph"]["vertices"]))


def check_run(cell: spec.Cell, edges, x0, program: list, seed: int,
              device) -> list:
    """The reference's run of the checked iterations and each one's
    readings (``check.readings``)."""
    from portbench.reference import force2vec

    ref = force2vec.build(*reference_csr(cell, edges), cell.config,
                          cell.traffic, device)
    reference = ref.run(x0, seed, check.CHECKED)
    return check.readings(x0, program, reference, device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, clock) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    import torch

    edges, runner, x, x0, program, spans = set_up(cell, seed, device)
    setup_s = time.time() - T_START

    cfg, tr = cell.config, cell.traffic
    n, nnz = int(cfg["graph"]["vertices"]), 2 * len(edges[0])
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    ctx = {
        "spans": spans,
        "counters": {
            "capture_seconds": runner.span_graph.capture_seconds,
            "pool_bytes": runner.span_graph.pool_bytes,
            "launches_per_iteration": dict(runner.span_graph.counts),
        },
        "sizes": dict(model=cfg["model"], n=n, nnz=nnz, dim=cfg["dim"],
                      ns=cfg["ns"], batch=cfg["batch"],
                      per_vertex=tr["bs"] == 1,
                      x_dtype=tr.get("x_dtype", "float32")),
        "peak": work.PEAKS.get(kind),
        "trace": None,
    }
    it = check.CHECKED
    if traced:
        ctx["trace"] = traced_window(torch, runner, x, seed, it, clock)
        attempted = ctx["trace"]["next"]
    else:
        win = window(runner, x, seed, it, seconds, clock)
        attempted = win["next"]
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": kind,
        "count": cell.chips,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0),
    }
    found = forbidden_modules()

    metrics, breakdown = {}, None
    if traced:
        tr = ctx["trace"]
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {
            "device_ops": [[name, s] for name, s in
                           tr["by_name"].most_common(10)],
            "idle_gaps": [[name, s] for name, s in
                          tr["gaps"].most_common(10)],
        }
    else:
        values = {
            "setup_s": setup_s,
            "updates_per_s": (win["iterations"] * work.updates_per_iter(
                n, nnz, cfg["ns"]) / win["seconds"] / 1e6),
            "iter_ms_p90": float(np.percentile(clock.intervals_ms(), 90)),
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()

    del x, runner
    free()
    t = time.perf_counter()
    per_iter = check_run(cell, edges, x0, program, seed, device)
    correct, failed, worst = check.judge(per_iter, cell.limits)
    return {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
        "breakdown": breakdown,
        "checks": {k: {"value": worst[k], "limit": cell.limits[k]}
                   for k in check.NUMBERS},
        "forbidden": sorted(set(found) | set(forbidden_modules())),
        "reference_s": time.perf_counter() - t,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark measures only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   DeviceClock(torch))
    found = out.pop("forbidden")
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 1
    print(f"portbench: reference and comparison {out.pop('reference_s'):.2f}"
          " s", file=sys.stderr)
    if out["breakdown"] is None:
        del out["breakdown"]
    checks = out.pop("checks")
    out["checks"] = checks  # the last key
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
