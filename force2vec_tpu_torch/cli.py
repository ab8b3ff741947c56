"""The command line, with the reference's flags: ``python -m
force2vec_tpu_torch``.

The port of ``force2vec_tpu/cli.py``, which mirrors the reference CLI
(Test/Force2Vec.cpp:49-116): ``-input -output -batch -iter -threads -dim
-nsamples -lr -gamma -bs -option``, with the same defaults (batch 256,
iter 1200, dim 128, ns 5, lr 0.02 — Test/Force2Vec.cpp:50-53).
``-option`` keeps the reference numbering (models/forces.OPTION_TO_MODEL);
``-threads`` is accepted and ignored, ``-gamma`` is accepted and unused,
as in the reference (parsed at Test/Force2Vec.cpp:76, never read by the
kernels).  The ``--`` flags add what the reference lacks: the schedule,
checkpoints, evaluation, and ``--device``.

Schedules: ``batch`` (the default), the reference's batch-sequential
semantics (``train/trainer.py::Force2Vec``, any dim), and ``sync``, the
epoch-synchronous schedule on the hand-written kernels
(``train/sync.py::SyncForce2Vec``), and ``vertex``, X vertex-sharded over
the ranks with a halo exchange (``dist/vertex_sharded.py``; ``-bs 1``
draws each vertex's negatives from a ``--neg-pool``-row pool).  On the
card sync and vertex take any ``-dim`` from 1 to
``force_kernels.KERNEL_MAX_DIM`` (1024) and refuse a wider one, naming
the cap and the batch schedule; they hold X at the dim rounded up to 8,
the ``.embd`` has ``-dim`` columns.  ``--device`` is ``cuda``
unless given: without a card the command exits non-zero unless it says
``--device cpu``.

Several processes, one per card (NCCL; gloo with ``--device cpu``):
``--devices N`` on one host spawns N ranks; under ``torchrun`` or with
``--coordinator/--num-processes/--process-id`` each process is one rank.
With more than one rank, ``--schedule sync`` and ``batch`` run the dp ×
tp runners (``dist/sharded.py``, ``--tp`` ranks share the dim) and
``vertex`` shards X over every rank.  Only rank 0 writes the ``.embd``,
``Results.txt``, checkpoints and the evaluation.

Run summaries append to ``Results.txt`` with the reference's ledger
schema (Test/Force2Vec.cpp:191-198).  ``--verbose`` also prints, after
training, the command's spans and counters (``utils/profiling.py``:
the graph's load, the trainer's set-up, the kernels' load, the warm-up,
capture and replays) to standard error, one line each.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import math
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="force2vec",
        description="Force2Vec on PyTorch and CUDA: force-directed graph "
        "embedding",
    )
    # reference-parity flags (single dash, like the C++ command line)
    p.add_argument("-input", required=True, help=".mtx/.bcsr/edgelist graph")
    p.add_argument("-output", default="", help="output directory/prefix")
    p.add_argument("-batch", type=int, default=256)
    p.add_argument("-iter", type=int, default=1200)
    p.add_argument("-threads", type=int, default=0, help="ignored")
    p.add_argument("-dim", type=int, default=128)
    p.add_argument("-nsamples", type=int, default=5)
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-gamma", type=float, default=1.0,
                   help="parsed, unused (parity)")
    p.add_argument("-bs", type=int, default=0,
                   help="1 = per-vertex negative samples")
    p.add_argument("-option", type=int, default=5,
                   help="algorithm variant 1-11")
    # extensions
    p.add_argument("--model", default=None,
                   help="model name (overrides -option)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="iters between checkpoints")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--resume", default="",
                   help="checkpoint file to resume from")
    p.add_argument("--eval", action="store_true",
                   help="run link-pred after training")
    p.add_argument("--labels", default="", help="node labels file for eval")
    p.add_argument("--devices", type=int, default=0,
                   help="spawn N ranks on this host, one per card (dp, or "
                   "the vertex schedule's shards)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: ranks that split the dim "
                   "(with more than one rank)")
    p.add_argument(
        "--schedule",
        choices=["batch", "sync", "vertex"],
        default="batch",
        help="batch: reference batch-sequential semantics; sync: epoch-"
        "synchronous schedule on the CUDA kernels (= reference at "
        "batch_size=n); vertex: X vertex-sharded over every rank with a "
        "halo exchange (for tables beyond one card's memory)",
    )
    p.add_argument(
        "--gather-dtype",
        default=None,
        help="low-precision replica dtype for neighbour gathers (bfloat16 "
        "or float16) — halves the gather bytes; implemented on the sync "
        "schedule (a warning is printed if another schedule ignores it)",
    )
    p.add_argument("--neg-pool", type=int, default=128,
                   help="vertex schedule: global negative-sample pool size "
                   "used when -bs 1 requests per-vertex negatives")
    p.add_argument("--halo-stale", action="store_true",
                   help="vertex schedule: iteration-pipelined halo exchange "
                   "(neighbour rows one iteration stale, the reference's "
                   "own cross-batch semantics)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host: host:port served by process 0 (or a "
                   "launcher's RANK/WORLD_SIZE/MASTER_ADDR); single-process "
                   "when unset")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's rank")
    p.add_argument(
        "--sm-table",
        action="store_true",
        help="sigmoid family: evaluate σ via the reference's 2048-entry "
        "lookup table (fast_SM parity mode, sample/algorithms.cpp:755-776) "
        "instead of the exact sigmoid",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits if there is no card) or "
                   "cpu")
    p.add_argument("--verbose", action="store_true",
                   help="progress lines, and after training the spans and "
                   "counters (utils/profiling.py) on standard error")
    return p


def _fail(msg: str) -> int:
    print(f"force2vec: {msg}", file=sys.stderr)
    return 2


def _rank_main(rank: int, world: int, argv) -> int:
    """One rank of ``--devices N``: the command, in a process group that
    ``spawn`` made; only rank 0 prints."""
    if rank == 0:
        return main(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from force2vec_tpu_torch.dist import multihost

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return _fail("no CUDA device: pass --device cpu to run on the CPU")
    backend = multihost.default_backend(device.type)
    launched = (dist.is_initialized() or args.coordinator is not None
                or "RANK" in os.environ)
    if args.devices > 1 and not launched:
        # one rank per card on this host; rank 0's exit code is the run's
        if device.type == "cuda" and torch.cuda.device_count() < args.devices:
            return _fail(f"--devices {args.devices}: this host has "
                         f"{torch.cuda.device_count()} cards")
        threads = (None if device.type == "cuda"
                   else max(1, (os.cpu_count() or 1) // args.devices))
        return multihost.spawn(_rank_main, args.devices, backend,
                               args=(argv if argv is not None
                                     else sys.argv[1:],),
                               timeout=multihost.DEFAULT_TIMEOUT,
                               threads=threads, wait=math.inf)[0]
    made_group = not dist.is_initialized()
    try:
        if multihost.initialize(args.coordinator, args.num_processes,
                                args.process_id, backend=backend):
            device = multihost.local_device(device.type)
    except ValueError as e:
        return _fail(str(e))
    if not (made_group and dist.is_initialized()):
        return _run(args, device)
    try:
        return _run(args, device)
    finally:
        multihost.shutdown()  # the group this process joined, left


def _run(args, device) -> int:
    """The command on ``device``, in this process's group if it has one."""
    import torch

    from force2vec_tpu_torch.dist import multihost
    from force2vec_tpu_torch.utils import profiling

    world = multihost.world_size()
    profiling.reset()  # --verbose reports this command's spans alone

    from force2vec_tpu_torch.graphs.io import load_graph, write_embeddings
    from force2vec_tpu_torch.models.forces import get_model
    from force2vec_tpu_torch.train.trainer import Force2Vec, TrainConfig

    model = args.model or args.option
    cfg = TrainConfig(
        dim=args.dim,
        batch_size=args.batch,
        model=model,
        ns=args.nsamples,
        lr=args.lr,
        per_vertex_samples=(args.bs == 1),
        gather_dtype=args.gather_dtype,
        sm_table=args.sm_table,
    )
    try:
        model_obj = get_model(model, sm_table=args.sm_table)
    except (KeyError, ValueError) as e:
        return _fail(f"model {model!r}: {e}")
    graph = load_graph(args.input)
    batch_display = min(cfg.batch_size, graph.n)
    print(
        f"graph {args.input}: n={graph.n} nnz={graph.nnz}; "
        f"model={model_obj.name} dim={cfg.dim} batch={batch_display} "
        f"ns={cfg.ns} lr={cfg.resolve_lr(model_obj)} device={device}"
    )

    if args.gather_dtype and args.schedule != "sync":
        print(
            f"warning: --gather-dtype is implemented on the sync schedule; "
            f"schedule={args.schedule!r} ignores it",
            file=sys.stderr,
        )
    if args.tp > 1 and world == 1:
        print(f"warning: --tp {args.tp} splits the dim over ranks; a single "
              "process ignores it", file=sys.stderr)

    x0 = None
    start_iter = 0
    if args.resume:
        from force2vec_tpu_torch.train.checkpoint import load_checkpoint

        x0, start_iter = load_checkpoint(args.resume)
        if x0.shape != (graph.n, cfg.dim):
            return _fail(f"--resume {args.resume}: the checkpoint holds "
                         f"{x0.shape}, the run {(graph.n, cfg.dim)}")
        print(f"resumed from {args.resume} at iteration {start_iter}")

    # Every runner speaks one protocol (run_span / pad / init / unpad),
    # so checkpoints and resume work on any schedule.
    try:
        if args.schedule == "vertex":
            from force2vec_tpu_torch.dist.vertex_sharded import (
                VertexShardedForce2Vec)

            # -bs 1 (per-vertex negatives) is the pool sampling mode, the
            # static-shape scale-out flavour of per-vertex sampling
            runner = VertexShardedForce2Vec(
                graph, cfg, sampling="pool" if args.bs == 1 else "shared",
                neg_pool=args.neg_pool, halo_stale=args.halo_stale,
                device=device)
        else:
            # one rank: no groups; more: dp × tp over every rank
            spmd = multihost.pod_mesh(args.tp if world > 1 else 1)
            if args.schedule == "sync":
                from force2vec_tpu_torch.train.sync import SyncForce2Vec

                runner = SyncForce2Vec(graph, cfg, spmd=spmd, device=device)
            else:
                runner = Force2Vec(graph, cfg, spmd=spmd, device=device)
    except ValueError as e:
        return _fail(str(e))

    t0 = time.perf_counter()
    if args.checkpoint_every > 0 or args.resume:
        from force2vec_tpu_torch.train.checkpoint import train_with_checkpoints

        emb = train_with_checkpoints(
            runner,
            iters=args.iter,
            seed=args.seed,
            x0=x0,
            start_iter=start_iter,
            every=args.checkpoint_every or args.iter,
            ckpt_dir=args.checkpoint_dir or (args.output or "."),
            verbose=args.verbose,
        )
    else:
        kw = {"verbose": args.verbose} if args.schedule != "sync" else {}
        emb = runner.train(args.iter, seed=args.seed, x0=x0, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    if not multihost.is_coordinator():
        return 0  # only rank 0 writes the output, the ledger and the eval
    if args.verbose:
        print(profiling.report(), file=sys.stderr)

    # output name parity: <graph><ALGO><B>D<D>IT<it>NS<ns>.embd
    # (algorithms.cpp:650; writeToFile, algorithms.h:118-136)
    base = os.path.basename(args.input)
    tag = (f"F2V{model_obj.name.upper()}{batch_display}D{cfg.dim}"
           f"IT{args.iter}NS{cfg.ns}")
    out_dir = args.output or "."
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, base + tag + ".embd")
    write_embeddings(out_path, emb)
    print(f"wrote {out_path}  ({train_s:.2f}s, "
          f"{graph.nnz * args.iter / max(train_s, 1e-9) / 1e6:.1f}M "
          "edge-updates/s)")

    # Results.txt ledger row (Test/Force2Vec.cpp:191-198 schema)
    with open(os.path.join(out_dir, "Results.txt"), "a") as f:
        f.write(
            f"{model_obj.name}\tInit\tIteration:{args.iter}\t"
            f"Numofthreads:{args.threads}\tBatchSize:{batch_display}\t"
            f"Dimension:{cfg.dim}\tTime(sec.):{train_s:.4f}\n"
        )

    if args.eval:
        from force2vec_tpu_torch.eval import link_prediction_scores

        scores = link_prediction_scores(graph, emb, device=device)
        print(
            "Link prediction (Hadamard): "
            + " ".join(f"{k}={v:.4f}" for k, v in scores.items())
        )
        if args.labels:
            from force2vec_tpu_torch.eval import (node_classification_scores,
                                                  read_node_labels)

            labels = read_node_labels(args.labels, graph.n)
            for tf, sc in node_classification_scores(
                    emb, labels, device=device).items():
                print(
                    f"Multilabel-classification {tf:.0%}: "
                    f"F1-macro={sc['f1_macro']:.4f} "
                    f"F1-micro={sc['f1_micro']:.4f}"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
