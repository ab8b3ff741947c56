"""Process-group bootstrap: one process per card, on one host or many.

The port of ``force2vec_tpu/dist/multihost.py``.  The JAX package drives
every local chip from one process; PyTorch's idiom is one process per
card, joined by ``torch.distributed`` (NCCL on the card, gloo on the CPU).
Ranks are numbered host by host, so ranks ``[k·tp, (k+1)·tp)`` share a
host and ``pod_mesh`` keeps each tp group inside one.

Three ways in:

* ``torchrun --nproc-per-node N -m force2vec_tpu_torch ...``: the
  launcher's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``;
* ``--coordinator host:port --num-processes W --process-id R``, one
  command per process, on any number of hosts;
* ``spawn(fn, world)``: N ranks on this host started from one process (the
  command line's ``--devices N``, and the tests), rendezvousing through a
  ``FileStore`` in a fresh temporary directory, so no TCP port is taken.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from force2vec_tpu_torch.dist.spmd import SpmdAxes

# seconds a collective may wait before the process group raises
DEFAULT_TIMEOUT = 300.0
# seconds a spawned rank may take to leave its group once every rank has
# written its result, before the parent kills it and raises
EXIT_GRACE = 30.0


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and output (rank 0)."""
    return rank() == 0


def local_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (or the rank modulo the
    host's card count), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT) -> bool:
    """Join this process into the default process group; returns whether
    it is in one.

    With no arguments, reads a launcher's ``RANK`` and ``WORLD_SIZE`` (and
    ``MASTER_ADDR``/``MASTER_PORT``); with ``coordinator_address``
    (``host:port``, served by process 0), ``num_processes`` and
    ``process_id`` say the rest.  A no-op in a single process (neither
    given) and when a group already exists.  ``backend`` defaults to NCCL
    when the host has a card, else gloo."""
    if dist.is_initialized():
        return True
    env_rank = os.environ.get("RANK")
    env_world = os.environ.get("WORLD_SIZE")
    if coordinator_address is None and env_rank is None:
        return False  # single process
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available()
                                  else "cpu")
    world = num_processes if num_processes is not None else env_world
    me = process_id if process_id is not None else env_rank
    if world is None or me is None:
        raise ValueError("a multi-process run needs its world size and rank "
                         "(--num-processes and --process-id, or RANK and "
                         "WORLD_SIZE)")
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, rank=int(me),
                            world_size=int(world),
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def shutdown() -> None:
    """Leave the default process group, if any: first drop every CUDA
    graph of this process (``train/graph.py::release_all``) and let the
    card finish, then destroy the group.

    A graph that captured an NCCL collective holds that communicator, and
    NCCL destroys a communicator only once no graph holds it: destroying
    the group under a live graph would wait for ever."""
    from force2vec_tpu_torch.train.graph import release_all

    release_all()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.destroy_process_group()


def pod_mesh(tp: int = 1) -> SpmdAxes:
    """``(dp, tp)`` groups over every rank of the default group: tp groups
    of consecutive ranks (inside a host), dp groups of the ranks with the
    same tp index.  Every rank must call it, in the same order.  Without a
    process group, the single-process ``SpmdAxes()``."""
    world = world_size()
    if world % tp:
        raise ValueError(f"{world} ranks not divisible by tp={tp}")
    if world == 1:
        return SpmdAxes()
    me, dp = rank(), world // tp
    if tp == 1:
        return SpmdAxes(dp=dist.group.WORLD, n_dp=world, dp_index=me)
    tp_group, _ = dist.new_subgroups_by_enumeration(
        [[k * tp + j for j in range(tp)] for k in range(dp)])
    dp_group = None
    if dp > 1:
        dp_group, _ = dist.new_subgroups_by_enumeration(
            [[k * tp + j for k in range(dp)] for j in range(tp)])
    return SpmdAxes(dp=dp_group, tp=tp_group, n_dp=dp, n_tp=tp,
                    dp_index=me // tp, tp_index=me % tp)


# -- ranks on this host ------------------------------------------------------


def _rank_entry(fn, rank_, world, backend, store_path, out_dir, timeout,
                threads, args):
    """One spawned rank: join the group through the FileStore, run
    ``fn(rank, world, *args)``, pickle its result (or the traceback) for
    the parent, leave the group (``shutdown``)."""
    if threads:
        torch.set_num_threads(threads)
    code = 0
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank_ % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank_,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out = ("ok", fn(rank_, world, *args))
    except Exception:  # the rank's boundary: report it to the parent
        out, code = ("err", traceback.format_exc()), 1
    path = os.path.join(out_dir, f"result_{rank_}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)  # the parent sees whole results only
    shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # no interpreter teardown that could wait on a peer


def spawn(fn: Callable, world: int, backend: str = "gloo", args=(),
          timeout: float = 120.0, threads: Optional[int] = None,
          wait: Optional[float] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method) joined by a ``backend`` process group; returns
    the ranks' results, in rank order.  ``fn`` and ``args`` must pickle,
    and so must each result (return numpy arrays, not CUDA tensors).

    The group rendezvous through a ``FileStore`` in a fresh temporary
    directory.  Each collective times out after ``timeout`` seconds, and
    the parent waits at most ``wait`` seconds in all (``timeout`` unless
    given; ``math.inf``: no limit): when a rank fails or the time is up, it kills
    every rank still running and raises.  Once every rank has written its
    result, a rank still leaving its group after ``EXIT_GRACE`` seconds is
    killed, and ``spawn`` raises: a rank that cannot leave is a fault.
    ``threads`` sets each rank's torch thread count."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="f2v_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, backend, store, tmp, timeout,
                               threads, tuple(args)),
                         daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        wait = timeout if wait is None else wait
        deadline = time.monotonic() + wait
        timed_out, stuck, done_at = False, False, None
        results_at = [os.path.join(tmp, f"result_{r}.pkl")
                      for r in range(world)]
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            now = time.monotonic()
            if now > deadline:
                timed_out = True
                break
            if done_at is None and all(map(os.path.exists, results_at)):
                done_at = now
            if done_at is not None and now - done_at > EXIT_GRACE:
                stuck = True
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"result_{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: exit code {procs[r].exitcode}, "
                              "no result")
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r}:\n{value}")
            results.append(value if status == "ok" else None)
        if errors:
            why = ""
            if hung:
                why = (f" (ranks {hung} killed "
                       + (f"at the {wait} s limit)" if timed_out
                          else "after another rank failed)"))
            raise RuntimeError(f"{len(errors)} of {world} ranks failed{why}:"
                               "\n" + "\n".join(errors))
        if stuck:
            raise RuntimeError(f"ranks {hung} wrote their results but did not "
                               f"leave their process group within "
                               f"{EXIT_GRACE} s, and were killed")
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
