"""Checkpoint and resume, a subsystem the reference lacks (SURVEY.md §5).

The port of ``force2vec_tpu/train/checkpoint.py``.  A checkpoint is one
``.npz``: the canonical ``[n, dim]`` embedding (original vertex order, the
``dim`` columns of the run, never the trainers' padded row width), the
iteration count, and the seed and dim to sanity-check a resume.  A bf16
embedding is stored as the JAX package stores one, raw 2-byte ``|V2``
words, so each package reads the other's files.  Writes
are atomic (temporary file and rename), so a kill mid-write cannot corrupt
the latest checkpoint.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from force2vec_tpu_torch.convert import (bf16_words_to_f32, is_bf16_words,
                                         tensor_to_bf16_words)


def _savable(emb) -> np.ndarray:
    """The array a checkpoint stores: a bf16 tensor's ``|V2`` words, any
    other tensor's values, a numpy array as it is."""
    if not isinstance(emb, torch.Tensor):
        return np.asarray(emb)
    if emb.dtype == torch.bfloat16:
        return tensor_to_bf16_words(emb)
    return emb.detach().to("cpu").numpy()


def save_checkpoint(path: str, emb, iteration: int,
                    meta: Optional[dict] = None) -> None:
    """Atomically write the embedding (numpy, or a tensor: a bf16 one as
    ``|V2`` words), the iteration and ``meta`` to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, emb=_savable(emb), iteration=iteration,
                     **(meta or {}))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[np.ndarray, int]:
    """Return (embedding, iteration).  A bf16 embedding (``|V2`` words)
    comes back as f32, an exact widening: a trainer holding X in bf16
    (``pad_embedding``) narrows it back bit for bit."""
    with np.load(path) as z:
        emb = z["emb"]
        return (bf16_words_to_f32(emb) if is_bf16_words(emb) else emb,
                int(z["iteration"]))


class _HostSnapshot:
    """Copies of the canonical embedding into host memory, for a writer
    thread.  On a card the copy goes into one reused pinned buffer without
    waiting, and an event marks its end: the trainers update X in place,
    and the copy, queued on the stream before the next span's kernels,
    reads X before they move it.  ``wait`` returns the host array once the
    copy has landed, as a host tensor."""

    def __init__(self):
        self._buf = None
        self._done = None

    def take(self, emb: torch.Tensor) -> None:
        if emb.device.type != "cuda":
            self._buf, self._done = emb.detach().to("cpu", copy=True), None
            return
        if self._buf is None or self._buf.shape != emb.shape:
            self._buf = torch.empty(emb.shape, dtype=emb.dtype,
                                    pin_memory=True)
        self._buf.copy_(emb, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(emb.device))

    def wait(self) -> torch.Tensor:
        if self._done is not None:
            self._done.synchronize()
        return self._buf


def train_with_checkpoints(
    runner,
    iters: int,
    seed: int = 1,
    x0: Optional[np.ndarray] = None,
    start_iter: int = 0,
    every: int = 100,
    ckpt_dir: str = ".",
    keep: int = 3,
    verbose: bool = False,
    async_fetch: Optional[bool] = None,
) -> Optional[torch.Tensor]:
    """Train in ``every``-iteration spans, checkpointing after each span;
    returns the ``[n, dim]`` embedding on the runner's device (None on the
    ranks other than 0 of a vertex-sharded run).

    Works with every runner (``Force2Vec``, ``SyncForce2Vec``, the
    ``dist`` runners): each has ``run_span(x, seed, num_iters,
    iter_offset)`` and ``init_embedding``, ``pad_embedding`` and
    ``unpad_embedding``.  Checkpoints store the canonical host embedding,
    so a run checkpointed under one schedule can resume under another.
    Draws are keyed by the absolute iteration, so a resumed run continues
    the sample sequence a straight run draws.

    In a multi-process run every rank runs the spans and enters
    ``unpad_embedding`` (a collective), and rank 0 alone writes; every
    rank resumes from the same file.

    ``async_fetch`` (by default on in a single process, and refused in a
    multi-process one, where ``unpad_embedding`` is a collective that
    every rank must enter in order with nothing else in flight) writes
    each checkpoint in a background thread while the next span trains,
    from a host copy taken before that span starts (``_HostSnapshot``).
    At most one write is in flight, so writes stay in order; an exception
    in the writer is raised again by the next span's wait or at the end.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if async_fetch is None:
        async_fetch = world == 1
    if async_fetch and world > 1:
        raise ValueError("async checkpoint fetch is refused in a "
                         f"{world}-process run")
    if x0 is not None and np.shape(x0)[1:] != (runner.config.dim,):
        raise ValueError(f"the checkpoint holds {np.shape(x0)[1:]} columns, "
                         f"the run trains dim {runner.config.dim}")
    write_files = not dist.is_initialized() or dist.get_rank() == 0
    x = (runner.pad_embedding(x0) if x0 is not None
         else runner.init_embedding(seed))
    done = start_iter
    paths = []
    snap = _HostSnapshot()

    def write_one(emb_host, at_iter):
        path = os.path.join(ckpt_dir, f"ckpt_{at_iter:07d}.npz")
        save_checkpoint(path, emb_host, at_iter,
                        {"seed": seed, "dim": runner.config.dim})
        paths.append(path)
        if len(paths) > keep:
            old = paths.pop(0)
            if os.path.exists(old):
                os.unlink(old)
        if verbose:
            print(f"checkpoint @ iter {at_iter} -> {path}")

    pending: list = []  # (thread, error cell)

    def flush():
        while pending:
            thread, err = pending.pop(0)
            thread.join()
            if err:
                raise err[0]

    def writer(at_iter, err):
        try:
            write_one(snap.wait(), at_iter)
        except Exception as e:  # raised again by flush()
            err.append(e)

    while done < iters:
        k = min(every, iters - done)
        runner.run_span(x, seed, k, done)
        done += k
        flush()  # the last writer has read the buffer: reuse it
        emb = runner.unpad_embedding(x)  # every rank: may be a collective
        if not write_files:
            continue
        snap.take(emb)
        if not async_fetch:
            write_one(snap.wait(), done)
            continue
        err: list = []
        t = threading.Thread(target=writer, args=(done, err), daemon=True)
        t.start()
        pending.append((t, err))
    flush()
    return runner.unpad_embedding(x)
