"""Measurement scripts for the port, run as ``python3 -m
force2vec_tpu_torch.tools.<name>`` on a machine with a CUDA card, and what
they share with ``chip_smoke.py``: the bench configuration, the card's
name and power limit, and CUDA-event timing with and without the host in
the way."""

from __future__ import annotations

import subprocess

import torch

from force2vec_tpu_torch.train.trainer import TrainConfig

# bench.py's headline run (bench.py:102-106): tdist, dim 128, ns 5, one
# negative set per 256-row group, bf16 gather replica, mult8 widths
BENCH_CONFIG = TrainConfig(dim=128, model="tdist", ns=5, batch_size=256,
                           gather_dtype="bfloat16")
MIN_WIDTH, HUB_WIDTH = 8, 128


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_device_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` with every call queued before the
    device reaches it: a ~0.1 s sleep kernel holds the stream while the
    host enqueues ``reps`` calls (about 1 ms each)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # clock cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    if start.query():  # the device got past the sleep: it may have waited
        raise RuntimeError("the sleep ended before the calls were queued; "
                           "use fewer reps")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
