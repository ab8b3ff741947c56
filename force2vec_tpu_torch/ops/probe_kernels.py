"""The benchmark probes' kernels: CUDA wrappers and plain versions.

The counterpart of the four Pallas probes in ``benchmarks/``:

* ``take_sum`` (``csrc/take_sum.cu``): the sum of K gathered table rows;
  it replaces ``benchmarks/exp_r3.py:146-160`` ``vmem_take`` (both of its
  lowerings, ``take`` and ``rowloop``, computed this one function);
* ``tile_force_tc`` (``csrc/tile_force_tc.cu``): the tdist edge sweep over
  a materialised tile with the D-axis reduction on the tensor cores; it
  replaces ``benchmarks/exp_r3.py:638-656`` ``mxu_force``;
* ``resident_gather`` (``csrc/resident_gather.cu``): a row gather from a
  table that stays in L2; it replaces ``benchmarks/exp_r4.py:127-148``
  ``_dg_call``;
* ``read_sum`` (``csrc/read_sum.cu``): the column sums of a streamed tile;
  it replaces ``benchmarks/exp_r4.py:470-479`` ``ro_call``.

They run on no training path: ``tools/probes.py`` drives them.  As in
``force_kernels``, each has a wrapper that checks its inputs and launches
the kernel for CUDA tensors (raising if the launch fails), or runs the
plain version for CPU tensors; a plain PyTorch version; and a launch count
in ``launch_counts``, raised by one per wrapper call that launches its
kernel and by nothing else.  A CUDA tensor never falls back to the plain
version.  No kernel bounds-checks its ids: they must index the table.
"""

from __future__ import annotations

from typing import Optional

import torch

from force2vec_tpu_torch.models.forces import MAXBOUND
from force2vec_tpu_torch.ops import _build
from force2vec_tpu_torch.ops.force_kernels import (_GATHER_DTYPES, _KERNEL_DIM,
                                                   _check,
                                                   _check_cuda_operands,
                                                   _require, _stream)

launch_counts = {"take_sum": 0, "resident_gather": 0, "read_sum": 0,
                 "tile_force_tc": 0}

# read_sum's pass 1: rows per block, capped so that pass 2 adds at most
# READ_MAX_BLOCKS partials; csrc/read_sum.cu::kThreads threads per block.
READ_ROWS_PER_BLOCK = 256
READ_MAX_BLOCKS = 1024
_READ_THREADS = 256


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


# -- take_sum: sum of K gathered rows ------------------------------------------


def take_sum_terms(tbl, idx) -> torch.Tensor:
    """[C, K, D] f32(tbl[idx[r, k]]) per slot."""
    return tbl[idx.long()].float()


def take_sum_plain(tbl, idx) -> torch.Tensor:
    """out[r] = Σ_k f32(tbl[idx[r, k]]): the gather, f32, a sum over K."""
    return take_sum_terms(tbl, idx).sum(dim=1)


def take_sum(tbl, idx) -> torch.Tensor:
    """Sum of K gathered table rows per output row, gathering in the kernel.

    tbl [H, D] bf16 or f32; idx [C, K] int32 rows of tbl.  Returns [C, D]
    f32.  The TPU counterpart is ``benchmarks/exp_r3.py:146-160``
    ``vmem_take`` (its ``mode`` picked one of two Mosaic lowerings of this
    function, so there is none here).
    """
    dev = tbl.device
    _check("tbl", tbl, _GATHER_DTYPES, 2, dev)
    _check("idx", idx, (torch.int32,), 2, dev)
    dim = tbl.shape[1]
    c, k = idx.shape
    if dev.type == "cpu":
        return take_sum_plain(tbl, idx)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check_cuda_operands(dim, tbl, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_take_sum(tbl.data_ptr(), _is_bf16(tbl), idx.data_ptr(),
                               out.data_ptr(), c, k, dim, _stream(dev))
    _build.check(lib, "take_sum", err)
    launch_counts["take_sum"] += 1
    return out


# -- resident_gather: rows from an L2-resident table ---------------------------


def resident_gather_plain(tbl, idx) -> torch.Tensor:
    """out[i] = tbl[idx[i]]."""
    return tbl[idx.long()]


def resident_gather(tbl, idx,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row gather from a table small enough to stay in L2.

    tbl [H, D] bf16 or f32; idx [M] int32 rows of tbl.  Writes into ``out``
    [M, D] of tbl's dtype if given (so a timing loop allocates it once);
    returns it.  The TPU counterpart is ``benchmarks/exp_r4.py:127-148``
    ``_dg_call``, whose idx is this idx as ``[n_chunks·H, 1]`` and whose
    single ``[H, D]`` out block kept only the last chunk's rows: its result
    is the last H rows of this one.
    """
    dev = tbl.device
    _check("tbl", tbl, _GATHER_DTYPES, 2, dev)
    _check("idx", idx, (torch.int32,), 1, dev)
    m, dim = idx.shape[0], tbl.shape[1]
    if out is None:
        out = torch.empty((m, dim), dtype=tbl.dtype, device=dev)
    _check("out", out, (tbl.dtype,), 2, dev)
    _require(out.shape == (m, dim), f"out {tuple(out.shape)} != {(m, dim)}")
    if dev.type == "cpu":
        out.copy_(resident_gather_plain(tbl, idx))
        return out
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(dim, tbl, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_resident_gather(tbl.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), m,
                                      dim * tbl.element_size(), _stream(dev))
    _build.check(lib, "resident_gather", err)
    launch_counts["resident_gather"] += 1
    return out


# -- read_sum: column sums of a streamed tile -----------------------------------


def read_sum_plan(rows: int, dtype: torch.dtype):
    """(blocks, rows_per_block, adds) of ``read_sum`` over ``rows`` tile
    rows: pass 1's blocks and their slices, and the most f32 additions any
    term passes through on its way into the result (a thread's share of
    its slice, the block's row-partials, then the blocks' partials).  A
    sum whose every term passes through at most n additions is off by at
    most γ_n = n·u / (1 − n·u) of Σ|terms|, u = 2⁻²⁴."""
    blocks = max(1, min(-(-rows // READ_ROWS_PER_BLOCK), READ_MAX_BLOCKS))
    rows_per_block = max(1, -(-rows // blocks))
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows_per_step = _READ_THREADS // (_KERNEL_DIM * itemsize // 16)
    adds = -(-rows_per_block // rows_per_step) + rows_per_step + blocks
    return blocks, rows_per_block, adds


def read_sum_plain(tile) -> torch.Tensor:
    """out[0] = Σ_{t,k} f32(tile[t, k]), a [1, D] f32 sum."""
    return tile.float().sum(dim=(0, 1)).unsqueeze(0)


def read_sum(tile) -> torch.Tensor:
    """Column sums of a ``[T, K, D]`` bf16 or f32 tile, read once with
    16-byte loads; returns ``[1, D]`` f32.

    The TPU counterpart is ``benchmarks/exp_r4.py:470-479`` ``ro_call``,
    whose accumulator was never zeroed (its result depended on what the
    output buffer held); this is the zero-initialised sum.  Two passes,
    no atomics: the same tile gives the same bits on every run.
    """
    dev = tile.device
    _check("tile", tile, _GATHER_DTYPES, 3, dev)
    t, k, dim = tile.shape
    if dev.type == "cpu":
        return read_sum_plain(tile)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    rows = t * k
    _require(rows < 2**31, f"{rows} tile rows do not fit int32")
    blocks, rows_per_block, _ = read_sum_plan(rows, tile.dtype)
    partial = torch.empty((blocks, dim), dtype=torch.float32, device=dev)
    out = torch.empty((1, dim), dtype=torch.float32, device=dev)
    _check_cuda_operands(dim, tile, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_read_sum(tile.data_ptr(), _is_bf16(tile),
                               partial.data_ptr(), out.data_ptr(), rows, dim,
                               blocks, rows_per_block, _stream(dev))
    _build.check(lib, "read_sum", err)
    launch_counts["read_sum"] += 1
    return out


# -- tile_force_tc: the tdist sweep with the D reduction on the tensor cores --


def tile_force_tc_terms(xi, xj, deg, step) -> torch.Tensor:
    """[C, K, D] clip(−2/(1 + a)·(xi − xj), ±MAXBOUND)·step per slot, a =
    Σ_d (xi − xj)², in f32 and exactly 0 in the slots k ≥ deg[r]."""
    diff = xi[:, None, :] - xj.float()
    a = torch.sum(diff * diff, dim=-1, keepdim=True)
    f = torch.clamp(-2.0 / (1.0 + a) * diff, -MAXBOUND, MAXBOUND) * step
    k = xj.shape[1]
    mask = torch.arange(k, device=xj.device)[None, :] < deg[:, None]
    return torch.where(mask[:, :, None], f, 0.0)


def tile_force_tc_plain(xi, xj, deg, step) -> torch.Tensor:
    """out[r] = Σ_{k<deg[r]} clip(−2/(1 + a)·(xi[r] − xj[r, k]), ±5)·step."""
    return tile_force_tc_terms(xi, xj, deg, step).sum(dim=1)


def tile_force_tc(xi, xj, deg, step) -> torch.Tensor:
    """The tdist edge sweep over a materialised tile, with a = Σ_d (xi −
    xj)² on the tensor cores (one TF32 pass: each term is within 2⁻¹¹ of
    its f32 value, ``csrc/tile_force_tc.cu``).

    xi [C, D] f32; xj [C, K, D] bf16 or f32 neighbour rows; deg [C] int32
    valid slots per row (slots past K count as K); step a float.  Returns
    [C, D] f32.  tdist only, and no invd, as its TPU counterpart
    ``benchmarks/exp_r3.py:638-656`` ``mxu_force``.
    """
    dev = xi.device
    _check("xi", xi, (torch.float32,), 2, dev)
    _check("xj", xj, _GATHER_DTYPES, 3, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    c, k, dim = xj.shape
    _require(xi.shape == (c, dim), f"xi {tuple(xi.shape)} != {(c, dim)}")
    _require(deg.shape == (c,), "deg must have one entry per tile row")
    if dev.type == "cpu":
        return tile_force_tc_plain(xi, xj, deg, step)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check_cuda_operands(dim, xi, xj, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_tile_force_tc(xi.data_ptr(), xj.data_ptr(), _is_bf16(xj),
                                    deg.data_ptr(), float(step),
                                    out.data_ptr(), c, k, dim, _stream(dev))
    _build.check(lib, "tile_force_tc", err)
    launch_counts["tile_force_tc"] += 1
    return out
