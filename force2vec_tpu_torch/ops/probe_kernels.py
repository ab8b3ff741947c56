"""The benchmark probes' kernels: CUDA wrappers and plain versions.

The counterpart of the four Pallas probes in ``benchmarks/``:

* ``take_sum`` (``csrc/take_sum.cu``): the sum of K gathered table rows,
  copied into a shared-memory ring; it replaces
  ``benchmarks/exp_r3.py:146-160`` ``vmem_take`` (both of its lowerings,
  ``take`` and ``rowloop``, computed this one function);
* ``tile_force_tc`` (``csrc/tile_force_tc.cu``): the tdist edge sweep over
  materialised tiles with the D-axis reduction on the tensor cores, one
  launch over a work table of tiles (``tile_work_table``,
  ``tile_force_tc_table``); it replaces ``benchmarks/exp_r3.py:638-656``
  ``mxu_force``;
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

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from force2vec_tpu_torch.models.forces import MAXBOUND
from force2vec_tpu_torch.ops import _build
from force2vec_tpu_torch.ops.force_kernels import (_GATHER_DTYPES, _KERNEL_DIM,
                                                   _MAX_ENTRIES, _check,
                                                   _check_cuda_operands,
                                                   _require, _stream)

launch_counts = {"take_sum": 0, "resident_gather": 0, "read_sum": 0,
                 "tile_force_tc": 0}

# read_sum's pass 1: rows per block, capped so that pass 2 adds at most
# READ_MAX_BLOCKS partials; csrc/read_sum.cu::kThreads threads per block.
READ_ROWS_PER_BLOCK = 256
READ_MAX_BLOCKS = 1024
_READ_THREADS = 256
# take_sum's ring (csrc/take_sum.cu): gathered rows per stage
# (kStageIds), so a stage holds TAKE_STAGE_IDS // K output rows and K is at
# most TAKE_STAGE_IDS; the stages a block's ring has by default; how the
# ring is filled.
TAKE_STAGE_IDS = 32
TAKE_STAGES = 2
TAKE_FILLER = "cp.async"


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


def take_sum_rows_per_stage(k: int) -> int:
    """Output rows a stage of ``take_sum``'s ring holds at K = k."""
    return TAKE_STAGE_IDS // k


def take_sum(tbl, idx, *, stages: int = TAKE_STAGES) -> torch.Tensor:
    """Sum of K gathered table rows per output row, gathering in the kernel.

    tbl [H, D] bf16 or f32; idx [C, K] int32 rows of tbl.  Returns [C, D]
    f32.  ``stages`` is the depth of the kernel's shared-memory ring.  The
    TPU counterpart is ``benchmarks/exp_r3.py:146-160`` ``vmem_take`` (its
    ``mode`` picked one of two Mosaic lowerings of this function, so there
    is none here).  The kernel takes 1 ≤ K ≤ ``TAKE_STAGE_IDS``.
    """
    dev = tbl.device
    _check("tbl", tbl, _GATHER_DTYPES, 2, dev)
    _check("idx", idx, (torch.int32,), 2, dev)
    dim = tbl.shape[1]
    c, k = idx.shape
    if dev.type == "cpu":
        return take_sum_plain(tbl, idx)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(1 <= k <= TAKE_STAGE_IDS,
             f"the kernel takes 1 to {TAKE_STAGE_IDS} ids per row, got {k}")
    _require(stages >= 1, f"bad ring depth {stages}")
    out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check_cuda_operands(dim, tbl, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_take_sum(tbl.data_ptr(), _is_bf16(tbl), idx.data_ptr(),
                               out.data_ptr(), c, k, dim, stages,
                               _stream(dev))
    _build.check(lib, "take_sum", err)
    launch_counts["take_sum"] += 1
    return out


def _occupancy(fn, name, *args):
    res = (ctypes.c_int * 2)()
    lib = _build.load_library()
    _build.check(lib, name, getattr(lib, fn)(*args, ctypes.addressof(res)))
    return res[0], res[1]


def take_sum_occupancy(dtype: torch.dtype, stages: int = TAKE_STAGES):
    """(dynamic shared memory bytes per block, blocks per SM) of
    ``take_sum``'s kernel on the current card, with a ``stages``-deep
    ring."""
    return _occupancy("f2v_take_sum_occupancy", "take_sum",
                      int(dtype == torch.bfloat16), stages)


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


def _tile_entry(xi, xj, deg, out_begin):
    """One row of the kernel's host table (csrc/tile_force_tc.cu)."""
    c, k, _ = xj.shape
    return (xi.data_ptr(), xj.data_ptr(), deg.data_ptr(), out_begin, c, k)


def _launch_tile(entries, xj_dtype, step, out) -> None:
    """One ``tile_force_tc`` launch over ``entries`` ([E, 6] int64, in
    launch order), on checked operands."""
    dev = out.device
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(out.shape[1], out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_tile_force_tc(entries.ctypes.data, entries.shape[0],
                                    int(xj_dtype == torch.bfloat16),
                                    float(step), out.data_ptr(), out.shape[1],
                                    _stream(dev))
    _build.check(lib, "tile_force_tc", err)
    launch_counts["tile_force_tc"] += 1


def _check_tile(xi, xj, deg, dev):
    _check("xi", xi, (torch.float32,), 2, dev)
    _check("xj", xj, _GATHER_DTYPES, 3, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    c, k, dim = xj.shape
    _require(xi.shape == (c, dim), f"xi {tuple(xi.shape)} != {(c, dim)}")
    _require(deg.shape == (c,), "deg must have one entry per tile row")


def tile_force_tc(xi, xj, deg, step) -> torch.Tensor:
    """The tdist edge sweep over a materialised tile, with a = Σ_d (xi −
    xj)² on the tensor cores (one TF32 pass: each term is within 2⁻¹¹ of
    its f32 value, ``csrc/tile_force_tc.cu``).

    xi [C, D] f32; xj [C, K, D] bf16 or f32 neighbour rows; deg [C] int32
    valid slots per row (slots past K count as K); step a float.  Returns
    [C, D] f32.  tdist only, and no invd, as its TPU counterpart
    ``benchmarks/exp_r3.py:638-656`` ``mxu_force``.  One launch of the
    table kernel, over a one-entry table.
    """
    dev = xi.device
    _check_tile(xi, xj, deg, dev)
    c, k, dim = xj.shape
    if dev.type == "cpu":
        return tile_force_tc_plain(xi, xj, deg, step)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check_cuda_operands(dim, xi, xj, out)
    if c:
        _launch_tile(np.array([_tile_entry(xi, xj, deg, 0)], dtype=np.int64),
                     xj.dtype, step, out)
    return out


@dataclasses.dataclass(frozen=True)
class TileWorkTable:
    """Several materialised tiles as one ``tile_force_tc`` launch.  Built
    and checked once by ``tile_work_table``; it holds the tiles, so their
    contents may change between launches, not their storage."""

    parts: tuple  # ((xi [C, D], xj [C, K, D], deg [C]), ...), caller's order
    order: tuple  # the non-empty parts' indices in launch order
    # [E, 6] int64 per entry of ``order`` (csrc/tile_force_tc.cu: xi, xj
    # and deg pointers, first output row, rows, width)
    entries: np.ndarray
    out_rows: int  # Σ C; part p writes rows [Σ_{q<p} C_q, Σ_{q≤p} C_q)


def tile_work_table(parts) -> TileWorkTable:
    """The work table of ``parts``, each ``(xi [C, D] f32, xj [C, K, D],
    deg [C] int32)`` as ``tile_force_tc`` takes them, every xj of one dtype
    (bf16 or f32) and D the kernels' 128.  Checks, once: types, shapes, one
    device, deg in [0, K], and 16-byte aligned rows (the kernel copies them
    with the copy engine).  Entries run widest first (a stable sort), so
    the longest rows start first; parts with no rows launch nothing."""
    parts = tuple(tuple(p) for p in parts)
    _require(0 < len(parts) <= _MAX_ENTRIES,
             f"a work table holds 1 to {_MAX_ENTRIES} tiles, got "
             f"{len(parts)}")
    dev = parts[0][0].device
    dtype = parts[0][1].dtype
    entries, row = [], 0
    for i, (xi, xj, deg) in enumerate(parts):
        _check_tile(xi, xj, deg, dev)
        c, k, dim = xj.shape
        _require(xj.dtype == dtype, "every xj must have one dtype")
        _require(dim == _KERNEL_DIM,
                 f"the kernel takes dim {_KERNEL_DIM}, got {dim}")
        _require(bool(((deg >= 0) & (deg <= k)).all()),
                 "deg must lie in [0, width]")
        _require(xi.data_ptr() % 16 == 0 and xj.data_ptr() % 16 == 0,
                 "xi and xj must start at 16-byte aligned rows")
        if c:
            entries.append((i, _tile_entry(xi, xj, deg, row)))
        row += c
    _require(bool(entries), "a work table needs a tile with rows")
    entries.sort(key=lambda e: -e[1][5])
    return TileWorkTable(
        parts=parts, order=tuple(i for i, _ in entries),
        entries=np.ascontiguousarray([e for _, e in entries], dtype=np.int64),
        out_rows=row)


def tile_force_tc_table_plain(work: TileWorkTable, step) -> list:
    """``tile_force_tc_plain`` of each part, in the table's part order."""
    return [tile_force_tc_plain(xi, xj, deg, step)
            for xi, xj, deg in work.parts]


def tile_force_tc_table(work: TileWorkTable, step) -> list:
    """``tile_force_tc`` over every part of ``work`` in one launch.
    Returns one [C, D] f32 result per part, in the table's part order:
    views of one [work.out_rows, D] tensor."""
    xi0, xj0, _ = work.parts[0]
    if xi0.device.type == "cpu":
        return tile_force_tc_table_plain(work, step)
    out = torch.empty((work.out_rows, xj0.shape[2]), dtype=torch.float32,
                      device=xi0.device)
    _launch_tile(work.entries, xj0.dtype, step, out)
    return list(out.split([xi.shape[0] for xi, _, _ in work.parts]))


def tile_force_tc_occupancy(dtype: torch.dtype):
    """(dynamic shared memory bytes per block, blocks per SM) of
    ``tile_force_tc``'s kernel on the current card."""
    return _occupancy("f2v_tile_force_tc_occupancy", "tile_force_tc",
                      int(dtype == torch.bfloat16))
