"""The force kernels of the sync iteration: CUDA wrappers and plain versions.

The counterpart of ``force2vec_tpu/ops/pallas_force.py``:

* ``ell_edge_force`` (``csrc/ell_edge_force.cu``): the attraction over an
  ELL bucket or over the walk table; it replaces ``ell_force_mxu`` and
  ``ell_force`` with kind ``edge`` (the same function).
  ``ell_edge_force_table`` runs the same kernel over a whole layout's
  buckets (an ``EdgeWorkTable``) in one launch;
* ``grouped_rep_force`` (``csrc/grouped_rep_force.cu``): the repulsion
  from group-shared negatives; it replaces ``grouped_rep_force``;
* ``ell_sample_force`` (``csrc/ell_sample_force.cu``): the repulsion from
  per-row negatives (``-bs 1``); it replaces ``ell_force`` with kind
  ``sample``.

Each kernel has

* a wrapper, which checks its inputs and, for CUDA tensors, launches the
  hand-written kernel from ``csrc/`` (built at first use by ``_build``) and
  raises if the launch fails; for CPU tensors it runs the plain version;
* a plain PyTorch version of the same function, the reference the kernel is
  held against on the card;
* a launch count in ``launch_counts``, raised by one per kernel launch and
  by nothing else.

A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from force2vec_tpu_torch.models import forces
from force2vec_tpu_torch.models.forces import ForceModel
from force2vec_tpu_torch.ops import _build

launch_counts = {"ell_edge_force": 0, "grouped_rep_force": 0,
                 "ell_sample_force": 0}

# model ids of csrc/common.cuh's EdgeModel and SampleModel
_EDGE_MODEL_IDS = {
    forces._tdist_coeff: 0,
    forces._sigmoid_coeff: 1,
    forces._fr_coeff: 2,
    forces._linlog_coeff: 3,
    forces._forceatlas_coeff: 4,
}
_SAMPLE_MODEL_IDS = {
    forces._tdist_rep: 0,
    forces._sigmoid_rep: 1,
    forces._layout_rep: 2,
}
_KERNEL_DIM = 128  # csrc/common.cuh::kDim
_GATHER_DTYPES = (torch.bfloat16, torch.float32)
_MAX_SAMPLE_SMEM = 48 * 1024  # bytes of f32 samples a block may hold
_MAX_ENTRIES = 64  # csrc/common.cuh::kMaxEntries


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check(name, t, dtypes, ndim, device):
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.dtype in dtypes, f"{name}: dtype {t.dtype} not in {dtypes}")
    _require(t.dim() == ndim, f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    _require(t.device == device, f"{name} on {t.device}, expected {device}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _check_cuda_operands(dim, *tensors):
    _require(dim == _KERNEL_DIM,
             f"the CUDA kernels take dim {_KERNEL_DIM}, got {dim}")
    for t in tensors:
        # vector loads of whole row pieces need 16-byte aligned row bases
        _require(t.data_ptr() % 16 == 0, "CUDA operands must be 16-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _slot_mask(idx, deg):
    """[C, K, 1] bool: slot k of row r is real (k < deg[r])."""
    k = idx.shape[1]
    return (torch.arange(k, device=idx.device)[None, :]
            < deg[:, None])[:, :, None]


# -- attraction over ELL buckets ---------------------------------------------


def ell_edge_force_terms(model: ForceModel, x, xg, nbr, deg, xi_row, invd,
                         step) -> torch.Tensor:
    """[C, K, D] edge_force(x[i], xg[nbr[r, k]]) per slot, i = xi_row[r], in
    f32 and exactly 0 in the padded slots k ≥ deg[r]."""
    rows = xi_row.long()
    xi = x[rows]
    xj = xg[nbr.long()].float()  # [C, K, D]
    return model.edge_force(xi[:, None, :], xj, invd[rows][:, None, None],
                            step, mask=_slot_mask(nbr, deg))


def ell_edge_force_plain(model: ForceModel, x, xg, nbr, deg, xi_row, invd,
                         step) -> torch.Tensor:
    """out[r] = Σ_{k<deg[r]} edge_force(x[i], xg[nbr[r, k]]), i = xi_row[r]:
    the gather, the model's edge force in f32 and a masked sum over K."""
    return ell_edge_force_terms(model, x, xg, nbr, deg, xi_row, invd,
                                step).sum(dim=1)


def _check_edge_operands(model, x, xg, invd):
    _require(model.edge_coeff in _EDGE_MODEL_IDS,
             f"{model.name} has no separable edge force")
    dev = x.device
    _check("x", x, (torch.float32,), 2, dev)
    _check("xg", xg, _GATHER_DTYPES, 2, dev)
    _check("invd", invd, (torch.float32,), 1, dev)
    _require(xg.shape == x.shape, f"xg {tuple(xg.shape)} != x {tuple(x.shape)}")
    _require(invd.shape == (x.shape[0],),
             "invd must have one entry per table row")


def _edge_out(out, rows, x):
    if out is None:
        out = torch.empty((rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
    _check("out", out, (torch.float32,), 2, x.device)
    _require(out.shape == (rows, x.shape[1]),
             f"out {tuple(out.shape)} != {(rows, x.shape[1])}")
    return out


def _launch_edge(model, x, xg, nbr, deg, xi_row, invd, step, out,
                 table: np.ndarray) -> None:
    """One ``ell_edge_force`` launch over ``table`` ([E, 5] int64 entries,
    csrc/common.cuh::ell_plan), on checked operands."""
    dev = x.device
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(x.shape[1], x, xg, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_ell_edge_force(
            x.data_ptr(), xg.data_ptr(), int(xg.dtype == torch.bfloat16),
            nbr.data_ptr(), deg.data_ptr(), xi_row.data_ptr(),
            invd.data_ptr(), float(step), out.data_ptr(), table.ctypes.data,
            table.shape[0], x.shape[1], _EDGE_MODEL_IDS[model.edge_coeff],
            _stream(dev))
    _build.check(lib, "ell_edge_force", err)
    launch_counts["ell_edge_force"] += 1


def ell_edge_force(model: ForceModel, x, xg, nbr, deg, xi_row, invd, step,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked edge-force sum over one ELL bucket, gathering in the kernel.

    x [n_pad, D] f32; xg [n_pad, D] bf16 or f32 gather replica of x;
    nbr [C, K] int32 neighbour rows; deg [C] int32 valid slots per row;
    xi_row [C] int32 table row whose x and invd each bucket row uses (the
    bucket's own rows, or the owners of hub virtual rows); invd [n_pad] f32;
    step a float.  Writes into ``out`` [C, D] f32 if given; returns it.
    The kernel does not bounds-check ``nbr`` or ``xi_row``: they must index
    rows of ``x`` (``SyncLayout`` builds them so).  One launch of the
    table kernel, over a one-entry table.
    """
    _check_edge_operands(model, x, xg, invd)
    dev = x.device
    _check("nbr", nbr, (torch.int32,), 2, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    _check("xi_row", xi_row, (torch.int32,), 1, dev)
    c, k = nbr.shape
    _require(deg.shape == (c,) and xi_row.shape == (c,),
             "deg and xi_row must have one entry per bucket row")
    out = _edge_out(out, c, x)
    if dev.type == "cpu":
        out.copy_(ell_edge_force_plain(model, x, xg, nbr, deg, xi_row, invd,
                                       step))
        return out
    table = np.array([[0, 0, 0, c, k]], dtype=np.int64)
    _launch_edge(model, x, xg, nbr, deg, xi_row, invd, step, out, table)
    return out


@dataclasses.dataclass(frozen=True)
class EdgeWorkTable:
    """Several ELL buckets as one ``ell_edge_force`` launch: their index
    arrays concatenated, one entry per bucket, widest first.  Built and
    checked once by ``edge_work_table``; a launch checks only x, xg, invd
    and out."""

    nbr: torch.Tensor  # [slots] int32: every entry's [rows, width] ids, flat
    deg: torch.Tensor  # [rows] int32 valid slots per row
    xi_row: torch.Tensor  # [rows] int32 table row whose x and invd a row uses
    # [E, 5] int64 per entry, in launch order: row_begin, nbr_begin,
    # out_begin, rows, width (csrc/common.cuh::ell_plan)
    entries: np.ndarray
    n_pad: int  # rows of x that xi_row and nbr index
    out_rows: int  # output rows; each is written by exactly one table row

    def parts(self) -> list:
        """``(nbr [rows, width], deg, xi_row, out_begin)`` per entry, in
        launch order: views of the flat arrays."""
        out = []
        for rb, nb, ob, rows, width in self.entries.tolist():
            out.append((self.nbr[nb: nb + rows * width].view(rows, width),
                        self.deg[rb: rb + rows], self.xi_row[rb: rb + rows],
                        ob))
        return out


def edge_work_table(parts, n_pad: int, out_rows: int) -> EdgeWorkTable:
    """The work table of ``parts``, each ``(nbr [C, K] int32, deg [C] int32,
    xi_row [C] int32, out_begin)``: its C rows write output rows
    ``[out_begin, out_begin + C)``.  Entries run widest first (a stable
    sort), so the longest rows start first.  Checks, once: types,
    shapes, one device; deg in [0, K]; xi_row and the real slots' ids in
    [0, n_pad); the parts' output rows tile [0, out_rows) exactly.  Parts
    with no rows are dropped."""
    parts = [p for p in parts if p[0].shape[0] > 0]
    _require(0 < len(parts) <= _MAX_ENTRIES,
             f"a work table holds 1 to {_MAX_ENTRIES} non-empty parts, got "
             f"{len(parts)}")
    dev = parts[0][0].device
    for nbr, deg, xi_row, _ in parts:
        _check("nbr", nbr, (torch.int32,), 2, dev)
        _check("deg", deg, (torch.int32,), 1, dev)
        _check("xi_row", xi_row, (torch.int32,), 1, dev)
        c, k = nbr.shape
        _require(deg.shape == (c,) and xi_row.shape == (c,),
                 "deg and xi_row must have one entry per row of nbr")
        _require(bool(((deg >= 0) & (deg <= k)).all()),
                 "deg must lie in [0, width]")
        _require(bool(((xi_row >= 0) & (xi_row < n_pad)).all()),
                 "xi_row must index rows of x")
        real = nbr[_slot_mask(nbr, deg)[:, :, 0]]
        _require(bool(((real >= 0) & (real < n_pad)).all()),
                 "the real slots of nbr must index rows of x")
    covered = 0
    for lo, hi in sorted((ob, ob + p[0].shape[0]) for *p, ob in parts):
        _require(lo == covered and hi <= out_rows,
                 f"the parts' output rows must tile [0, {out_rows}) exactly")
        covered = hi
    _require(covered == out_rows,
             f"the parts' output rows must tile [0, {out_rows}) exactly")

    parts = sorted(parts, key=lambda p: -p[0].shape[1])
    entries, row, slot = [], 0, 0
    for nbr, _, _, ob in parts:
        c, k = nbr.shape
        entries.append((row, slot, ob, c, k))
        row, slot = row + c, slot + c * k
    return EdgeWorkTable(
        nbr=torch.cat([p[0].reshape(-1) for p in parts]),
        deg=torch.cat([p[1] for p in parts]),
        xi_row=torch.cat([p[2] for p in parts]),
        entries=np.ascontiguousarray(entries, dtype=np.int64),
        n_pad=n_pad, out_rows=out_rows)


def ell_edge_force_table_plain(model: ForceModel, x, xg,
                               table: EdgeWorkTable, invd,
                               step) -> torch.Tensor:
    """[out_rows, D]: ``ell_edge_force_plain`` of each entry, in its output
    rows."""
    out = torch.empty((table.out_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for nbr, deg, xi_row, ob in table.parts():
        out[ob: ob + nbr.shape[0]] = ell_edge_force_plain(
            model, x, xg, nbr, deg, xi_row, invd, step)
    return out


def ell_edge_force_table(model: ForceModel, x, xg, table: EdgeWorkTable,
                         invd, step,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ell_edge_force`` over every entry of ``table`` in one launch.

    x [table.n_pad, D] f32, xg its bf16 or f32 gather replica, invd
    [table.n_pad] f32, step a float.  Writes into ``out`` [table.out_rows,
    D] f32 if given (every row); returns it.
    """
    _check_edge_operands(model, x, xg, invd)
    _require(x.shape[0] == table.n_pad,
             f"x has {x.shape[0]} rows, the table indexes {table.n_pad}")
    _require(table.nbr.device == x.device,
             f"table on {table.nbr.device}, x on {x.device}")
    out = _edge_out(out, table.out_rows, x)
    if x.device.type == "cpu":
        out.copy_(ell_edge_force_table_plain(model, x, xg, table, invd, step))
        return out
    _launch_edge(model, x, xg, table.nbr, table.deg, table.xi_row, invd, step,
                 out, table.entries)
    return out


# -- repulsion from group-shared samples ---------------------------------------


def grouped_rep_force_terms(model: ForceModel, group: int, xi, sg,
                            step) -> torch.Tensor:
    """[C, ns, D] sample_force(xi[r], sg[r // group, s]) per sample, in f32."""
    gid = torch.arange(xi.shape[0], device=xi.device) // group
    s = sg[gid].float()  # [C, ns, D]
    return model.sample_force(xi[:, None, :], s, step)


def grouped_rep_force_plain(model: ForceModel, group: int, xi, sg,
                            step) -> torch.Tensor:
    """out[r] = Σ_s sample_force(xi[r], sg[r // group, s]): the group
    expand, the model's sample force in f32 and a sum over ns."""
    return grouped_rep_force_terms(model, group, xi, sg, step).sum(dim=1)


def grouped_rep_force(model: ForceModel, group: int, xi, sg,
                      step) -> torch.Tensor:
    """Grouped-negative repulsion with the group expand kept on chip.

    xi [C, D] f32, row r in group r // group; sg [ng, ns, D] bf16 or f32
    per-group sample rows, ng ≥ ceil(C / group); step a float.
    Returns [C, D] f32.
    """
    _require(model.sample_force in _SAMPLE_MODEL_IDS,
             f"{model.name} has no grouped sample force")
    _require(isinstance(group, int) and group > 0, f"bad group {group!r}")
    dev = xi.device
    _check("xi", xi, (torch.float32,), 2, dev)
    _check("sg", sg, _GATHER_DTYPES, 3, dev)
    c, dim = xi.shape
    ng, ns, sdim = sg.shape
    _require(sdim == dim, f"sg dim {sdim} != xi dim {dim}")
    _require(ng * group >= c, f"{ng} groups of {group} cover fewer than {c} rows")
    if dev.type == "cpu":
        return grouped_rep_force_plain(model, group, xi, sg, step)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(ns > 0 and ns * dim * 4 <= _MAX_SAMPLE_SMEM,
             f"ns={ns} samples of dim {dim} do not fit a block's shared memory")
    out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check_cuda_operands(dim, xi, sg, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_grouped_rep_force(
            xi.data_ptr(), sg.data_ptr(), int(sg.dtype == torch.bfloat16),
            float(step), out.data_ptr(), c, group, ns, dim,
            _SAMPLE_MODEL_IDS[model.sample_force], _stream(dev))
    _build.check(lib, "grouped_rep_force", err)
    launch_counts["grouped_rep_force"] += 1
    return out


# -- repulsion from per-row samples ------------------------------------------


def ell_sample_force_terms(model: ForceModel, x, xg, idx, deg, xi_row,
                           step) -> torch.Tensor:
    """[C, K, D] sample_force(x[i], xg[idx[r, k]]) per slot, i = xi_row[r],
    in f32 and exactly 0 in the padded slots k ≥ deg[r]."""
    xi = x[xi_row.long()]
    s = xg[idx.long()].float()  # [C, K, D]
    return model.sample_force(xi[:, None, :], s, step,
                              mask=_slot_mask(idx, deg))


def ell_sample_force_plain(model: ForceModel, x, xg, idx, deg, xi_row, step,
                           out: Optional[torch.Tensor] = None,
                           accumulate: bool = False) -> torch.Tensor:
    """Σ_{k<deg[r]} sample_force(x[i], xg[idx[r, k]]), i = xi_row[r]: the
    gather, the model's sample force in f32 and a masked sum over K.
    Returns it, or writes it into ``out`` (with ``accumulate``, adds it:
    ``out.add_(sum)``) and returns ``out``."""
    s = ell_sample_force_terms(model, x, xg, idx, deg, xi_row, step).sum(dim=1)
    if out is None:
        _require(not accumulate, "accumulate needs out")
        return s
    return out.add_(s) if accumulate else out.copy_(s)


def ell_sample_force(model: ForceModel, x, xg, idx, deg, xi_row, step,
                     out: Optional[torch.Tensor] = None,
                     accumulate: bool = False) -> torch.Tensor:
    """Masked sample-force sum over per-row samples, gathering in the kernel.

    x [n_pad, D] f32; xg [n_pad, D] bf16 or f32 gather replica of x;
    idx [C, K] int32 sample rows; deg [C] int32 valid samples per row;
    xi_row [C] int32 table row whose x each row uses; step a float.
    Writes into ``out`` [C, D] f32 if given, or with ``accumulate`` adds
    into it (one f32 add per element, as ``out.add_(sum)`` makes); returns
    ``out``.  The kernel does not bounds-check ``idx`` or ``xi_row``: they
    must index rows of ``x``.
    """
    _require(model.sample_force in _SAMPLE_MODEL_IDS,
             f"{model.name} has no sample force kernel")
    _require(out is not None or not accumulate, "accumulate needs out")
    dev = x.device
    _check("x", x, (torch.float32,), 2, dev)
    _check("xg", xg, _GATHER_DTYPES, 2, dev)
    _check("idx", idx, (torch.int32,), 2, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    _check("xi_row", xi_row, (torch.int32,), 1, dev)
    dim = x.shape[1]
    c, k = idx.shape
    _require(xg.shape == x.shape, f"xg {tuple(xg.shape)} != x {tuple(x.shape)}")
    _require(deg.shape == (c,) and xi_row.shape == (c,),
             "deg and xi_row must have one entry per row of idx")
    if out is None:
        out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check("out", out, (torch.float32,), 2, dev)
    _require(out.shape == (c, dim), f"out {tuple(out.shape)} != {(c, dim)}")
    if dev.type == "cpu":
        return ell_sample_force_plain(model, x, xg, idx, deg, xi_row, step,
                                      out=out, accumulate=accumulate)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(dim, x, xg, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_ell_sample_force(
            x.data_ptr(), xg.data_ptr(), int(xg.dtype == torch.bfloat16),
            idx.data_ptr(), deg.data_ptr(), xi_row.data_ptr(), float(step),
            out.data_ptr(), int(accumulate), c, k, dim,
            _SAMPLE_MODEL_IDS[model.sample_force], _stream(dev))
    _build.check(lib, "ell_sample_force", err)
    launch_counts["ell_sample_force"] += 1
    return out
